"""Batched QR of small matrices on the card (PyTorch counterpart of
``odecheckpts_tpu.pallas_kernels``).

``batched_qr_r`` runs the hand-written kernel ``csrc/batched_qr.cu`` (K9,
``kernels.batched_qr_r``), one matrix per thread on the lanes-last layout;
``batched_qr_r_reference`` is ``linalg.qr_r`` over the batch, which the
kernel is gated against.  No solve path calls either: as in the reference,
this is the standalone kernel of the (2n, n) QR stacks.
"""

from __future__ import annotations

from . import kernels, linalg


def batched_qr_r(x):
    """R factors of a batch of small matrices: ``x`` (B, m, n) float32 on a
    CUDA device -> (B, min(m, n), n), matching ``batched_qr_r_reference`` up
    to roundoff.  Raises where the kernel cannot run (no card, a shape it is
    not built for); ``kernels.batched_qr_r_plain`` is its plain version."""
    if x.device.type != "cuda":
        raise RuntimeError(
            f"batched_qr_r runs the CUDA kernel and takes CUDA tensors, got {x.device} "
            "(the plain version is kernels.batched_qr_r_plain)"
        )
    return kernels.batched_qr_r(x)


def batched_qr_r_reference(x):
    """``linalg.qr_r`` over the batch (power-of-two scaled Householder)."""
    return linalg.qr_r(x)
