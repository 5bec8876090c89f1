"""Layout microbenchmark of the in-kernel Householder QR (PyTorch counterpart
of ``experiments/6_tpu_batched_sweep/qr_packing_bench.py``).

Two kernels run ``iters`` QRs of every lane's (m, n) matrix inside one launch:
the column-list form (K10, ``kernels.qr_packing_cols``: reflection j touches
columns j..n-1) and the masked full-matrix form (K11,
``kernels.qr_packing_masked``: every reflection over all n columns under a
mask).  On the TPU the question was the number of instructions against
wasted vector width; on the GPU a lane's matrix lives in one thread's
registers.  ``main`` checks the two against each other and times them; it
writes no file.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels

VARIANTS = {"cols": kernels.qr_packing_cols, "masked": kernels.qr_packing_masked}


def qr_r_masked(x, m, n):
    """Masked full-matrix Householder QR on one lanes-last (m, n, B) stack
    (the plain form of the packed variant)."""
    if tuple(x.shape[:2]) != (m, n):
        raise ValueError(f"expected an ({m}, {n}, B) stack, got {tuple(x.shape)}")
    return kernels.householder_masked_ll(x, mask_eliminated=True)


def bench_kernel(variant, m, n, iters):
    """The launcher of K10 (``variant="cols"``) or K11 (``"masked"``):
    ``run(x)`` takes a lanes-last float32 (m, n, B) tensor on a CUDA device
    and returns the last of ``iters`` QRs.  Raises where the kernel cannot
    run (no card, an (m, n) it is not built for)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got {variant!r}")
    if (m, n) not in kernels.QR_PACKING_SHAPES:
        raise ValueError(
            f"the kernels are built for (m, n) in {kernels.QR_PACKING_SHAPES}, got {(m, n)}")

    def run(x):
        if x.device.type != "cuda":
            raise RuntimeError(
                f"the {variant} launcher runs the CUDA kernel and takes CUDA tensors, got "
                f"{x.device} (the plain versions are kernels.qr_packing_*_plain)"
            )
        if tuple(x.shape[:2]) != (m, n):
            raise ValueError(f"expected an ({m}, {n}, B) stack, got {tuple(x.shape)}")
        return VARIANTS[variant](x, iters)

    return run


def _timed_ms(run, x):
    run(x)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main(batch=8192, iters=200, nu=4, *, seed=0, device="cuda"):
    """The reference's run: m = n = 2 (nu + 1), random normal matrices from
    numpy ``seed``; the two variants agree on the upper triangle after one QR
    of 8 lanes (rtol 2e-4, atol 2e-5), then each is timed (CUDA events, one
    launch after a warm-up).  Returns the result dict with one row per
    variant and ``packed_over_cols``."""
    n = 2 * (nu + 1)
    m = n
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((m, n, batch)).astype(np.float32), device=device)

    r_cols = bench_kernel("cols", m, n, 1)(x[..., :8].contiguous())
    r_mask = bench_kernel("masked", m, n, 1)(x[..., :8].contiguous())
    tri_c = np.triu(np.moveaxis(r_cols.cpu().numpy(), -1, 0))
    tri_m = np.triu(np.moveaxis(r_mask.cpu().numpy(), -1, 0))
    np.testing.assert_allclose(tri_m, tri_c, rtol=2e-4, atol=2e-5)

    rows = []
    for variant in VARIANTS:
        ms = _timed_ms(bench_kernel(variant, m, n, iters), x)
        rows.append({"variant": variant, "ms": ms,
                     "qr_per_sec_millions": batch * iters / (ms * 1e-3) / 1e6})
    return {"m": m, "n": n, "iters": iters, "batch": batch, "rows": rows,
            "packed_over_cols": rows[1]["ms"] / rows[0]["ms"]}
