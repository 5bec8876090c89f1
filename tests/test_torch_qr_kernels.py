"""The standalone kernels K9 (batched QR) and K10 / K11 (QR layout
microbenchmark): their plain versions against the JAX reference's Pallas
kernels in interpret mode, on the same numpy inputs, in float32.

Tolerances are the reference's own gates: K9 against ``pallas_kernels
.batched_qr_r(interpret=True)`` and against ``linalg.qr_r`` at atol 2e-5
(Grams 2e-4, ``tests/test_pallas.py``); K10 and K11 against
``qr_packing_bench._bench_kernel(..., interpret=True)`` (the module is loaded
by path: it is an experiment script, not a package) at rtol 2e-4, atol 2e-5,
the gate its ``main`` holds the two variants to.  The interpreted kernels sum
in another order than the plain versions, hence no bit-for-bit claim here;
the CUDA kernels are held bit for bit against the plain versions on the card.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import pallas_kernels
from odecheckpts_torch import batched_qr, kernels, qr_packing
from odecheckpts_torch.batched import _qr_r_cols

_BENCH = Path(__file__).resolve().parents[1] / "experiments/6_tpu_batched_sweep/qr_packing_bench.py"


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("qr_packing_bench", _BENCH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shape", [(130, 10, 5), (128, 6, 6), (64, 4, 2)])
def test_batched_qr_plain_matches_the_pallas_kernel_and_the_reference(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    r_pal = np.asarray(pallas_kernels.batched_qr_r(jnp.asarray(x), interpret=True))
    r_plain = kernels.batched_qr_r(torch.tensor(x))  # CPU tensors: the plain version
    assert r_plain.dtype == torch.float32 and tuple(r_plain.shape) == r_pal.shape
    np.testing.assert_allclose(r_plain.numpy(), r_pal, atol=2e-5)
    r_ref = batched_qr.batched_qr_r_reference(torch.tensor(x)).numpy()
    np.testing.assert_allclose(r_plain.numpy(), r_ref, atol=2e-5)
    np.testing.assert_allclose(r_ref, np.asarray(pallas_kernels.batched_qr_r_reference(
        jnp.asarray(x))), atol=2e-5)
    gram_x = np.einsum("bij,bik->bjk", x, x)
    gram_r = np.einsum("bij,bik->bjk", r_plain.numpy(), r_plain.numpy())
    np.testing.assert_allclose(gram_r, gram_x, atol=2e-4)
    k = min(shape[1:])
    assert np.all(np.diagonal(r_plain.numpy(), axis1=1, axis2=2) >= 0)
    assert np.max(np.abs(np.tril(r_plain.numpy()[:, :, :k], -1))) < 2e-5


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("variant", ["cols", "masked"])
def test_qr_packing_plain_matches_the_pallas_bench_kernel(bench, variant, iters):
    m = n = 10
    x = np.random.default_rng(1).standard_normal((m, n, 8)).astype(np.float32)
    want = np.asarray(bench._bench_kernel(variant, m, n, 8, iters, interpret=True)(jnp.asarray(x)))
    got = qr_packing.VARIANTS[variant](torch.tensor(x), iters)  # CPU: the plain version
    assert got.shape == (m, n, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_the_two_variants_agree_on_the_upper_triangle_and_with_the_column_list_qr():
    m = n = 10
    x = torch.tensor(np.random.default_rng(2).standard_normal((m, n, 8)).astype(np.float32))
    r_cols = kernels.qr_packing_cols_plain(x, 1)
    r_mask = kernels.qr_packing_masked_plain(x, 1)
    tri_c = np.triu(np.moveaxis(r_cols.numpy(), -1, 0))
    tri_m = np.triu(np.moveaxis(r_mask.numpy(), -1, 0))
    np.testing.assert_allclose(tri_m, tri_c, rtol=2e-4, atol=2e-5)
    direct = _qr_r_cols(x.transpose(0, 1), m, n, torch.finfo(torch.float32).tiny).transpose(0, 1)
    torch.testing.assert_close(r_cols, direct, rtol=0, atol=0)
    torch.testing.assert_close(qr_packing.qr_r_masked(x, m, n), r_mask, rtol=0, atol=0)
    # the k-th QR runs on the input plus 1e-6 k: three iterations differ from one
    assert not torch.equal(kernels.qr_packing_cols_plain(x, 3), r_cols)


def test_the_launchers_raise_without_a_card_and_the_wrappers_count_no_launch():
    x = torch.zeros((4, 10, 5))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        batched_qr.batched_qr_r(x)
    for variant in ("cols", "masked"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            qr_packing.bench_kernel(variant, 10, 10, 1)(torch.zeros((10, 10, 8)))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        qr_packing.main(batch=8, iters=1, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        qr_packing.bench_kernel("packed", 10, 10, 1)
    with pytest.raises(ValueError, match="built for"):
        qr_packing.bench_kernel("cols", 7, 7, 1)
    before = dict(kernels.LAUNCHES)
    kernels.batched_qr_r(x)
    kernels.qr_packing_cols(torch.zeros((6, 6, 4)), 2)
    kernels.qr_packing_masked(torch.zeros((6, 6, 4)), 2)
    assert kernels.LAUNCHES == before
    for fn, arg in ((kernels.batched_qr_r, x.to("meta")),
                    (lambda t: kernels.qr_packing_cols(t, 1), torch.zeros((6, 6, 4), device="meta")),
                    (lambda t: kernels.qr_packing_masked(t, 1),
                     torch.zeros((6, 6, 4), device="meta"))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(arg)
    with pytest.raises(ValueError, match=r"\(B, m, n\)"):
        kernels.batched_qr_r(torch.zeros((4, 4)))


def test_parse_ptxas_reads_the_new_kernels():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_111pit_combineIfLi4ELi3EEEvNS_11CombineArgsIT_EEl' for 'sm_90a'",
        "    120 bytes stack frame, 96 bytes spill stores, 104 bytes spill loads",
        "ptxas info    : Used 255 registers, used 0 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_111pit_combineIdLi5ELi1EEEvNS_11CombineArgsIT_EEl' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 200 registers, used 0 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_110batched_qrILi10ELi5EEEvPKfPfl' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, used 0 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117qr_packing_maskedILi10ELi10EEEvPKfPfil' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 0 barriers",
    ])
    got = kernels.parse_ptxas(log)
    assert got["pit_combine"]["f32/4/3"] == {
        "stack": 120, "spill_stores": 96, "spill_loads": 104, "registers": 255}
    assert got["pit_combine"]["f64/5/1"]["registers"] == 200
    assert got["batched_qr_r"]["10/5"]["registers"] == 80
    assert got["qr_packing_masked"]["10/10"]["registers"] == 168
