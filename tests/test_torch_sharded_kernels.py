"""Card-only tests of K1, K2 and K8 under sharding: two gloo ranks that
share card 0 (NCCL takes one rank a card; the collectives stage CUDA
tensors through the host), one spawn for the module
(``tests/torch_parallel_worker.py``, suite "cuda").  Imports no JAX:

    python -m pytest --noconftest tests/test_torch_sharded_kernels.py -m cuda

Held bit for bit: the gathered K1 and K2 solves of 4,096 lanes against the
unsharded launches on the same card; the time-sharded fixed-grid solve with
K8 (``combine_engine="cuda"``) against the same sharded solve on K8's plain
version ("ll"), with the divergence gate off, as ``chip_smoke.py`` phase 22
holds the unsharded one.  Against the unsharded K8 solve the time-sharded
one combines in another order: f64 within rtol 1e-10 (values) and 1e-8
(stds), the reference's bounds."""

import numpy as np
import pytest
import torch
import torch_parallel_worker as worker

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ranks(card, tmp_path_factory):
    handle = worker.spawn("cuda", 2, tmp_path_factory.mktemp("cuda"))
    got = []

    def result():
        if not got:
            got.append(worker.collect(handle, timeout=900))
        return got[0]

    yield result
    result()


def _every_rank(out, key):
    for rank in out[1:]:
        np.testing.assert_array_equal(rank[key], out[0][key])
    return out[0][key]


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_sharded_solve_equals_the_unsharded_launches(card, ranks, kernel):
    from odecheckpts_torch import batched_hi

    u0s, tols, tols_hi = worker.cuda_inputs(card)
    if kernel == "k1":
        u_s, _uf, n = worker.cuda_fused()(u0s, tols)
    else:
        us, _uf, n = worker.cuda_hi()(u0s, tols_hi)
        u_s = batched_hi.combine64(us)
    out = ranks()
    np.testing.assert_array_equal(_every_rank(out, f"{kernel}_u"), u_s.cpu().numpy())
    np.testing.assert_array_equal(_every_rank(out, f"{kernel}_n"), n.cpu().numpy())
    assert all(int(r[f"{kernel}_launches"]) == len(worker.RIGID_SAVE_AT if kernel == "k1"
                                                   else worker.HI_SAVE_AT) - 1 for r in out)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_time_sharded_k8_equals_its_plain_version_and_the_unsharded_solve(card, ranks, dtype):
    out = ranks()
    for key in ("u", "u_std"):
        np.testing.assert_array_equal(_every_rank(out, f"pit_{dtype}_{key}"),
                                      _every_rank(out, f"pit_{dtype}_{key}_ll"))
    assert all(int(r[f"pit_{dtype}_launches"]) > 0 for r in out)
    if dtype == "f64":
        u, u_std = worker.cuda_pit(torch.float64, card, "cuda")
        np.testing.assert_allclose(out[0]["pit_f64_u"], u.cpu().numpy(), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(out[0]["pit_f64_u_std"], u_std.cpu().numpy(), rtol=1e-8,
                                   atol=1e-12)
