"""Port differential tests: odecheckpts_torch.linalg against odecheckpts_tpu.linalg.

Same numpy inputs (fixed seed) through both packages.  Tolerances: f64
rtol 1e-12, f32 rtol 1e-5, each relative to the largest entry of the
reference result (entries that cancel to ~0 carry only roundoff).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import linalg as jl
from odecheckpts_torch import linalg as tl

RTOL = {np.float64: 1e-12, np.float32: 1e-5}
SHAPES = [(10, 5), (12, 12), (6, 3)]


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = RTOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.max(np.abs(want)))


def _matrix(shape, dtype, wide, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2,) + shape)  # a leading batch dimension
    if wide:
        # magnitudes spanning 1e-30..1e30: the power-of-two guard engages
        x = x * 10.0 ** rng.uniform(-30, 30, size=x.shape)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_qr_r_matches_jax(shape, wide, dtype):
    x = _matrix(shape, dtype, wide)
    want = np.asarray(jl.qr_r(jnp.asarray(x)))
    got = tl.qr_r(torch.tensor(x)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.all(np.diagonal(got, axis1=-2, axis2=-1) >= 0)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chol_from_stack_matches_jax(dtype):
    rng = np.random.default_rng(1)
    blocks = [rng.standard_normal((3, 4, 5)).astype(dtype),
              rng.standard_normal((3, 5, 5)).astype(dtype)]
    want = np.asarray(jl.chol_from_stack(*(jnp.asarray(b) for b in blocks)))
    got = tl.chol_from_stack(*(torch.tensor(b) for b in blocks)).numpy()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_revert_markov_matches_jax(dtype):
    rng = np.random.default_rng(2)
    n = 5
    l_prev = np.tril(rng.standard_normal((4, n, n))).astype(dtype)
    a = np.triu(rng.standard_normal((n, n))) + 2 * np.eye(n)
    a_l = (a @ l_prev).astype(dtype)
    l_q = (0.3 * np.tril(rng.standard_normal((4, n, n))) + np.eye(n)).astype(dtype)
    want = jl.revert_markov(jnp.asarray(a_l), jnp.asarray(l_q), jnp.asarray(l_prev))
    got = tl.revert_markov(torch.tensor(a_l), torch.tensor(l_q), torch.tensor(l_prev))
    for g, w in zip(got, want):
        _close(g.numpy(), w, dtype)
