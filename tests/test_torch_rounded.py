"""The port's host-independent arithmetic (``odecheckpts_torch/rounded.py``)
on the CPU, and the f32 solve it makes the same on every host.

PyTorch's CPU f32 ``sqrt``, ``exp`` and ``log`` come from MKL's vector math
(not correctly rounded, chosen by instruction set) and its products from
MKL's BLAS.  ``rounded`` takes the elementary functions in f64, rounded
once, and forms products and triangular solves as sums in a fixed order.
Checked here: ``sqrt`` is the IEEE root bit for bit (numpy's), ``exp`` and
``log`` are f64's rounded once, ``matmul`` and ``solve_triangular_upper``
are the in-order sums bit for bit, and the f32 rigid-body solve of 8 lanes
gives the same bits under MKL's SSE4.2, AVX2 and default code paths
(``MKL_ENABLE_INSTRUCTIONS``, in subprocesses): on this machine the same
solve with PyTorch's own calls moves its step counts by a few percent
between them.  No JAX here.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from odecheckpts_torch import batched as tb, problems as tp, rounded

ROOT = Path(__file__).resolve().parents[1]


def _f32(seed, shape, lo=-6.0, hi=6.0):
    """f32 samples with exponents spread over 10^lo .. 10^hi."""
    rng = np.random.default_rng(seed)
    return (10.0 ** rng.uniform(lo, hi, shape)).astype(np.float32)


def test_sqrt_is_the_ieee_root():
    x = np.concatenate([_f32(0, 100_000, -40, 38), np.array([0.0, 1.0, 4.0, np.inf], np.float32)])
    got = rounded.sqrt(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.sqrt(x))


@pytest.mark.parametrize("fn", ["exp", "log"])
def test_exp_and_log_round_the_f64_value_once(fn):
    x = _f32(1, 100_000, -3.0, 1.9) * np.where(np.arange(100_000) % 2, 1, -1).astype(np.float32)
    if fn == "log":
        x = np.abs(x)
    got = getattr(rounded, fn)(torch.from_numpy(x)).numpy()
    want = getattr(np, fn)(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_f64_inputs_and_their_dtype_pass_through():
    x = torch.from_numpy(_f32(2, 64).astype(np.float64))
    assert torch.equal(rounded.sqrt(x), torch.sqrt(x)) and rounded.exp(x).dtype == torch.float64


def test_matmul_sums_in_column_order():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((7, 5, 4)).astype(np.float32)
    b = rng.standard_normal((4, 3)).astype(np.float32)
    want = a[:, :, 0:1] * b[0:1, :]
    for k in range(1, 4):
        want = want + a[:, :, k : k + 1] * b[k : k + 1, :]
    got = rounded.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, a @ b, rtol=1e-5, atol=1e-5)


def test_solve_triangular_upper_substitutes_back_in_row_order():
    rng = np.random.default_rng(4)
    n = 5
    r = np.triu(rng.standard_normal((6, n, n))).astype(np.float32)
    r[:, range(n), range(n)] = (1.0 + rng.uniform(size=(6, n))).astype(np.float32)
    b = rng.standard_normal((6, n, 3)).astype(np.float32)
    rows = [None] * n
    for i in reversed(range(n)):
        acc = b[:, i, :]
        for j in range(i + 1, n):
            acc = acc - r[:, i, j, None] * rows[j]
        rows[i] = acc / r[:, i, i, None]
    got = rounded.solve_triangular_upper(torch.from_numpy(r), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, np.stack(rows, axis=-2))
    np.testing.assert_allclose(got, np.linalg.solve(r.astype(np.float64), b), rtol=1e-4,
                               atol=1e-4)


_SOLVE = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[2])
import test_torch_rounded as t
np.savez(sys.argv[1], *t.solve_f32())
"""


def solve_f32():
    """The f32 rigid-body solve of 8 perturbed lanes at rtol 1e-4 and 1e-6
    (u0 (1 + 0.05 N(0, 1)) from numpy seed 0, 5 checkpoints on (0, 10)):
    smoothed and filtered values and step counts as numpy arrays."""
    rng = np.random.default_rng(0)
    u0s = (np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((8, 3))))
    tols = np.tile([1e-4, 1e-6], 4)
    vf, _, _, params = tp.rigid_body()
    out = tb.solve_save_at_batched(
        vf, torch.tensor(u0s, dtype=torch.float32), params,
        save_at=np.linspace(0.0, 10.0, 5).astype(np.float32), dt0=0.1,
        tols=torch.tensor(tols, dtype=torch.float32), engine="cuda-loop")
    return [x.numpy() for x in out]


def test_f32_solve_is_the_same_on_every_mkl_code_path(tmp_path):
    want = solve_f32()
    for isa in ("SSE4_2", "AVX2"):
        env = dict(os.environ, MKL_ENABLE_INSTRUCTIONS=isa)
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
        dst = tmp_path / f"{isa}.npz"
        subprocess.run([sys.executable, "-c", _SOLVE, str(dst), str(ROOT / "tests")], env=env,
                       cwd=ROOT, check=True, timeout=300)
        with np.load(dst) as got:
            for i, w in enumerate(want):
                np.testing.assert_array_equal(got[f"arr_{i}"], w, err_msg=f"{isa}, output {i}")
