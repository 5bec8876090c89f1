"""Port differential tests: the df32 pair arithmetic (``odecheckpts_torch.df32``)
against the JAX reference's ``odecheckpts_tpu.df32``.

Inputs are 4,096 values per operand from a numpy seed, spread over 24
decades of magnitude and both signs, as f32 pairs and as f64 pairs.
Tolerances and why:

* Every op against JAX run eagerly (op by op, so no multiply-add is
  contracted): equal bit for bit.  Both round every f32 / f64 operation on
  its own, in the same order, and Python scalars are rounded to the pair's
  dtype first on both sides.
* ``two_sum`` and ``two_prod`` are error-free: on f32 inputs whose exact sum
  and product fit a double (magnitudes within 2^26 of each other for the
  sum), hi + lo in f64 equals numpy's f64 result exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import df32 as jdf
from odecheckpts_torch import df32 as tdf

NP = {"f32": np.float32, "f64": np.float64}
N = 4096


def _values(seed, dtype, decades=12):
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-decades, decades, N)
    return (rng.choice([-1.0, 1.0], N) * mag * rng.uniform(1.0, 2.0, N)).astype(dtype)


def _pair(seed, dtype):
    """(hi, lo) with |lo| <= ulp(hi)/2, from a numpy seed."""
    hi = _values(seed, NP[dtype])
    rel = np.random.default_rng(seed + 100).uniform(-0.5, 0.5, N)
    lo = (hi.astype(np.float64) * rel * np.finfo(NP[dtype]).eps).astype(NP[dtype])
    return hi, lo


def _args(op, dtype):
    """numpy arguments of ``op``: pairs as tuples, plain operands as arrays,
    and one Python scalar where the op takes one."""
    x, y = _pair(1, dtype), _pair(2, dtype)
    a, b = _values(3, NP[dtype]), _values(4, NP[dtype])
    return {
        "two_sum": (a, b),
        "fast_two_sum": (np.where(np.abs(a) >= np.abs(b), a, b),
                         np.where(np.abs(a) >= np.abs(b), b, a)),
        "split": (a,),
        "two_prod": (a, b),
        "wrap": (a,),
        "collapse": (x,),
        "renorm": x,
        "add": (x, y),
        "add1": (x, b),
        "sub": (x, y),
        "sub1": (x, b),
        "neg": (x,),
        "mul": (x, y),
        "mul1": (x, b),
        "div1": (x, b),
        "mul1_scalar": (x, 1.25),
        "div1_scalar": (x, 3.0),
    }[op]


def _to(lib, tree):
    if isinstance(tree, tuple):
        return tuple(_to(lib, t) for t in tree)
    if isinstance(tree, float):
        return tree
    return jnp.asarray(tree) if lib == "jax" else torch.tensor(tree)


def _flat(tree):
    if isinstance(tree, tuple):
        return [v for t in tree for v in _flat(t)]
    return [np.asarray(tree)]


OPS = ["two_sum", "fast_two_sum", "split", "two_prod", "wrap", "collapse", "renorm",
       "add", "add1", "sub", "sub1", "neg", "mul", "mul1", "div1", "mul1_scalar",
       "div1_scalar"]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("op", OPS)
def test_op_matches_jax_bit_for_bit(op, dtype):
    name = op.removesuffix("_scalar")
    args = _args(op, dtype)
    want = _flat(getattr(jdf, name)(*_to("jax", args)))
    got = _flat(getattr(tdf, name)(*_to("torch", args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == NP[dtype]
        np.testing.assert_array_equal(g, w)


def test_all_reference_functions_are_ported():
    assert sorted(tdf.__all__) == sorted(jdf.__all__)


def test_two_sum_and_two_prod_are_error_free():
    a, b = _values(5, np.float32, decades=3), _values(6, np.float32, decades=3)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    s, e = tdf.two_sum(torch.tensor(a), torch.tensor(b))
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(), a64 + b64)
    p, e = tdf.two_prod(torch.tensor(a), torch.tensor(b))
    np.testing.assert_array_equal(p.double().numpy() + e.double().numpy(), a64 * b64)
    assert int(np.sum(s.numpy() != (a + b))) == 0  # the hi word is the f32 result
    assert int(np.sum(e.numpy() != 0)) > N // 2  # and the lo word carries the rest


def test_df32_pairs_carry_the_time_axis():
    """The compensated time axis the df32 step relies on: 5,000 additions of
    an f32 step stay exact to ~2^-45 (plain f32 drifts ~1e-4)."""
    t = tdf.wrap(torch.zeros(1))
    dt = torch.tensor([0.0123], dtype=torch.float32)
    for _ in range(5000):
        t = tdf.add1(t, dt)
    want = 5000 * float(np.float64(np.float32(0.0123)))
    assert abs(float(t[0].double() + t[1].double()) - want) < 1e-8
