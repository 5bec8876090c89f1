"""Compensated double-float ("df32") arithmetic on pairs of tensors (PyTorch
counterpart of ``odecheckpts_tpu/df32.py:37-138``).

A pair ``(hi, lo)`` with ``|lo| <= ulp(hi)/2`` carries ~2^-48 relative
precision in f32 and ~2^-104 ("double-double") in f64.  The error-free
transformations hold only if every operation rounds on its own: PyTorch's
eager elementwise ops do, and the CUDA kernels that use the same arithmetic
(``csrc/step_hi.cu``) are built with ``-fmad=false``.

A Python-scalar operand of ``mul1`` or ``div1`` becomes a tensor of the
pair's dtype first: PyTorch's CUDA division by a Python scalar multiplies by
its reciprocal, which rounds differently from a true division.
"""

from __future__ import annotations

import torch

__all__ = [
    "two_sum", "fast_two_sum", "split", "two_prod",
    "wrap", "collapse", "renorm",
    "add", "add1", "sub", "sub1", "neg",
    "mul", "mul1", "div1",
]

# 2^ceil(p/2) + 1: Dekker's split constant (f32: p = 24; f64: p = 53)
_SPLIT = {torch.float32: 4097.0, torch.float64: 134217729.0}


def two_sum(a, b):
    """Error-free sum (Knuth/Moller, 6 flops): a + b = s + err exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Error-free sum (Dekker, 3 flops); requires |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def split(a):
    """Dekker split: a = hi + lo with hi, lo each holding half the mantissa."""
    c = _SPLIT[a.dtype] * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product (Dekker, 17 flops without FMA): a*b = p + err."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def wrap(a):
    """Lift a plain tensor to an exact pair."""
    return a, torch.zeros_like(a)


def collapse(x):
    """Round a pair to the nearest plain float."""
    return x[0] + x[1]


def renorm(hi, lo):
    """Re-establish the non-overlap invariant |lo| <= ulp(hi)/2."""
    return fast_two_sum(hi, lo)


def add(x, y):
    """Pair + pair ("sloppy" double add, ~2 ulp^2 error; 11 flops)."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return fast_two_sum(s, e)


def add1(x, b):
    """Pair + plain tensor (10 flops)."""
    s, e = two_sum(x[0], b)
    e = e + x[1]
    return fast_two_sum(s, e)


def neg(x):
    return -x[0], -x[1]


def sub(x, y):
    return add(x, neg(y))


def sub1(x, b):
    return add1(x, -b)


def _as_tensor(b, like):
    if isinstance(b, torch.Tensor):
        return b
    return torch.full_like(like, float(b))


def mul(x, y):
    """Pair * pair (~2 ulp^2 error)."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return fast_two_sum(p, e)


def mul1(x, b):
    """Pair * plain float (a Python scalar becomes a tensor of the pair's
    dtype)."""
    b = _as_tensor(b, x[0])
    p, e = two_prod(x[0], b)
    e = e + x[1] * b
    return fast_two_sum(p, e)


def div1(x, b):
    """Pair / plain float (long division, one Newton correction)."""
    b = _as_tensor(b, x[0])
    q0 = x[0] / b
    p, e = two_prod(q0, b)
    r = ((x[0] - p) - e) + x[1]
    return fast_two_sum(q0, r / b)
