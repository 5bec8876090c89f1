"""Elementary functions and products that round the same on every host.

On the CPU, PyTorch takes f32 ``sqrt``, ``exp`` and ``log`` from MKL's vector
math, which is not correctly rounded and picks its code by instruction set,
and it hands ``@``, ``einsum`` and triangular solves to MKL's BLAS, whose
order of summation and use of FMA depend on the host as well.  The port's
CPU solves then differ from host to host: the f32 step counts of a
rigid-body ensemble move by a few percent between MKL's AVX-512, AVX2 and
SSE4.2 code on one machine, and with them whether a lane's last step falls
just short of a checkpoint (``ivpsolve._interpolate_at``).

So on the CPU these functions compute f32 ``sqrt``, ``exp``, ``log`` and ``pow`` in
f64 and round once (``pow`` by libm on every element, whatever its place in
the tensor) (for ``sqrt`` that is the IEEE root, as on the card and
in the kernels; f64 carries more than twice f32's bits, so the double
rounding is exact), and form products and triangular solves as explicit
sums in a fixed order, every operation rounded on its own.  On the card
they are PyTorch's own calls, except inside ``in_order()``: there products
and triangular solves are the same in-order sums on every device.  cuBLAS
picks its algorithm for a batched float32 product by the batch's size, so
on the card a lane's product depended on how many lanes were solved with
it; inside ``in_order()`` it does not, and a solve split over ranks or
buckets gives every lane the bits of the whole solve.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# open in_order() scopes; process-wide, not per thread: the autograd engine
# runs a CUDA backward pass, and the recomputation of a checkpointed region,
# on a thread of its own, which must take the products the forward took
_IN_ORDER = {"depth": 0, "lock": threading.Lock()}


@contextlib.contextmanager
def in_order():
    """Scope in which ``matmul`` and the triangular solves sum in order on
    every device (on the CPU they always do), for every thread while it is
    open."""
    with _IN_ORDER["lock"]:
        _IN_ORDER["depth"] += 1
    try:
        yield
    finally:
        with _IN_ORDER["lock"]:
            _IN_ORDER["depth"] -= 1


def _library(x):
    """Whether ``x`` takes PyTorch's own product (the card, outside
    ``in_order()``)."""
    return x.device.type != "cpu" and _IN_ORDER["depth"] == 0


def _widen(fn, x):
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return fn(x.double()).to(torch.float32)
    return fn(x)


def sqrt(x):
    return _widen(torch.sqrt, x)


def exp(x):
    return _widen(torch.exp, x)


def log(x):
    return _widen(torch.log, x)


def pow(x, exponent):
    """``x ** exponent`` for a Python-float exponent.  On the CPU every
    element takes libm's ``pow``: PyTorch's vectorized loop gives whole
    vectors to SLEEF's ``pow`` and the rest of a tensor to libm's, which
    differ in the last bit, so an IVP lane's bits depended on its place in
    the batch and on the batch's size (a sharded solve's on the shard)."""
    if x.device.type != "cpu":
        return torch.pow(x, exponent)

    def libm_pow(v):
        buf = v.new_empty(v.shape + (2,))
        buf[..., 0] = v
        return torch.pow(buf[..., 0], exponent)  # a strided operand: the scalar loop

    return _widen(libm_pow, x)


def matmul(a, b):
    """``a @ b`` for (..., n, k) and (..., k, m) (batch axes broadcast); on
    the CPU (and in ``in_order()``) summed over k in order, each product and
    sum rounded once."""
    if _library(a):
        return a @ b
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for j in range(1, a.shape[-1]):
        out = out + a[..., :, j : j + 1] * b[..., j : j + 1, :]
    return out


def solve_triangular_lower(l, b):
    """``X`` with ``L X = B`` for lower-triangular (..., n, n) ``L`` and
    (..., n, m) ``B``; on the CPU (and in ``in_order()``) by forward
    substitution in row order."""
    if _library(l):
        return torch.linalg.solve_triangular(l, b, upper=False)
    n = l.shape[-1]
    rows = [None] * n
    for i in range(n):
        acc = b[..., i, :]
        for j in range(i):
            acc = acc - l[..., i, j, None] * rows[j]
        rows[i] = acc / l[..., i, i, None]
    return torch.stack(rows, dim=-2)


def solve_triangular_upper(r, b):
    """``X`` with ``R X = B`` for upper-triangular (..., n, n) ``R`` and
    (..., n, m) ``B``; on the CPU (and in ``in_order()``) by back
    substitution in row order."""
    if _library(r):
        return torch.linalg.solve_triangular(r, b, upper=True)
    n = r.shape[-1]
    rows = [None] * n
    for i in reversed(range(n)):
        acc = b[..., i, :]
        for j in range(i + 1, n):
            acc = acc - r[..., i, j, None] * rows[j]
        rows[i] = acc / r[..., i, i, None]
    return torch.stack(rows, dim=-2)
