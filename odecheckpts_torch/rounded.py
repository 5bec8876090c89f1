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
f64 and round once (for ``sqrt`` that is the IEEE root, as on the card and
in the kernels; f64 carries more than twice f32's bits, so the double
rounding is exact), and form products and triangular solves as explicit
sums in a fixed order, every operation rounded on its own.  On the card
they are PyTorch's own calls.
"""

from __future__ import annotations

import torch


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
    """``x ** exponent`` for a Python-float exponent."""
    return _widen(lambda v: torch.pow(v, exponent), x)


def matmul(a, b):
    """``a @ b`` for (..., n, k) and (..., k, m) (batch axes broadcast); on
    the CPU summed over k in order, each product and sum rounded once."""
    if a.device.type != "cpu":
        return a @ b
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for j in range(1, a.shape[-1]):
        out = out + a[..., :, j : j + 1] * b[..., j : j + 1, :]
    return out


def solve_triangular_lower(l, b):
    """``X`` with ``L X = B`` for lower-triangular (..., n, n) ``L`` and
    (..., n, m) ``B``; on the CPU by forward substitution in row order."""
    if l.device.type != "cpu":
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
    (..., n, m) ``B``; on the CPU by back substitution in row order."""
    if r.device.type != "cpu":
        return torch.linalg.solve_triangular(r, b, upper=True)
    n = r.shape[-1]
    rows = [None] * n
    for i in reversed(range(n)):
        acc = b[..., i, :]
        for j in range(i + 1, n):
            acc = acc - r[..., i, j, None] * rows[j]
        rows[i] = acc / r[..., i, i, None]
    return torch.stack(rows, dim=-2)
