"""Taylor-mode initialization of the solver state (PyTorch counterpart of
``odecheckpts_tpu.taylor``).

For a vector field of ODE order ``o``, ``u^(o) = vf(u, ..., u^(o-1))``, the
derivatives ``u^(o), ..., u^(o+num-1)`` at t0 are time derivatives of
``vf`` along the Taylor-polynomial path of the inputs:
``u^(k+o)(0) = (d/dt)^k vf(x(t))`` at ``t = 0``, with
``x_j(t) = sum_i u_j^(i) t^i / i!``.  PyTorch has no ``jet``, so each of
them is ``k`` nested forward-mode derivatives (``torch.func.jvp``) in the
scalar ``t``.  Vector fields written row-wise apply to (d, B) tensors
directly, which solves a whole ensemble in one pass.
"""

from __future__ import annotations

import torch
from torch.func import jvp


def _path(coeffs, t):
    """sum_i coeffs[i] t^i / i! in Horner form."""
    out = coeffs[-1]
    for i in range(len(coeffs) - 1, 0, -1):
        out = coeffs[i - 1] + (t / i) * out
    return out


def _nth_derivative(g, k):
    """t -> (d/dt)^k g(t) by nested forward-mode differentiation."""
    if k == 0:
        return g
    inner = _nth_derivative(g, k - 1)

    def dg(t):
        return jvp(inner, (t,), (torch.ones_like(t),))[1]

    return dg


def odejet_padded_scan(vf, inits, /, num: int):
    """Taylor coefficients ``[u, ..., u^(o-1), u^(o), ..., u^(o+num-1)]``
    in derivative scaling (the same output as the reference's padded-jet
    recursion)."""
    if num < 0:
        raise ValueError("num must be >= 0")
    inits = tuple(inits)
    order = len(inits)
    coeffs = list(inits)
    if num == 0:
        return coeffs
    coeffs.append(vf(*inits))
    t0 = torch.zeros((), dtype=inits[0].dtype, device=inits[0].device)
    for k in range(1, num):
        # input j's path uses its derivatives up to order k
        paths = [coeffs[j : j + k + 1] for j in range(order)]

        def g(t, paths=paths):
            return vf(*(_path(c, t) for c in paths))

        coeffs.append(_nth_derivative(g, k)(t0))
    return coeffs
