"""Preconditioned integrated-Wiener-process ("IBM") prior discretization
(PyTorch counterpart of ``odecheckpts_tpu.prior``).

In Taylor coordinates with the step-size preconditioner
``P(dt) = diag(p_i)``, ``p_i = sqrt(dt) dt^(nu-i) / (nu-i)!``, the transition
is the dt-independent pair ``A_ij = binom(nu-i, j-i)`` and
``chol(Qbar)``, ``Qbar_ij = 1/(2nu+1-i-j)``.  Both are computed once per nu
in float64 on the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import rounded


@functools.lru_cache(maxsize=None)
def _ibm_constants_f64(num_derivatives: int):
    nu = num_derivatives
    n = nu + 1
    i = np.arange(n)
    a = np.zeros((n, n))
    for row in range(n):
        for col in range(row, n):
            a[row, col] = math.comb(nu - row, col - row)
    q = 1.0 / (2 * nu + 1 - i[:, None] - i[None, :])
    l_q = np.linalg.cholesky(q)
    factorials = np.array([math.factorial(nu - k) for k in range(n)], dtype=float)
    return a, l_q, factorials


def system_matrices(num_derivatives: int, *, dtype, device=None):
    """dt-independent (A, chol(Qbar)) of the preconditioned IBM transition."""
    a, l_q, _ = _ibm_constants_f64(num_derivatives)
    return (
        torch.as_tensor(a, dtype=dtype, device=device),
        torch.as_tensor(l_q, dtype=dtype, device=device),
    )


def _powers(dt, num_derivatives):
    """[1, dt, dt^2, ..., dt^nu] stacked on a new last axis."""
    pw = [torch.ones_like(dt)]
    for _ in range(num_derivatives):
        pw.append(pw[-1] * dt)
    return torch.stack(pw, dim=-1)


def phi_direct(dt, num_derivatives: int):
    """The unpreconditioned transition ``Phi(dt)_ij = dt^(j-i)/(j-i)!``.

    ``dt``: tensor of any batch shape; returns (..., n, n).  Used for
    interpolation, where the preconditioned reversal would amplify roundoff.
    """
    nu = num_derivatives
    n = nu + 1
    i = np.arange(n)
    k = i[None, :] - i[:, None]
    inv_fact = np.zeros((n, n))
    for r in range(n):
        for c in range(r, n):
            inv_fact[r, c] = 1.0 / math.factorial(c - r)
    coeff = torch.as_tensor(inv_fact, dtype=dt.dtype, device=dt.device)
    idx = torch.as_tensor(np.clip(k, 0, nu), device=dt.device)
    return coeff * _powers(dt, nu)[..., idx]


def preconditioner(dt, num_derivatives: int):
    """Scaling vectors ``(p, 1/p)``, each (..., n), for a tensor ``dt``."""
    _, _, factorials = _ibm_constants_f64(num_derivatives)
    powers = torch.flip(_powers(dt, num_derivatives), dims=(-1,))
    scales = torch.as_tensor(1.0 / factorials, dtype=dt.dtype, device=dt.device)
    p = rounded.sqrt(dt)[..., None] * powers * scales
    return p, 1.0 / p
