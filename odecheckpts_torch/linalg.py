"""QR-only square-root linear algebra (PyTorch counterpart of
``odecheckpts_tpu.linalg``).

Covariances are never formed: every update acts on right factors ``R`` with
``Sigma = R^T R`` through one Householder QR.  All functions broadcast over
leading batch dimensions.  The Householder elimination is one Python loop
over the (few) columns; its arithmetic is the reference's, including the
exact power-of-two rescaling and the sign normalization of diag(R).
"""

from __future__ import annotations

import numpy as np
import torch

from . import rounded


def _finfo_maxexp(dtype):
    return np.finfo(torch.empty((), dtype=dtype).numpy().dtype).maxexp


def _sign_safe(x):
    """sign(x) that maps 0 -> 1 (keeps Householder reflections well-defined)."""
    one = torch.ones_like(x)
    return torch.where(x >= 0, one, -one)


def _scaled_col_stats(colm, is_j, eps):
    """Column norm stats in per-column power-of-two scaled coordinates.

    ``colm``: (..., m) masked column.  Returns ``(cs, norm2, norm, head)``
    with ``cs = colm / 2^e`` for ``e = floor(log2(max|colm|))``.  The scale
    is a pure exponent shift, so it is exact: it only keeps the squares of
    factors with a wide dynamic range inside the floating-point range.
    """
    cmax = torch.amax(torch.abs(colm), dim=-1, keepdim=True)
    cok = torch.isfinite(cmax) & (cmax > 0)
    one = torch.ones_like(cmax)
    ce = torch.exp2(torch.floor(torch.log2(torch.where(cok, cmax, one))))
    ce = torch.where(cok, ce, one)
    cs = colm / ce
    norm2 = torch.sum(cs * cs, dim=-1, keepdim=True)
    norm = rounded.sqrt(norm2 + eps)
    head = torch.sum(cs * is_j, dim=-1, keepdim=True)
    return cs, norm2, norm, head


def _qr_r_householder(x):
    """R factor of QR via masked Householder reflections, one per column.

    ``x``: (..., m, n).  Returns (..., min(m, n), n) upper-triangular with
    ``R^T R = x^T x``.  The reflector is the j-th column masked to rows >= j
    and is applied to the full matrix (eliminated columns stay untouched).
    """
    m, n = x.shape[-2], x.shape[-1]
    k = min(m, n)
    eps = torch.finfo(x.dtype).tiny
    rows = torch.arange(m, device=x.device)
    for j in range(min(n, m - 1)):
        col = x[..., :, j]
        below = (rows >= j).to(x.dtype)
        is_j = (rows == j).to(x.dtype)
        colm = col * below
        cs, norm2, norm, head = _scaled_col_stats(colm, is_j, eps)
        alpha = -_sign_safe(head) * norm
        v = cs - is_j * alpha
        vnorm2 = norm2 + alpha * alpha - 2.0 * head * alpha
        safe = vnorm2 > eps
        inv = torch.where(
            safe, 2.0 / torch.where(safe, vnorm2, torch.ones_like(vnorm2)),
            torch.zeros_like(vnorm2),
        )
        coeff = rounded.matmul(v[..., None, :], x)[..., 0, :]
        x = x - inv[..., None] * v[..., :, None] * coeff[..., None, :]
    return x[..., :k, :]


def qr_r(x):
    """Upper-triangular/trapezoidal ``R`` with ``R^T R = x^T x``; diag(R) >= 0.

    ``x``: (..., m, n).  Returns (..., min(m, n), n).  A whole-matrix
    power-of-two rescale engages only outside a wide exponent band, so
    inside it the elimination is bit-identical to unscaled arithmetic.
    """
    m, n = x.shape[-2], x.shape[-1]
    k = min(m, n)
    amax = torch.amax(torch.abs(x), dim=(-2, -1), keepdim=True)
    ok = torch.isfinite(amax) & (amax > 0)
    one = torch.ones_like(amax)
    e = torch.floor(torch.log2(torch.where(ok, amax, one)))
    band = _finfo_maxexp(x.dtype) // 3
    c = torch.where(ok & (torch.abs(e) > band), torch.exp2(e), one)
    r = _qr_r_householder(x / c)
    d = _sign_safe(torch.diagonal(r, dim1=-2, dim2=-1))
    return r[..., :k, :] * (c * d[..., :, None])


def _broadcast_batch(*xs):
    batch = torch.broadcast_shapes(*(x.shape[:-2] for x in xs))
    return [x.expand(batch + x.shape[-2:]) for x in xs]


def chol_from_stack(*stacked):
    """Lower factor ``L`` with ``L L^T = sum_i X_i^T X_i`` from right factors.

    Arguments are (..., m_i, n) blocks (batch dimensions broadcast);
    returns (..., n, n).
    """
    x = torch.cat(_broadcast_batch(*stacked), dim=-2)
    return qr_r(x).transpose(-1, -2)


def revert_markov(a_l, l_q, l_prev):
    """Joint square-root factorization of one Gauss-Markov transition.

    From ``a_l = A @ l_prev``, the scaled process-noise factor ``l_q`` and
    the previous factor ``l_prev``, one QR of
    ``[[ (A L)^T, L^T ], [ Lq^T, 0 ]]`` gives the predicted factor, the
    backward gain ``G = Sigma A^T S_pred^{-1}`` and the backward factor.
    """
    n = l_prev.shape[-1]
    a_l, l_q, l_prev = _broadcast_batch(a_l, l_q, l_prev)
    top = torch.cat([a_l.transpose(-1, -2), l_prev.transpose(-1, -2)], dim=-1)
    bottom = torch.cat([l_q.transpose(-1, -2), torch.zeros_like(l_q)], dim=-1)
    r = qr_r(torch.cat([top, bottom], dim=-2))
    r_yy = r[..., :n, :n]
    r_yx = r[..., :n, n:]
    r_xx = r[..., n:, n:]
    l_pred = r_yy.transpose(-1, -2)
    gain = rounded.solve_triangular_upper(r_yy, r_yx).transpose(-1, -2)
    l_bwd = r_xx.transpose(-1, -2)
    return l_pred, gain, l_bwd
