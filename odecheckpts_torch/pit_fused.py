"""Lanes-last parallel prefix for the sqrt parallel-in-time elements (PyTorch
counterpart of ``odecheckpts_tpu.pit_fused``).

Every element field carries the step axis as its last dimension: (m, m, P)
transition and covariance factors, (m, c, P) mean columns.  The prefix runs
as a Kogge-Stone scan: ceil(log2 P) levels, each one full-width combine of
every element with its s-left neighbour.  ``combine_sqrt_ll`` is that combine
in plain vectorized torch ops (the twin); ``engine="cuda"`` runs each level
as one launch of the hand-written kernel ``csrc/pit_combine.cu``
(``kernels.pit_combine``), which computes the twin's operations in the twin's
order, a team of 8 threads a pair.  The shift, the identity fill and the
``where(lane >= s)`` between the levels stay in PyTorch.

The element build (``element_sqrt_ll``) and the window marginals
(``marginal_sqrt_ll``) use the same lanes-last primitives.  Semantics match
``parallel_time._combine_sqrt`` / ``_element_sqrt`` /
``_marginal_from_prefix_sqrt`` up to orthogonal right factors of (U, Z): all
consumers read the factors through their Grams.

Not ported: the reference's ``engine="xla-scan"`` (the levels under one
``lax.scan``, a compile-size measure with no counterpart in eager PyTorch).
"""

from __future__ import annotations

import torch

from . import kernels
from .batched import _matmul_ll, _qr_r_cols

ENGINES = ("torch", "cuda")


def _mat(a, b):
    """(m, k, B) @ (k, l, B) lanes-last product, summed in column order."""
    return _matmul_ll(a, b, a.shape[1])


def _swap(a):
    return a.transpose(0, 1)


def _psolve_ll(r, x):
    """Solve (R^T R) Y = X for upper-triangular (m, m, B) R and (m, k, B) X:
    forward substitution with R^T, then backward with R."""
    m = r.shape[0]
    w = [None] * m
    for i in range(m):  # R^T w = x
        acc = x[i]
        for k in range(i):
            acc = acc - r[k, i][None] * w[k]
        w[i] = acc / r[i, i][None]
    out = [None] * m
    for i in reversed(range(m)):  # R y = w
        acc = w[i]
        for k in range(i + 1, m):
            acc = acc - r[i, k][None] * out[k]
        out[i] = acc / r[i, i][None]
    return torch.stack(out, dim=0)


def _rsolve_upper_ll(x, r):
    """Y = X R^{-1} for upper-triangular (m, m, B) R and (m, m, B) X:
    forward substitution over the columns of R."""
    m = r.shape[0]
    cols = [None] * m
    for j in range(m):
        acc = x[:, j]
        for k in range(j):
            acc = acc - cols[k] * r[k, j][None]
        cols[j] = acc / r[j, j][None]
    return torch.stack(cols, dim=1)


def _qr_stacked(top, bottom, m):
    """R of the (2m, m) stack whose column c is [top[c]; bottom[c]] (the
    columns stacked on axis 0: (m, m, B) each); returns the upper-triangular
    (m, m, B) R by the kernels' column-list QR (no sign normalization)."""
    cols = torch.cat([top, bottom], dim=1)  # (c, 2m, B)
    cols = _qr_r_cols(cols, 2 * m, m, torch.finfo(cols.dtype).tiny)
    return _swap(cols[:, :m])


def _eye_ll(m, like):
    """(m, m, 1, ..., 1) identity that broadcasts against ``like``."""
    eye = torch.eye(m, dtype=like.dtype, device=like.device)
    return eye.reshape((m, m) + (1,) * (like.dim() - 2))


def combine_sqrt_ll(e_i, e_j):
    """Lanes-last sqrt combination of the earlier elements ``e_i`` with the
    later ``e_j`` (``parallel_time._combine_sqrt`` with the pair axis last).

    Elements are (A, b, U, eta, Z) of shapes (m, m, B), (m, c, B), (m, m, B),
    (m, c, B), (m, m, B); C = U U^T, J = Z Z^T.  Further batch axes may sit
    between the matrix axes and the lanes.  This is the plain version of the
    kernel ``kernels.pit_combine``: the kernel runs these operations in this
    order.
    """
    a_i, b_i, u_i, eta_i, z_i = e_i
    a_j, b_j, u_j, eta_j, z_j = e_j
    m = a_i.shape[0]

    ui_t = _swap(u_i)
    zj_t = _swap(z_j)
    mm = _mat(ui_t, z_j)
    mm_t = _swap(mm)
    eye = _eye_ll(m, a_i).expand(a_i.shape)

    # R1^T R1 = I + M M^T (QR of [M^T; I]); R2^T R2 = I + M^T M ([M; I])
    r1 = _qr_stacked(mm, eye, m)
    r2 = _qr_stacked(mm_t, eye, m)

    # (I + C_i J_j)^{-1} x = x - U_i (R1^T R1)^{-1} M Z_j^T x
    zta = _mat(zj_t, a_i)
    a = _mat(a_j, a_i) - _mat(_mat(a_j, u_i), _psolve_ll(r1, _mat(mm, zta)))
    x = b_i + _mat(u_i, _mat(ui_t, eta_j))
    b = _mat(a_j, x - _mat(u_i, _psolve_ll(r1, _mat(mm, _mat(zj_t, x))))) + b_j
    # (I + C_i J_j)^{-1} C_i = (U_i R1^{-1})(U_i R1^{-1})^T
    v = _rsolve_upper_ll(u_i, r1)
    u = _swap(_qr_stacked(_mat(a_j, v), u_j, m))

    # dual side: (I + J_j C_i)^{-1} y = y - Z_j (R2^T R2)^{-1} M^T U_i^T y
    y0 = eta_j - _mat(z_j, _mat(zj_t, b_i))
    ai_t = _swap(a_i)
    eta = _mat(ai_t, y0 - _mat(z_j, _psolve_ll(r2, _mat(mm_t, _mat(ui_t, y0))))) + eta_i
    y = _rsolve_upper_ll(z_j, r2)
    z = _swap(_qr_stacked(_mat(ai_t, y), z_i, m))
    return (a, b, u, eta, z)


def identity_element_ll(m, c, p, dtype, extra=(), device=None):
    """Neutral sqrt element on ``p`` lanes: x_k = x_{k-1}.  ``extra``: batch
    axes between the matrix axes and the lane axis."""
    extra = tuple(extra)
    eye = torch.eye(m, dtype=dtype, device=device)
    eye = eye.reshape((m, m) + (1,) * (len(extra) + 1)).expand((m, m) + extra + (p,))
    zmm = torch.zeros((m, m) + extra + (p,), dtype=dtype, device=device)
    zmc = torch.zeros((m, c) + extra + (p,), dtype=dtype, device=device)
    return (eye.contiguous(), zmc, zmm, zmc, zmm)


def _combine_fn(engine):
    if engine not in ENGINES:
        raise ValueError(
            f"engine={engine!r}: the prefix runs on {ENGINES} (the plain twin, one launch "
            "of the CUDA kernel per level)"
        )
    return combine_sqrt_ll if engine == "torch" else _combine_cuda


def _combine_cuda(e_i, e_j):
    """``engine="cuda"``: the kernel, never its plain version."""
    if e_i[0].device.type != "cuda":
        raise RuntimeError(
            f"engine='cuda' runs the pit_combine kernel and takes CUDA tensors, got "
            f"{e_i[0].device} (engine='torch' is the plain version)"
        )
    return kernels.pit_combine(e_i, e_j)


def prefix_scan_sqrt_ll(els_ll, *, engine="torch"):
    """Inclusive prefix of lanes-last sqrt elements under ``combine_sqrt_ll``.

    ``els_ll``: (A, b, U, eta, Z) with trailing step axis P.  Kogge-Stone:
    level s combines each element with its s-left neighbour (identity fill),
    so prefix[i] holds elements [0..i] after ceil(log2 P) levels.
    ``engine="cuda"`` runs every level's combine as one launch of
    ``kernels.pit_combine`` (the ragged edge is masked in the kernel: no
    padding) and raises where the kernel cannot run."""
    combine = _combine_fn(engine)
    a = els_ll[0]
    p = a.shape[-1]
    m, c = els_ll[1].shape[0], els_ll[1].shape[1]
    ident = identity_element_ll(m, c, p, a.dtype, a.shape[2:-1], a.device)
    lanes = torch.arange(p, device=a.device)

    pre = tuple(x.contiguous() for x in els_ll)
    s = 1
    while s < p:
        shifted = tuple(
            torch.cat([i_el[..., :s], x[..., : p - s]], dim=-1) for x, i_el in zip(pre, ident)
        )
        new = combine(shifted, pre)
        mask = lanes >= s
        pre = tuple(torch.where(mask, nw, old) for nw, old in zip(new, pre))
        s *= 2
    return pre


def prefix_scan_sqrt(els, *, engine="torch"):
    """Step-leading convenience wrapper: elements (P, m, m) / (P, m, c) in,
    inclusive prefixes in the same layout out."""
    els_ll = tuple(torch.movedim(e, 0, -1).contiguous() for e in els)
    pre = prefix_scan_sqrt_ll(els_ll, engine=engine)
    return tuple(torch.movedim(e, -1, 0) for e in pre)


def element_sqrt_ll(phi, qc, h, v, drift=None):
    """Lanes-last sqrt filtering elements, all steps in one call.

    Shapes (B = step axis): ``phi`` / ``qc`` (m, m, B), ``h`` (r, m, B), ``v``
    (r, c, B), ``drift`` (m, c, B) or None.  Returns the (A, b, U, eta, Z) of
    ``parallel_time._element_sqrt`` with trailing B."""
    m = phi.shape[0]
    r = h.shape[0]
    g = _mat(h, qc)  # (r, m, B): S = g g^T
    # R_s: upper (r, r, B) from the column list of g^T (column c is g[c])
    r_s = _swap(_qr_r_cols(g, m, r, torch.finfo(g.dtype).tiny))[:r]
    k_gain = _mat(qc, _swap(_psolve_ll(r_s, g)))  # (m, r, B)
    i_kh = _eye_ll(m, phi) - _mat(k_gain, h)
    a = _mat(i_kh, phi)
    if drift is None:
        b = _mat(k_gain, v)
        v_eff = v
    else:
        b = _mat(i_kh, drift) + _mat(k_gain, v)
        v_eff = v - _mat(h, drift)
    u = _mat(i_kh, qc)
    phi_t, h_t = _swap(phi), _swap(h)
    z_r = _rsolve_upper_ll(_mat(phi_t, h_t), r_s)  # (m, r, B)
    if r < m:
        z = torch.cat([z_r, z_r.new_zeros((m, m - r) + z_r.shape[2:])], dim=1)
    else:
        z = z_r
    eta = _mat(phi_t, _mat(h_t, _psolve_ll(r_s, v_eff)))
    return (a, b, u, eta, z)


def marginal_sqrt_ll(prefix, m0c, w0):
    """Lanes-last window marginals: N(m0, W0 W0^T) through every prefix.

    ``prefix``: lanes-last element tuple; ``m0c`` (m, c) and ``w0`` (m, m)
    are the window-start state, shared across lanes.  Returns (means
    (m, c, B), lower factors (m, m, B))."""
    a, b, u, eta, z = prefix
    m = a.shape[0]
    m0l = m0c[..., None]
    w0l = w0[..., None]
    w0l_t = _swap(w0l)
    eye = _eye_ll(m, a).expand(a.shape)

    m0w = _mat(w0l_t, z)  # (m, m, B): W0^T Z_k
    # R0^T R0 = I + (W0^T Z)(W0^T Z)^T via the [m0w^T; I] stack
    r0 = _qr_stacked(m0w, eye, m)
    innov = eta - _mat(z, _mat(_swap(z), m0l))
    m0_upd = m0l + _mat(w0l, _psolve_ll(r0, _mat(w0l_t, innov)))
    v0 = _rsolve_upper_ll(w0l.expand(a.shape), r0)
    mean = _mat(a, m0_upd) + b
    chol = _swap(_qr_stacked(_mat(a, v0), u, m))
    return mean, chol
