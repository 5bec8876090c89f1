"""Parallel-in-time fixed-grid filtering via associative scans (PyTorch
counterpart of ``odecheckpts_tpu.parallel_time``).

With the linearization points fixed, each solver step is an affine-Gaussian
filtering element ``(A, b, C, eta, J)``; elements combine associatively, so a
filter pass over a window of W steps runs in O(log W) depth.  TS0 linearizes
at the running predicted mean, which is sequential information, so the pass
iterates: linearize all steps of a window at the previous sweep's predicted
means (one vector-field evaluation over the window per sweep), run the
associative filter, repeat.  The grid is processed in windows: sequential
across windows, parallel and iterated within each.  At convergence the window
recursion satisfies the sequential recursion, so results equal the sequential
filter to reassociation error.

Element representations, as in the reference: ``form="sqrt"`` combines QR
factors (C = U U^T, J = Z Z^T; the float32-viable form), ``precondition``
combines in per-step dt-scaled coordinates, ``deviation`` carries the state
relative to the linearization trajectory.  ``fallback_rtol`` gates each
window: if the last sweep's proposed re-linearization moved by more than it
(or anything went non-finite), the window runs again as the plain sequential
filter.

What differs from the reference, which traces one program: the windows, the
sweeps and the fallback gate are Python control flow here (one host read per
window for the gate, one per sweep with ``iteration_tol``); the algebra of a
window is written batched over a leading step axis where the reference maps
one-step functions over it, and ``torch.func.vmap`` maps the vector field,
the warm start's fill step and its Taylor jets.  ``combine_engine`` takes
None (``_associative_scan`` on step-leading elements), ``"ll"`` (lanes-last
Kogge-Stone in plain torch ops, ``pit_fused``) and ``"cuda"`` (the same scan
with each level one launch of ``kernels.pit_combine``; the port's name for
the reference's ``"pallas"``).

The isotropic, dense (TS0 and TS1) and blockdiag backends with
``ode_order=1``.  Blockdiag's elements carry a block axis, one independent
chain per ODE dimension; with a combine engine its lanes-last prefix runs on
(m, m, d, P) operands.  Not ported: ``time_shard`` (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from . import ivpsolvers as _solvers
from . import linalg, pit_fused, prior, taylor
from .ssm.base import MarkovSeq, Normal, Solution

COMBINE_ENGINES = (None, "ll", "cuda")


def _mT(x):
    return x.transpose(-1, -2)


def _solve_qr(t, b):
    """Solve ``t x = b`` via Householder QR and unrolled back-substitution,
    batched over leading axes (``t`` (..., m, m), ``b`` (..., m, k))."""
    m = t.shape[-1]
    batch = torch.broadcast_shapes(t.shape[:-2], b.shape[:-2])
    aug = torch.cat([t.expand(batch + t.shape[-2:]), b.expand(batch + b.shape[-2:])], dim=-1)
    r = linalg.qr_r(aug)  # rows sign-normalized consistently: R x = Q^T b
    rr, qb = r[..., :m], r[..., m:]
    rows = [None] * m
    for i in reversed(range(m)):
        acc = qb[..., i, :]
        for j in range(i + 1, m):
            acc = acc - rr[..., i, j, None] * rows[j]
        rows[i] = acc / rr[..., i, i, None]
    return torch.stack(rows, dim=-2)


def _cholesky_small(c):
    """Unrolled lower Cholesky for small PSD matrices, batched over leading
    axes (the caller adds a jitter, so pivots stay positive)."""
    m = c.shape[-1]
    cols = []
    l_rows = [[None] * m for _ in range(m)]
    for j in range(m):
        s = c[..., j, j]
        for k in range(j):
            s = s - l_rows[j][k] * l_rows[j][k]
        d = torch.sqrt(torch.maximum(s, torch.zeros_like(s)))
        d_safe = torch.where(d > 0, d, torch.ones_like(d))
        col = [torch.zeros_like(d)] * j + [d]
        l_rows[j][j] = d
        for i in range(j + 1, m):
            s_ij = c[..., i, j]
            for k in range(j):
                s_ij = s_ij - l_rows[i][k] * l_rows[j][k]
            lij = torch.where(d > 0, s_ij / d_safe, torch.zeros_like(s_ij))
            l_rows[i][j] = lij
            col.append(lij)
        cols.append(torch.stack(col, dim=-1))
    return torch.stack(cols, dim=-1)


def _rsolve_upper(x, r):
    """X = x r^{-1} for upper-triangular r: forward substitution over the
    columns of r (``x`` may lack r's leading axes)."""
    m = r.shape[-1]
    cols = [None] * m
    for j in range(m):
        acc = x[..., :, j]
        for k in range(j):
            acc = acc - cols[k] * r[..., k, j, None]
        cols[j] = acc / r[..., j, j, None]
    return torch.stack(cols, dim=-1)


def _psolve(r, x):
    """Solve (r^T r) y = x for upper-triangular r: forward then backward
    substitution (r^T r is the Gram form the sqrt elements carry)."""
    m = r.shape[-1]
    rows = [None] * m
    for i in range(m):  # r^T w = x
        acc = x[..., i, :]
        for k in range(i):
            acc = acc - r[..., k, i, None] * rows[k]
        rows[i] = acc / r[..., i, i, None]
    out = [None] * m
    for i in reversed(range(m)):  # r y = w
        acc = rows[i]
        for k in range(i + 1, m):
            acc = acc - r[..., i, k, None] * out[k]
        out[i] = acc / r[..., i, i, None]
    return torch.stack(out, dim=-2)


def _sym(x):
    return 0.5 * (x + _mT(x))


def _combine(e_i, e_j):
    """Associative combination of filtering elements (earlier i, later j),
    covariance form."""
    a_i, b_i, c_i, eta_i, j_i = e_i
    a_j, b_j, c_j, eta_j, j_j = e_j
    eye = torch.eye(a_i.shape[-1], dtype=a_i.dtype, device=a_i.device)
    t = eye + c_i @ j_j  # (I + C_i J_j); (I + J_j C_i) = t^T for symmetric C, J
    a = a_j @ _solve_qr(t, a_i)
    b = a_j @ _solve_qr(t, b_i + c_i @ eta_j) + b_j
    c = a_j @ _solve_qr(t, c_i) @ _mT(a_j) + c_j
    eta = _mT(a_i) @ _solve_qr(_mT(t), eta_j - j_j @ b_i) + eta_i
    j = _mT(a_i) @ _solve_qr(_mT(t), j_j @ a_i) + j_i
    return (a, b, _sym(c), eta, _sym(j))


def _element(phi, q, h, v, drift=None):
    """Filtering element of one step: transition x_k = Phi x_{k-1} + c + w,
    w ~ N(0, Q) (``drift`` c defaults to 0), conditioned on the exact
    observation H x_k = v."""
    s = h @ q @ _mT(h)  # innovation covariance (r, r)
    k_gain = _mT(_solve_qr(s, h @ q))  # (m, r)
    i_kh = torch.eye(phi.shape[-1], dtype=phi.dtype, device=phi.device) - k_gain @ h
    a = i_kh @ phi
    if drift is None:
        b = k_gain @ v
        v_eff = v
    else:
        b = i_kh @ drift + k_gain @ v
        v_eff = v - h @ drift
    c = i_kh @ q @ _mT(i_kh)  # exact observation: (I-KH) Q (I-KH)^T
    eta = _mT(phi) @ _mT(h) @ _solve_qr(s, v_eff)
    j = _mT(phi) @ _mT(h) @ _solve_qr(s, h @ phi)
    return (a, b, _sym(c), eta, _sym(j))


def _identity_element(m_dim, c_dim, dtype, device=None):
    """Neutral element (pads the last window): x_k = x_{k-1}."""
    eye = torch.eye(m_dim, dtype=dtype, device=device)
    zmm = torch.zeros((m_dim, m_dim), dtype=dtype, device=device)
    zmc = torch.zeros((m_dim, c_dim), dtype=dtype, device=device)
    return (eye, zmc, zmm, zmc, zmm)


def _element_sqrt(phi, qc, h, v, drift=None):
    """Sqrt filtering element of one step (same semantics as ``_element``):
    (A, b, U, eta, Z) with C = U U^T and J = Z Z^T."""
    m = phi.shape[-1]
    r = h.shape[-2]
    g = h @ qc  # (r, m): S = g g^T
    r_s = linalg.qr_r(_mT(g))  # (r, r) upper, S = r_s^T r_s
    k_gain = qc @ _mT(_psolve(r_s, g))  # Q H^T S^-1  (m, r)
    i_kh = torch.eye(m, dtype=phi.dtype, device=phi.device) - k_gain @ h
    a = i_kh @ phi
    if drift is None:
        b = k_gain @ v
        v_eff = v
    else:
        b = i_kh @ drift + k_gain @ v
        v_eff = v - h @ drift
    u = i_kh @ qc  # C = (I-KH) Q (I-KH)^T exactly (exact observation)
    z_r = _rsolve_upper(_mT(phi) @ _mT(h), r_s)  # (m, r): J = z_r z_r^T
    z = torch.cat([z_r, z_r.new_zeros(z_r.shape[:-1] + (m - r,))], dim=-1)
    eta = _mT(phi) @ (_mT(h) @ _psolve(r_s, v_eff))
    return (a, b, u, eta, z)


def _stack_eye(top, m):
    """[top; I_m] stacked on the row axis, the identity broadcast over top's
    leading axes."""
    eye = torch.eye(m, dtype=top.dtype, device=top.device).expand(top.shape[:-2] + (m, m))
    return torch.cat([top, eye], dim=-2)


def _combine_sqrt(e_i, e_j):
    """Sqrt combination: Woodbury / push-through identities with the Gram
    factors R1^T R1 = I + M M^T and R2^T R2 = I + M^T M, M = U_i^T Z_j."""
    a_i, b_i, u_i, eta_i, z_i = e_i
    a_j, b_j, u_j, eta_j, z_j = e_j
    m = a_i.shape[-1]
    mm = _mT(u_i) @ z_j
    r1 = linalg.qr_r(_stack_eye(_mT(mm), m))
    r2 = linalg.qr_r(_stack_eye(mm, m))

    # (I + C_i J_j)^{-1} x = x - U_i (R1^T R1)^{-1} M Z_j^T x
    zta = _mT(z_j) @ a_i
    a = a_j @ a_i - (a_j @ u_i) @ _psolve(r1, mm @ zta)
    x = b_i + u_i @ (_mT(u_i) @ eta_j)
    b = a_j @ (x - u_i @ _psolve(r1, mm @ (_mT(z_j) @ x))) + b_j
    # (I + C_i J_j)^{-1} C_i = (U_i R1^{-1})(U_i R1^{-1})^T
    v = _rsolve_upper(u_i, r1)
    u = _mT(linalg.qr_r(torch.cat([_mT(a_j @ v), _mT(u_j)], dim=-2)))

    # dual side: (I + J_j C_i)^{-1} y = y - Z_j (R2^T R2)^{-1} M^T U_i^T y
    y0 = eta_j - z_j @ (_mT(z_j) @ b_i)
    eta = _mT(a_i) @ (y0 - z_j @ _psolve(r2, _mT(mm) @ (_mT(u_i) @ y0))) + eta_i
    # (I + J_j C_i)^{-1} J_j = (Z_j R2^{-1})(Z_j R2^{-1})^T
    y = _rsolve_upper(z_j, r2)
    z = _mT(linalg.qr_r(torch.cat([_mT(y) @ a_i, _mT(z_i)], dim=-2)))
    return (a, b, u, eta, z)


def _marginal_from_prefix_sqrt(prefix, m0c, w0):
    """Window-start N(m0, W0 W0^T) through the prefix elements (batched over
    the prefix' leading axes); returns (mean, lower covariance factor)."""
    a, b, u, eta, z = prefix
    m = a.shape[-1]
    m0w = _mT(w0) @ z  # (m, m)
    r0 = linalg.qr_r(_stack_eye(_mT(m0w), m))
    # gain = (I + P0 J)^{-1} P0 = W0 (R0^T R0)^{-1} W0^T
    innov = eta - z @ (_mT(z) @ m0c)
    m0_upd = m0c + w0 @ _psolve(r0, _mT(w0) @ innov)
    v0 = _rsolve_upper(w0, r0)  # P0_upd = v0 v0^T
    mean = a @ m0_upd + b
    chol = _mT(linalg.qr_r(torch.cat([_mT(a @ v0), _mT(u)], dim=-2)))
    return mean, chol


def _marginal_from_prefix_cov(prefix, m0c, p0):
    """p(x_k | z_{1:k}) for a window-start state N(m0, P0): pull the prefix'
    information pair back to x_0, then push through (A, b, C)."""
    a, b, c, eta, j = prefix
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    # gain = P0 (I + J P0)^{-1}, via the transposed system
    gain = _mT(_solve_qr(_mT(eye + j @ p0), _mT(p0)))
    m0_upd = m0c + gain @ (eta - j @ m0c)
    p0_upd = p0 - gain @ j @ p0
    mean = a @ m0_upd + b
    cov = a @ p0_upd @ _mT(a) + c
    return mean, _sym(cov)


def _associative_scan(fn, elems):
    """Inclusive prefix of ``elems`` (a tuple of tensors stacked on axis 0)
    under the associative ``fn(earlier, later)``, by the odd / even recursion
    of ``jax.lax.associative_scan``: the same combine order, and so the same
    rounding, as the reference."""
    num = elems[0].shape[0]
    if num < 2:
        return tuple(elems)
    reduced = fn(tuple(e[:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = _associative_scan(fn, reduced)
    if num % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    out = []
    for ev, od in zip(even, odd):
        both = ev.new_empty((num,) + ev.shape[1:])
        both[0::2] = ev
        both[1::2] = od
        out.append(both)
    return tuple(out)


class _Adapter(NamedTuple):
    """A backend's element layout for the parallel driver.

    ``materialize(dt, scale, jacs, o) -> (Phi, Qc, H)`` for a stack of steps
    (``dt`` (w,), ``scale`` (w,) or (w, d), ``jacs`` the (w, d, d) Jacobians
    of TS1); ``to_cols`` / ``from_cols`` map between a stack of SSM means and
    the elements' (m, c) column form; ``per_state`` spreads a (w, n)
    per-derivative vector (the preconditioner) over the elements' state
    axis; ``obs_cols`` puts the residuals (w, d) in the elements'
    observation layout; ``deriv_rows(x, o)`` is the derivative rows 0..o of
    a stack of SSM means (what the residual and Jacobian read);
    ``blocked``: the elements carry a block axis between the step axis and
    the matrix axes."""
    materialize: Callable
    to_cols: Callable
    from_cols: Callable
    per_state: Callable
    obs_cols: Callable
    deriv_rows: Callable
    m_dim: int
    c_dim: int
    blocked: bool


def _adapters(ssm):
    """The backend's ``_Adapter``.

    Isotropic: the state matrix acts on the derivative axis and d mean
    columns ride along one shared (n, n) covariance.  Dense: one (nd, nd)
    factor, derivative-major, one column, H carrying the Jacobians.
    Blockdiag: the same per-step matrices serve each dimension with its own
    scale, so every dimension is an independent element chain on a block
    axis."""
    nu, n, d = ssm.num_derivatives, ssm.n, ssm.d

    def system(dt):
        phi = prior.phi_direct(dt, nu)
        p, _ = prior.preconditioner(dt, nu)
        _, l_q = prior.system_matrices(nu, dtype=dt.dtype, device=dt.device)
        return phi, p[..., :, None] * l_q

    def unit_row(dt, o):
        h = torch.zeros(dt.shape + (1, n), dtype=dt.dtype, device=dt.device)
        h[..., 0, o] = 1.0
        return h

    def column(mean):
        return mean[..., None]

    def uncolumn(b):
        return b[..., 0]

    if ssm.name == "isotropic":  # means (w, n, d)
        def materialize(dt, scale, jacs, o):
            phi, pl = system(dt)
            return phi, scale[..., None, None] * pl, unit_row(dt, o)

        def identity(x):
            return x

        return _Adapter(materialize, identity, identity, identity,
                        lambda z: z[..., None, :], lambda x, o: x[:, : o + 1], n, d, False)
    if ssm.name == "blockdiag":  # means (w, d, n)
        def materialize(dt, scale, jacs, o):
            phi, pl = system(dt)
            qc = scale[..., :, None, None] * pl[..., None, :, :]
            return phi[..., None, :, :], qc, unit_row(dt, o)[..., None, :, :]

        return _Adapter(materialize, column, uncolumn, lambda p: p[:, None],
                        lambda z: z[..., None, None], lambda x, o: x[..., : o + 1], n, 1, True)
    if ssm.name == "dense":  # means (w, n d)
        def materialize(dt, scale, jacs, o):
            phi, pl = system(dt)
            h = torch.zeros(dt.shape + (d, n * d), dtype=dt.dtype, device=dt.device)
            h[..., :, o * d : (o + 1) * d] = torch.eye(d, dtype=dt.dtype, device=dt.device)
            for k, jac in enumerate(jacs):
                h[..., :, k * d : (k + 1) * d] += -jac
            return ssm._kron_eye(phi), ssm._kron_eye(scale[..., None, None] * pl), h

        return _Adapter(materialize, column, uncolumn,
                        lambda p: torch.repeat_interleave(p, d, dim=-1),
                        lambda z: z[..., :, None], lambda x, o: x[:, : (o + 1) * d],
                        n * d, 1, False)
    raise NotImplementedError(ssm.name)


def _warmstart_rk(vf, ssm, rv0_mean, grid, o, nu, stride=1, method="rk4"):
    """Warm-start linearization: one sequential mean sweep over the grid
    (vector-field evaluations only), then Taylor jets mapped over every grid
    point rebuild the (nu + 1)-row state stack, extrapolated through each
    step from its left endpoint (the converged linearization point is a
    prediction, not the solution at t_k).

    ``method``: "rk4" (classical RK4) or "sie" (linearized-implicit Euler,
    A-stable: one d-by-d solve per step, for stiff adaptive grids).
    ``stride`` > 1 cuts the sweep's sequential depth from T to T / stride: the
    loop advances one anchor per ``stride`` fine steps, and every fine left
    endpoint is filled by one mapped offset step from its cell anchor."""
    y0 = tuple(ssm.select_deriv(rv0_mean, i) for i in range(o))

    def f(y, t):
        return y[1:] + (vf(*y, t=t),)

    def rk4_one(y, t_new, dt):
        t = t_new - dt
        half, sixth = dt / torch.full_like(dt, 2.0), dt / torch.full_like(dt, 6.0)

        def add(yy, k, c):
            return tuple(yi + c * ki for yi, ki in zip(yy, k))

        k1 = f(y, t)
        k2 = f(add(y, k1, half), t + half)
        k3 = f(add(y, k2, half), t + half)
        k4 = f(add(y, k3, dt), t + dt)
        return tuple(
            yi + sixth * (a + 2 * b + 2 * c + d) for yi, a, b, c, d in zip(y, k1, k2, k3, k4)
        )

    def sie_one(y, t_new, dt):
        """y+ = y + dt (I - dt J(y))^{-1} f(y): first order, A-stable."""
        t = t_new - dt
        sizes = [yi.shape[0] for yi in y]
        flat = torch.cat(y)

        def f_flat(yf):
            return torch.cat(f(tuple(torch.split(yf, sizes)), t))

        f0 = f_flat(flat)
        jac = torch.func.jacfwd(f_flat)(flat)
        eye = torch.eye(flat.shape[0], dtype=flat.dtype, device=flat.device)
        dy = _solve_qr(eye - dt * jac, f0[:, None])[:, 0]
        return tuple(torch.split(flat + dt * dy, sizes))

    step_one = rk4_one if method == "rk4" else sie_one
    ts, dts = grid[1:], torch.diff(grid)
    t1 = len(ts)
    if stride > 1:
        # anchors at fine indices 0, stride, 2 stride, ...: one step spans each
        # cell, then a mapped offset step fills every fine left endpoint from
        # its cell anchor (a zero-width step at the anchors)
        idx_a = torch.arange(0, t1, stride, device=grid.device)
        t_a = grid[idx_a]
        t_a_next = grid[torch.clamp(idx_a + stride, max=t1)]
        y, anchors = y0, []
        for t_next, dt in zip(t_a_next.unbind(0), (t_a_next - t_a).unbind(0)):
            anchors.append(y)  # the left state of the cell
            y = step_one(y, t_next, dt)
        a_of_j = torch.arange(t1, device=grid.device) // stride
        y_base = tuple(torch.stack([a[i] for a in anchors])[a_of_j] for i in range(o))
        t_left = grid[:-1]
        dt_off = t_left - t_a[a_of_j]
        traj_prev = torch.func.vmap(lambda yb, t, d: step_one(yb, t, d))(y_base, t_left, dt_off)
    else:
        y, traj = y0, []
        for t_next, dt in zip(ts.unbind(0), dts.unbind(0)):
            y = step_one(y, t_next, dt)
            traj.append(y)
        traj_prev = tuple(
            torch.stack([y0[i]] + [yy[i] for yy in traj[:-1]]) for i in range(o)
        )

    def jet_one(y, t, dt):
        tc = taylor.odejet_padded_scan(lambda *a: vf(*a, t=t), y, num=nu + 1 - o)
        # forward-mode tangents of a vector field with Python-float parameters
        # come out in float64: keep the grid's dtype
        tc = [c.to(dt.dtype) for c in tc]
        return ssm.extrapolate_mean(ssm.stack_tcoeffs(tc).mean, dt)[0]

    return torch.func.vmap(jet_one)(traj_prev, grid[:-1], dts)  # (T-1,) + mean shape


def _parse_warmstart(warmstart):
    """None -> None; "rk" / "sie" -> (method, 1); "rk:<s>" / "sie:<s>" ->
    (method, s), the anchor spacing of ``_warmstart_rk``; an array ->
    ("given", None): a precomputed linearization trajectory of shape
    (len(grid) - 1,) + mean shape."""
    if warmstart is None:
        return None
    if not isinstance(warmstart, str):
        if hasattr(warmstart, "shape"):
            return "given", None
    else:
        for prefix, method in (("rk", "rk4"), ("sie", "sie")):
            if warmstart == prefix:
                return method, 1
            if warmstart.startswith(prefix + ":"):
                try:
                    stride = int(warmstart[len(prefix) + 1:])
                except ValueError:
                    stride = 0
                if stride >= 1:
                    return method, stride
    raise ValueError(
        "warmstart must be None, 'rk[:<stride>]', 'sie[:<stride>]', or a "
        f"precomputed linearization array; got {warmstart!r}"
    )


def solve_fixed_grid_parallel(
    vf, init, *, grid, solver, iterations=8, window=16, form="cov",
    warmstart=None, damping=0.0, precondition=True, deviation=True,
    fallback_rtol=1.0, time_shard=None, combine_engine=None,
    iteration_tol=None, return_diagnostics=False,
):
    """Fixed-grid solve, parallel in time within windows.

    Same semantics and ``Solution`` layout as ``ivpsolve.solve_fixed_grid``
    (calibration "none" or "dynamic").  The forward filter runs as windowed
    associative scans (``window`` steps per scan, ``iterations``
    re-linearization sweeps each); for the smoother and fixedpoint strategies
    the backward conditionals are then reverted from the filtered marginals
    in one batched pass.

    ``form``: "cov" combines in covariance / information form (wants
    float64), "sqrt" combines QR factors (float32-viable).  ``warmstart``:
    None (a constant trajectory at the window-start mean), ``"rk[:<s>]"``
    (an RK4 mean sweep with anchors every s-th grid point, plus Taylor jets),
    ``"sie[:<s>]"`` (the same with A-stable linearized-implicit Euler), or an
    array of shape (len(grid) - 1,) + mean shape.  ``damping`` in [0, 1) keeps
    that fraction of the previous linearization per sweep.  ``iteration_tol``:
    sweeps stop once the proposed re-linearization moves less than this
    (relative), up to ``iterations`` in all.  ``combine_engine``: None, "ll"
    or "cuda" (sqrt form only; "cuda" raises where the kernel cannot run).
    ``return_diagnostics=True`` also returns the per-window final-sweep delta
    and whether the sequential fallback fired."""
    if form not in ("cov", "sqrt"):
        raise ValueError(f"form must be 'cov' or 'sqrt', got {form!r}")
    if combine_engine not in COMBINE_ENGINES:
        raise ValueError(
            "combine_engine must be None (_associative_scan on step-leading elements), 'll' "
            "(lanes-last Kogge-Stone in plain torch ops) or 'cuda' (one launch of the "
            f"pit_combine kernel per level); got {combine_engine!r}"
        )
    if combine_engine is not None and form != "sqrt":
        raise ValueError("combine_engine fuses the SQRT element combine; pass form='sqrt'")
    if time_shard is not None:
        raise NotImplementedError(
            "time_shard (the step axis sharded over devices) is not ported yet: ROADMAP "
            "queue 1 item 8"
        )
    _parse_warmstart(warmstart)  # validate early
    return _solve_fixed_grid_parallel(
        vf, init, grid=grid, solver=solver, iterations=iterations, window=window, form=form,
        warmstart=warmstart, damping=damping, precondition=precondition,
        deviation=deviation, fallback_rtol=fallback_rtol, combine_engine=combine_engine,
        iteration_tol=iteration_tol, return_diagnostics=return_diagnostics,
    )


def _solve_fixed_grid_parallel(vf, init, *, grid, solver, iterations, window, form,
                               warmstart, damping, precondition, deviation, fallback_rtol,
                               combine_engine, iteration_tol, return_diagnostics):
    from .ivpsolve import _tree_prepend, _validate_increasing

    ssm = solver.ssm
    strategy = solver.strategy
    corr = strategy.correction
    if solver.calibration == _solvers.MLE:
        raise NotImplementedError("mle calibration is post-hoc; use none/dynamic")
    dynamic = solver.calibration == _solvers.DYNAMIC
    rv0, scale0 = init
    dtype, device = rv0.mean.dtype, rv0.mean.device
    _validate_increasing(grid, "grid")
    grid = torch.as_tensor(grid, dtype=dtype, device=device)

    o = corr.ode_order
    adapter = _adapters(ssm)
    materialize, to_cols, from_cols = adapter.materialize, adapter.to_cols, adapter.from_cols
    m_dim, c_dim = adapter.m_dim, adapter.c_dim
    ts, dts = grid[1:], torch.diff(grid)
    t1 = len(ts)
    if t1 == 0:
        raise ValueError("grid must hold at least two points")
    w = max(1, min(window, t1))
    pad = (-t1) % w
    num_w = (t1 + pad) // w
    valid_host = np.concatenate([np.ones(t1, bool), np.zeros(pad, bool)]).reshape(num_w, w)
    valid_w = torch.as_tensor(valid_host, device=device)

    def windows(x):
        """Pad the step axis with the last entry and cut it into windows."""
        x = torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
        return x.reshape((num_w, w) + x.shape[1:])

    ts_w, dts_w = windows(ts), windows(dts)

    ws_parsed = _parse_warmstart(warmstart)
    if ws_parsed is not None:
        ws_method, ws_stride = ws_parsed
        if ws_method == "given":
            lin_warm = torch.as_tensor(warmstart, dtype=dtype, device=device)
            if lin_warm.shape != (t1,) + rv0.mean.shape:
                raise ValueError(
                    "precomputed warmstart must have shape (len(grid)-1,)"
                    f" + mean shape = {(t1,) + tuple(rv0.mean.shape)}, got "
                    f"{tuple(lin_warm.shape)}"
                )
        else:
            lin_warm = _warmstart_rk(vf, ssm, rv0.mean, grid, o, ssm.n - 1,
                                     stride=ws_stride, method=ws_method)
        lin_warm_w = windows(lin_warm)
    else:
        lin_warm_w = None

    # covariance-form floor: J ~ 1 / (scale^2 dt^(2(nu-o)+1)) must not overflow
    # through combinations; floor sigma at eps relative to the base output
    # scale (no effect once sigma is physical)
    scale_none = ssm.promote_output_scale(scale0).to(dtype=dtype, device=device)
    eps = float(torch.finfo(dtype).eps)
    tiny = eps * torch.clamp(torch.abs(scale_none), min=1.0)
    ident = _identity_element(m_dim, c_dim, dtype, device)

    def steps_like(mask, x):
        """The step mask ``mask`` (w,) shaped to broadcast against ``x``."""
        return mask.reshape(mask.shape + (1,) * (x.dim() - 1))

    make_element = (
        (lambda phi, qc, h, v, drift=None: _element(phi, qc @ _mT(qc), h, v, drift))
        if form == "cov" else _element_sqrt
    )
    combine = _combine if form == "cov" else _combine_sqrt
    marginal = _marginal_from_prefix_cov if form == "cov" else _marginal_from_prefix_sqrt
    # the fused build (element construction, prefix and marginal all
    # lanes-last, pit_fused) serves the shared-covariance sqrt layouts whenever
    # a combine engine is named; blockdiag and the cov form keep the
    # step-leading build (blockdiag with the lanes-last prefix, its block axis
    # between the matrix axes and the steps)
    use_fused_build = form == "sqrt" and combine_engine is not None and not adapter.blocked
    prefix_engine = "cuda" if combine_engine == "cuda" else "torch"

    def lin_one(lin, t, dt):
        """Linearization of every step of a window (the vector-field work of
        one sweep): residuals, Jacobians (none for TS0) and sigmas."""
        _, cache = ssm.extrapolate_mean(lin, dt)  # only the cache (p, p_inv)
        z, jacs = _solvers.linearize(strategy, vf, lin, t)
        sigma, _err = _solvers.error_and_scale(strategy, z, jacs, cache)
        return z, jacs, sigma

    def iter_delta(lin_ret, lin_fin, ok_k):
        """Largest elementwise relative change of the re-linearization over
        the window's valid steps, on the derivative rows 0..o that enter the
        elements (residual and Jacobian)."""
        lr, lf = adapter.deriv_rows(lin_ret, o), adapter.deriv_rows(lin_fin, o)
        rel = torch.abs(lr - lf) / (1.0 + torch.abs(lf))
        return torch.max(torch.where(steps_like(ok_k, rel), rel, torch.zeros_like(rel)))

    def build_all(r_cols, r_prev, dts_k, ok_k, z_k, jacs_k, scale_k, pv_k, pinv_k, pv_prev):
        """Step-leading element build of a window (``_element_sqrt`` /
        ``_element`` over the step axis, and the block axis of blockdiag)."""
        phi, qc, h = materialize(dts_k, scale_k, jacs_k, o)
        v_obs = adapter.obs_cols(z_k)
        if deviation:
            # deviation state dx_k = x_k - r_k with reference r_k = lin_k: the
            # observation value is the local residual -z and the transition
            # drift Phi r_{k-1} - r_k the (small) prediction-filter gap
            drift = phi @ r_prev - r_cols
            v = -v_obs
        else:
            drift = None
            v = h @ r_cols - v_obs  # exact observation H x_k = v
        if precondition:
            # x_hat_k = T_k^-1 x_k: the incoming state is in the previous
            # interface's coordinates
            phi = pinv_k[..., :, None] * phi * pv_prev[..., None, :]
            qc = pinv_k[..., :, None] * qc
            h = h * pv_k[..., None, :]
            if drift is not None:
                drift = pinv_k[..., :, None] * drift
        el = make_element(phi, qc, h, v, drift)
        ident_k = list(ident)
        if deviation:
            # padded slots must be physical identities: dx carries through
            # with the reference shift r_{k-1} - r_k as drift
            ident_k[1] = pinv_k[..., :, None] * (r_prev - r_cols)
        return tuple(torch.where(steps_like(ok_k, e), e, i) for e, i in zip(el, ident_k))

    def prefix_ll(els):
        """The window prefix of step-leading blockdiag elements (w, d, m, k)
        by ``pit_fused.prefix_scan_sqrt_ll`` on (m, k, d, w)."""
        pre = pit_fused.prefix_scan_sqrt_ll(
            tuple(torch.movedim(torch.movedim(x, 0, -1), 0, -2) for x in els),
            engine=prefix_engine)
        return tuple(torch.movedim(torch.movedim(x, -2, 0), -1, 0) for x in pre)

    def build_fused(r_cols, r_prev, dts_k, ok_k, z_k, jacs_k, scale_k, pv_k, pinv_k, pv_prev,
                    m0_for_marg, p0_h):
        """Element build, prefix and window marginal lanes-last (pit_fused),
        the step axis last."""
        phi_w, qc_w, h_w = materialize(dts_k, scale_k, jacs_k, o)

        def ll(x):
            return torch.movedim(x, 0, -1)

        phi_l, qc_l, h_l = ll(phi_w), ll(qc_w), ll(h_w)
        lin_l, rprev_l = ll(r_cols), ll(r_prev)
        z_l = ll(adapter.obs_cols(z_k))
        if deviation:
            drift_l = pit_fused._mat(phi_l, rprev_l) - lin_l
            v_l = -z_l
        else:
            drift_l = None
            v_l = pit_fused._mat(h_l, lin_l) - z_l
        pinv_l, pv_l, pvp_l = pinv_k.T, pv_k.T, pv_prev.T  # (m, w)
        if precondition:
            phi_l = pinv_l[:, None] * phi_l * pvp_l[None]
            qc_l = pinv_l[:, None] * qc_l
            h_l = h_l * pv_l[None]
            if drift_l is not None:
                drift_l = pinv_l[:, None] * drift_l
        els_ll = pit_fused.element_sqrt_ll(phi_l, qc_l, h_l, v_l, drift_l)
        ident_ll = list(pit_fused.identity_element_ll(m_dim, c_dim, 1, dtype, device=device))
        if deviation:
            ident_ll[1] = pinv_l[:, None] * (rprev_l - lin_l)
        okl = ok_k[None, None, :]
        els_ll = tuple(torch.where(okl, e, i) for e, i in zip(els_ll, ident_ll))
        pre_ll = pit_fused.prefix_scan_sqrt_ll(els_ll, engine=prefix_engine)
        mch_l, cvh_l = pit_fused.marginal_sqrt_ll(pre_ll, m0_for_marg, p0_h)
        return torch.movedim(mch_l, -1, 0), torch.movedim(cvh_l, -1, 0)

    def window_step(carry, ts_k, dts_k, ok_k, ok_host, lin0):
        m0c, p0 = carry  # column form; p0: covariance ("cov") or its factor ("sqrt")

        if precondition:
            # per-step preconditioning: element k lives in its own T(dt_k)
            # coordinates, A_hat_k = T_k^{-1} Phi_k T_{k-1}; the window-start
            # interface uses the first step's coordinates (T_0 := T_1)
            pv_k, pinv_k = (adapter.per_state(x)
                            for x in prior.preconditioner(dts_k, ssm.num_derivatives))
            pv_prev = torch.cat([pv_k[:1], pv_k[:-1]])
        else:
            pv_k = pinv_k = pv_prev = adapter.per_state(
                torch.ones((w, ssm.n), dtype=dtype, device=device))
        # carry into the window-start hat coordinates
        m0c_h = pinv_k[0][..., :, None] * m0c
        p0_h = (pinv_k[0][..., :, None] * p0 * pinv_k[0][..., None, :] if form == "cov"
                else pinv_k[0][..., :, None] * p0)
        # dx_0 = x_0 - r_0 = 0 (r_0 is the window-start mean)
        m0_for_marg = torch.zeros_like(m0c_h) if deviation else m0c_h

        def sweep(lin):
            r_cols = to_cols(lin)  # deviation references r_k
            r_prev = torch.cat([m0c[None], r_cols[:-1]])
            z_k, jacs_k, sig_k = lin_one(lin, ts_k, dts_k)
            ok_s = steps_like(ok_k, sig_k)
            if dynamic and dtype == torch.float32:
                # per-window sigma floor at sqrt(eps) times the window's largest
                # sigma, float32 only: once the linearization is accurate to
                # f32 rounding, per-step residuals are noise, and a noise-driven
                # sigma spread of many decades makes the combine factors
                # mutually singular.  f64 combines tolerate the full spread,
                # and a converged window's legitimate spread can exceed
                # 1 / sqrt(eps64), so f64 stays unfloored.
                sigma_floor = eps ** 0.5 * torch.max(
                    torch.where(ok_s, sig_k, torch.zeros_like(sig_k)))
            else:
                sigma_floor = torch.zeros((), dtype=dtype, device=device)
            if dynamic:
                scale_k = torch.maximum(sig_k, torch.maximum(sigma_floor, tiny))
            else:
                scale_k = scale_none.expand(ok_k.shape + scale_none.shape)
            args = (r_cols, r_prev, dts_k, ok_k, z_k, jacs_k, scale_k, pv_k, pinv_k, pv_prev)
            if use_fused_build:
                means_ch, covs_h = build_fused(*args, m0_for_marg, p0_h)
            else:
                els = build_all(*args)
                if combine_engine is not None:
                    prefix = prefix_ll(els)
                else:
                    prefix = _associative_scan(combine, els)
                means_ch, covs_h = marginal(prefix, m0_for_marg, p0_h)
            scales = torch.where(steps_like(ok_k, scale_k), scale_k, scale_none)
            # back to physical coordinates, per step
            pv_s = pv_k[..., :, None]
            means_c = pv_s * means_ch
            if deviation:
                means_c = means_c + r_cols
            covs = pv_s * covs_h * _mT(pv_s) if form == "cov" else pv_s * covs_h
            means = from_cols(means_c)
            # next linearization: l_k = Phi_k m_{k-1}, m_0 = window start
            m_prev = torch.cat([from_cols(m0c)[None], means[:-1]])
            lin_next = ssm.extrapolate_mean(m_prev, dts_k)[0]
            if damping:
                lin_next = damping * lin + (1.0 - damping) * lin_next
            return lin_next, (means, covs, scales)

        def run_sequential():
            """Fallback: the plain sequential filter over this window's steps
            (re-linearizing at the running predicted mean), for a window whose
            affine iteration diverged."""
            if form == "cov":
                jit0 = eps * torch.clamp(torch.diagonal(p0, dim1=-2, dim2=-1).sum(-1), min=1.0)
                eye_m = torch.eye(m_dim, dtype=dtype, device=device)
                chol0 = _cholesky_small(p0 + jit0[..., None, None] * eye_m)
            else:
                chol0 = p0
            rv = Normal(from_cols(m0c), chol0)
            means_s, covs_s, scales_s = [], [], []
            for t_k, dt_k, ok_1 in zip(ts_k.unbind(0), dts_k.unbind(0), ok_host):
                if ok_1:  # a padded slot carries the state and the base scale
                    m_pred, cache = ssm.extrapolate_mean(rv.mean, dt_k)
                    z, jacs = _solvers.linearize(strategy, vf, m_pred, t_k)
                    sigma, _err = _solvers.error_and_scale(strategy, z, jacs, cache)
                    scale = torch.maximum(sigma, tiny) if dynamic else scale_none
                    rv_pred, _bwd = ssm.extrapolate_cov(rv, m_pred, cache, scale, False)
                    rv, _obs = _solvers.correct(strategy, rv_pred, z, jacs)
                else:
                    scale = scale_none
                means_s.append(rv.mean)
                covs_s.append(rv.cholesky @ _mT(rv.cholesky) if form == "cov" else rv.cholesky)
                scales_s.append(scale)
            return (to_cols(rv.mean), covs_s[-1]), (
                torch.stack(means_s), torch.stack(covs_s), torch.stack(scales_s))

        def finite(means, covs):
            return torch.all(torch.isfinite(means)) & torch.all(torch.isfinite(covs))

        lin = lin0
        if lin is None:
            # constant initial trajectory at the window-start mean: short
            # windows keep the iteration inside its contraction region
            lin = from_cols(m0c).expand((w,) + rv0.mean.shape)
        if iteration_tol is not None:
            # adaptive sweep count: iterate until the proposed re-linearization
            # moves less than iteration_tol (relative), up to iterations - 1
            # sweeps before the final one; one host read per sweep
            k = 0
            while k < iterations - 1:
                lin_next, _ = sweep(lin)
                delta_c = iter_delta(lin_next, lin, ok_k)
                lin, k = lin_next, k + 1
                if not bool(delta_c > iteration_tol):
                    break
        else:
            for _ in range(max(iterations - 1, 1)):
                lin, _ = sweep(lin)
        lin_ret, (means, covs, scales) = sweep(lin)
        # at convergence the final sweep's proposed re-linearization equals its
        # input to iteration tolerance: delta is the divergence gate's signal
        # and the per-window convergence diagnostic
        delta = iter_delta(lin_ret, lin, ok_k)
        diverged = torch.zeros((), dtype=torch.bool, device=device)
        carry = (to_cols(means[-1]), covs[-1])  # identity padding: the last valid state
        if fallback_rtol is not None:
            # gate on output finiteness too: a window can converge in its
            # observed rows while its covariance factors are already
            # non-finite, and the NaN would poison every later window
            diverged = (~torch.isfinite(delta) | (delta > fallback_rtol)
                        | ~finite(means, covs))
            if bool(diverged):  # the one host read of the window
                carry, (means, covs, scales) = run_sequential()
        return carry, (means, covs, scales, delta, diverged, finite(means, covs))

    p0_init = rv0.cholesky @ _mT(rv0.cholesky) if form == "cov" else rv0.cholesky
    carry, outs = (to_cols(rv0.mean), p0_init), []
    for k in range(num_w):
        lin0 = None if lin_warm_w is None else lin_warm_w[k]
        carry, out = window_step(carry, ts_w[k], dts_w[k], valid_w[k], valid_host[k], lin0)
        outs.append(out)
    means, covs, scales = (torch.cat([x[i] for x in outs])[:t1] for i in range(3))
    delta_w, div_w, fin_w = (torch.stack([x[i] for x in outs]) for i in range(3, 6))

    if form == "sqrt":
        chol_cols = covs  # already (lower) factors from the stacked QRs
    else:
        jitter = eps * torch.clamp(torch.diagonal(covs, dim1=-2, dim2=-1).sum(-1), min=1.0)
        chol_cols = _cholesky_small(
            covs + jitter[..., None, None] * torch.eye(m_dim, dtype=dtype, device=device))
    rvs = _tree_prepend(rv0, Normal(means, chol_cols))
    scales_full = torch.cat([scale_none[None], scales])

    if strategy.needs_reversal:
        # the sequential pass emits the backward conditional of each
        # prediction step, computed from the filtered state at t_{k-1}: the
        # reverts are independent given the marginals, one batched pass
        rvs_prev = Normal(rvs.mean[:-1], rvs.cholesky[:-1])
        m_pred, cache = ssm.extrapolate_mean(rvs_prev.mean, dts)
        _rv_pred, conds_rest = ssm.extrapolate_cov(rvs_prev, m_pred, cache, scales, True)
        conds = _tree_prepend(ssm.identity_conditional(dtype, device), conds_rest)
    else:
        conds = None

    sol = Solution(
        t=grid,
        u=ssm.qoi(rvs.mean),
        u_std=ssm.qoi_std(rvs),
        output_scale=scales_full,
        marginals=None,
        posterior=MarkovSeq(rvs, conds, ssm=ssm),
        num_steps=torch.arange(len(grid), dtype=torch.int32, device=device),
        ssm=ssm,
    )
    if return_diagnostics:
        return sol, {"window_delta": delta_w, "window_diverged": div_w,
                     "window_finite": fin_w, "window_size": w, "num_windows": num_w}
    return sol
