"""Adaptive Runge-Kutta and Nystrom baselines (PyTorch counterpart of
``odecheckpts_tpu.rk``).

Embedded RK pairs (Bogacki-Shampine 3(2), Dormand-Prince 5(4), Tsitouras
5(4) and Dormand-Prince 8(7), the last from scipy's DOP853 coefficients) with
a PI controller; steps are clipped to land exactly on each save point.  The
Nystrom solvers integrate ``u'' = f(u, t)`` with velocity Verlet or
Yoshida's fourth-order composition of it, adaptively by step doubling or on
a fixed grid.

The state ``y0`` (and ``u0`` / ``du0``) is one IVP's (d,) vector or carries
leading batch axes, (..., d): the vector field is the one-IVP function,
mapped over the batch with ``torch.func.vmap``, and each lane has its own
step size and step count.  Every accept/reject loop runs through
``control_flow.while_loop``.  As in the reference, the step-size control is
not differentiated: the error estimate and the next step size carry no
gradient, the accepted values do.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import control_flow, ivpsolvers, rounded
from .ivpsolve import _tolerance as _tol


@dataclasses.dataclass(frozen=True)
class Tableau:
    name: str
    order: int
    a: tuple  # row k has k entries
    b: tuple  # solution weights
    b_err: tuple  # (b - b_hat): error weights
    c: tuple
    fsal: bool
    # DOP853's second error-weight set (the blended 5th / 3rd-order estimate)
    b_err2: tuple | None = None


def _bosh3():
    a = ((), (1 / 2,), (0.0, 3 / 4), (2 / 9, 1 / 3, 4 / 9))
    b = (2 / 9, 1 / 3, 4 / 9, 0.0)
    b_hat = (7 / 24, 1 / 4, 1 / 3, 1 / 8)
    b_err = tuple(x - y for x, y in zip(b, b_hat))
    c = (0.0, 1 / 2, 3 / 4, 1.0)
    return Tableau("bosh3", 3, a, b, b_err, c, True)


def _dopri5():
    a = (
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    )
    b = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
    b_hat = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
    b_err = tuple(x - y for x, y in zip(b, b_hat))
    c = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
    return Tableau("dopri5", 5, a, b, b_err, c, True)


def _tsit5():
    # Tsitouras (2011), "Runge-Kutta pairs of order 5(4) satisfying only the
    # first column simplifying assumption"
    c = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
    a = (
        (),
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
        (5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401,
         -0.028269050394068383),
        (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774),
    )
    b = (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774, 0.0)
    b_err = (0.00178001105222577714, 0.0008164344596567469, -0.007880878010261995,
             0.1447110071732629, -0.5823571654525552, 0.45808210592918697, -1 / 66)
    return Tableau("tsit5", 5, a, b, b_err, c, True)


def _dopri8():
    from scipy.integrate._ivp import dop853_coefficients as dc

    n = dc.N_STAGES  # 12
    a = tuple(tuple(float(x) for x in dc.A[k][:k]) for k in range(n)) + (
        tuple(float(x) for x in dc.B),)
    b = tuple(float(x) for x in dc.B) + (0.0,)
    b_err = tuple(float(x) for x in dc.E5[: n + 1])
    b_err2 = tuple(float(x) for x in dc.E3[: n + 1])
    c = tuple(float(x) for x in dc.C[: n + 1])
    return Tableau("dopri8", 8, a, b, b_err, c, True, b_err2=b_err2)


_TABLEAUS = {"bosh3": _bosh3, "tsit5": _tsit5, "dopri5": _dopri5, "dopri8": _dopri8}

# the PI controller of both families: safety, factor bounds, powers (scaled
# by 1 / (order + 1))
_SAFETY, _FMIN, _FMAX = 0.9, 0.2, 10.0
_P_I, _P_P = 0.7, 0.4


def _mapped(vf, params):
    """``f(y, t)``: the one-IVP ``vf(y, t=, p=params)`` on (..., d) states
    with ``t`` a scalar or of the batch shape."""
    def f(y, t):
        return ivpsolvers._call_vf(lambda u, *, t: vf(u, t=t, p=params), (y,), t)

    return f


def _weighted(w, ks):
    """sum_j w_j ks_j over the stage axis (a ``tensordot``, as the
    reference's)."""
    return torch.tensordot(w, torch.stack(ks), dims=1)


def _controller(errn, errn_prev, order, dt):
    """The next step size of every lane (not differentiated)."""
    floor = torch.full_like(errn, 1e-10)
    n1, n2 = _P_I / (order + 1.0), _P_P / (order + 1.0)
    errc = torch.maximum(errn, floor)
    factor = _SAFETY * rounded.pow(errc, -n1) * rounded.pow(errn_prev / errc, n2)
    factor = torch.where(torch.isfinite(factor), factor, torch.full_like(factor, _FMIN))
    return (dt * torch.clamp(factor, _FMIN, _FMAX)).detach()


def _stalled(dt, t):
    eps = float(torch.finfo(dt.dtype).eps)
    return dt <= 4.0 * eps * torch.clamp(torch.abs(t), min=1.0)


class _RKState(NamedTuple):
    t: torch.Tensor
    y: torch.Tensor
    f: torch.Tensor  # FSAL: the vector field at (t, y)
    dt: torch.Tensor
    errn_prev: torch.Tensor
    num_steps: torch.Tensor


def solve_rk_save_at(method: str, vf, y0, *, save_at, dt0, atol, rtol, params=None):
    """Adaptive embedded-RK solve emitting the states exactly at ``save_at``
    (``odecheckpts_tpu/rk.py:171-270``).

    ``vf(y, t=, p=)`` is the one-IVP vector field; ``y0`` is (..., d) and the
    solve runs on its device, in its dtype.  ``atol`` / ``rtol`` are scalars
    or of the batch shape.  Returns ``(ys, num_steps)``: ``ys`` (T, ..., d),
    time-leading, and the attempts (accepted and rejected) of every lane."""
    tab = _TABLEAUS[method]()
    y0 = torch.as_tensor(y0)
    dtype, device = y0.dtype, y0.device
    save_at = torch.as_tensor(save_at, dtype=dtype, device=device)
    batch = y0.shape[:-1]

    def coeffs(values):
        return torch.tensor(values, dtype=dtype, device=device)

    a_rows = [coeffs(row) for row in tab.a]
    b, b_err = coeffs(tab.b), coeffs(tab.b_err)
    b_err2 = None if tab.b_err2 is None else coeffs(tab.b_err2)
    c = coeffs(tab.c)
    tiny = float(torch.finfo(dtype).tiny)
    f = _mapped(vf, params)

    def attempt(s: _RKState, t_stop):
        dt = torch.minimum(s.dt, t_stop - s.t)
        dtc = dt[..., None]
        ks = [s.f]
        for k in range(1, len(tab.b)):
            incr = sum(a_rows[k][j] * ks[j] for j in range(k))
            ks.append(f(s.y + dtc * incr, s.t + c[k] * dt))
        y_new = s.y + dtc * _weighted(b, ks)
        # the error norm only steers the controller: no gradient (the reference's)
        y_d, y_new_d = s.y.detach(), y_new.detach()
        ks_d = [k.detach() for k in ks]
        tol = _tol(atol, y_d) + _tol(rtol, y_d) * torch.maximum(torch.abs(y_d), torch.abs(y_new_d))
        err = dtc.detach() * _weighted(b_err, ks_d)
        errn = rounded.sqrt(torch.mean((err / tol) ** 2, dim=-1) + tiny)
        if b_err2 is not None:
            # DOP853's blend: A^2 / hypot(A, 0.1 B) of the 5th- / 3rd-order norms
            err3 = dtc.detach() * _weighted(b_err2, ks_d)
            errn3 = rounded.sqrt(torch.mean((err3 / tol) ** 2, dim=-1))
            denom = rounded.sqrt(errn**2 + 0.01 * errn3**2)
            errn = torch.where(denom > 0.0, errn * (errn / denom), errn)
        errn = torch.where(torch.isfinite(errn), errn, torch.full_like(errn, float("inf")))
        dt_next = _controller(errn, s.errn_prev, tab.order, s.dt)
        accept = (errn <= 1.0) | _stalled(dt, s.t)
        accepted = _RKState(
            t=s.t + dt, y=y_new, f=ks[-1] if tab.fsal else f(y_new, s.t + dt), dt=dt_next,
            errn_prev=torch.clamp(errn, min=tiny), num_steps=s.num_steps + 1)
        rejected = s._replace(dt=dt_next, num_steps=s.num_steps + 1)
        return control_flow.tree_select(accept, accepted, rejected)

    def full(value, dt=dtype):
        return torch.full(batch, value, dtype=dt, device=device)

    s = _RKState(t=save_at[0].expand(batch), y=y0, f=f(y0, save_at[0]), dt=full(float(dt0)),
                 errn_prev=full(1.0), num_steps=full(0, torch.int32))
    ys = [y0]
    for t_next in save_at[1:].unbind(0):
        s = control_flow.while_loop(lambda st, t_next=t_next: st.t < t_next,
                                    lambda st, t_next=t_next: attempt(st, t_next), s)
        ys.append(s.y)
    return torch.stack(ys), s.num_steps


# -- Nystrom-type baselines for u'' = f(u, t) --------------------------------

_NYSTROM_ORDERS = {"verlet2": 2, "yoshida4": 4}


def _check_nystrom(method):
    if method not in _NYSTROM_ORDERS:
        raise ValueError(
            f"unknown Nystrom method {method!r}; pick from {sorted(_NYSTROM_ORDERS)}")


def _nystrom_step(method, f):
    """One composition step ``(u, v, a, t, dt) -> (u, v, a)``: velocity
    Verlet, or Yoshida's triple jump of it (w1 = 1 / (2 - 2^(1/3)),
    w0 = 1 - 2 w1); one force evaluation per Verlet substep."""
    def verlet(u, v, a, t, dt):
        dtc = dt[..., None]
        v_half = v + 0.5 * dtc * a
        u_new = u + dtc * v_half
        a_new = f(u_new, t + dt)
        return u_new, v_half + 0.5 * dtc * a_new, a_new

    if method == "verlet2":
        return verlet, 1
    w1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
    w0 = 1.0 - 2.0 * w1

    def yoshida(u, v, a, t, dt):
        u, v, a = verlet(u, v, a, t, w1 * dt)
        u, v, a = verlet(u, v, a, t + w1 * dt, w0 * dt)
        return verlet(u, v, a, t + (w1 + w0) * dt, w1 * dt)

    return yoshida, 3


class _NystromState(NamedTuple):
    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor  # FSAL: the acceleration f(u, t)
    dt: torch.Tensor
    errn_prev: torch.Tensor
    num_steps: torch.Tensor


def solve_nystrom_save_at(method: str, vf2, u0, du0, *, save_at, dt0, atol, rtol, params=()):
    """Adaptive Nystrom solve of ``u'' = vf2(u, t=, p=)`` emitting the states
    exactly at ``save_at`` (``odecheckpts_tpu/rk.py:303-409``): one
    composition step of dt against two of dt / 2, their difference over
    2^p - 1 the error estimate; the half-step solution is kept.  Returns
    ``((us, vs), num_force_evals)``, time-leading."""
    _check_nystrom(method)
    order = _NYSTROM_ORDERS[method]
    u0, du0 = torch.as_tensor(u0), torch.as_tensor(du0)
    dtype, device = u0.dtype, u0.device
    save_at = torch.as_tensor(save_at, dtype=dtype, device=device)
    batch = u0.shape[:-1]
    f = _mapped(vf2, params)
    step, evals = _nystrom_step(method, f)
    deflate = 2.0**order - 1.0
    tiny = float(torch.finfo(dtype).tiny)

    def attempt(s: _NystromState, t_stop):
        dt = torch.minimum(s.dt, t_stop - s.t)
        u1, v1, _a1 = step(s.u, s.v, s.a, s.t, dt)
        uh, vh, ah = step(s.u, s.v, s.a, s.t, 0.5 * dt)
        u2, v2, a2 = step(uh, vh, ah, s.t + 0.5 * dt, 0.5 * dt)
        u_d, v_d, u2_d, v2_d = (x.detach() for x in (s.u, s.v, u2, v2))
        err_u = (u2_d - u1.detach()) / deflate
        err_v = (v2_d - v1.detach()) / deflate
        tol_u = _tol(atol, u_d) + _tol(rtol, u_d) * torch.maximum(torch.abs(u_d), torch.abs(u2_d))
        tol_v = _tol(atol, v_d) + _tol(rtol, v_d) * torch.maximum(torch.abs(v_d), torch.abs(v2_d))
        sq = torch.cat([err_u / tol_u, err_v / tol_v], dim=-1)
        errn = rounded.sqrt(torch.mean(sq**2, dim=-1) + tiny)
        errn = torch.where(torch.isfinite(errn), errn, torch.full_like(errn, float("inf")))
        dt_next = _controller(errn, s.errn_prev, order, s.dt)
        accept = (errn <= 1.0) | _stalled(dt, s.t)
        accepted = _NystromState(t=s.t + dt, u=u2, v=v2, a=a2, dt=dt_next,
                                 errn_prev=torch.clamp(errn, min=tiny),
                                 num_steps=s.num_steps + 3 * evals)
        rejected = s._replace(dt=dt_next, num_steps=s.num_steps + 3 * evals)
        return control_flow.tree_select(accept, accepted, rejected)

    def full(value, dt=dtype):
        return torch.full(batch, value, dtype=dt, device=device)

    s = _NystromState(t=save_at[0].expand(batch), u=u0, v=du0, a=f(u0, save_at[0]),
                      dt=full(float(dt0)), errn_prev=full(1.0),
                      num_steps=full(1, torch.int32))  # the FSAL seed evaluation
    us, vs = [u0], [du0]
    for t_next in save_at[1:].unbind(0):
        s = control_flow.while_loop(lambda st, t_next=t_next: st.t < t_next,
                                    lambda st, t_next=t_next: attempt(st, t_next), s)
        us.append(s.u)
        vs.append(s.v)
    return (torch.stack(us), torch.stack(vs)), s.num_steps


def solve_nystrom_fixed(method: str, vf2, u0, du0, *, grid, params=()):
    """Fixed-grid symplectic Nystrom solve (no step control) over ``grid``
    (``odecheckpts_tpu/rk.py:418-485``); returns ``(us, vs)``,
    time-leading."""
    _check_nystrom(method)
    u0, du0 = torch.as_tensor(u0), torch.as_tensor(du0)
    grid = torch.as_tensor(grid, dtype=u0.dtype, device=u0.device)
    batch = u0.shape[:-1]
    f = _mapped(vf2, params)
    step, _evals = _nystrom_step(method, f)
    u, v, a = u0, du0, f(u0, grid[0])
    us, vs = [u0], [du0]
    for t_new, dt in zip(grid[1:].unbind(0), torch.diff(grid).unbind(0)):
        u, v, a = step(u, v, a, (t_new - dt).expand(batch), dt.expand(batch))
        us.append(u)
        vs.append(v)
    return torch.stack(us), torch.stack(vs)
