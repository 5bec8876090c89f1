"""Two-stage solve factories (PyTorch counterpart of ``odecheckpts_tpu.facade``).

Each factory is configure-once / run-many: it returns a closure
``solve_(u0_tuple, p[, output_scale]) -> (qoi, aux)`` that runs on the
device of ``u0``'s tensors and accepts leading batch axes on them (the
reference ``vmap``s its closures instead).  ``vf(*u, t=, p=)`` is the
one-IVP vector field; ``p`` may be a tensor, a tuple or a list of
``(w, b)`` layers, and gradients reach it through the solve.

    solve                 fixedpoint + ``solve_adaptive_save_at`` + backward
                          marginalization: O(#save_at) memory
    solve_via_interpolate smoother + save-every-step + off-grid marginals
    solve_rk              adaptive Runge-Kutta (alias ``solve_diffrax``)
    solve_nystrom         adaptive Nystrom for u'' = f(u, t)
    asolve_scipy          ``scipy.integrate.solve_ivp`` on the host

Outputs are time-leading, then the batch axes.  ``ode_order=2`` raises
``NotImplementedError`` (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import numpy as np
import torch

from . import ivpsolve, ivpsolvers, rk, stats, taylor


def _parse_method(method: str):
    """``'ts0-4'`` -> ``('ts0', 4)``."""
    family, num = method.rsplit("-", 1)
    if family not in ("ts0", "ts1"):
        raise ValueError(f"unknown correction family in {method!r}")
    return family, int(num)


def _check_tuple(u0):
    if not isinstance(u0, tuple):
        raise ValueError("Tuple expected.")


def _second_order(ode_order):
    if ode_order != 1:
        raise NotImplementedError(
            "ode_order != 1 is not ported yet: ROADMAP queue 1 item 5")


def _taylor_init(solver, vf_wrapped, u0, t0, num, output_scale):
    """The exact initial state from the Taylor coefficients of ``u0``; the
    one-IVP field is mapped over the batch axes (``ivpsolvers._call_vf``)."""
    u0 = tuple(torch.as_tensor(u) for u in u0)
    t0 = torch.as_tensor(t0, dtype=u0[0].dtype, device=u0[0].device)

    def vf_auto(*y):
        return ivpsolvers._call_vf(vf_wrapped, y, t0)

    tcoeffs = taylor.odejet_padded_scan(vf_auto, u0, num=num)
    return solver.initial_condition(tcoeffs, output_scale=output_scale)


def solve(method: str, vf, u0_like, /, save_at, *, dt0, atol, rtol, ode_order: int = 1,
          calibrate: str = "dynamic", implementation: str = "isotropic",
          error_unit: str = "qoi", error_calibration: float = None):
    """Checkpointed adaptive solve, O(#save_at) memory (``odecheckpts_tpu/
    facade.py:38-119``): the fixedpoint strategy on ``save_at``, then the
    backward marginalization; returns the smoothed qoi (T, ..., d) and
    ``{"solution", "u0_solve"}``."""
    _second_order(ode_order)
    family, num_derivatives = _parse_method(method)
    prior = ivpsolvers.prior_ibm(num_derivatives=num_derivatives,
                                 ode_shape=tuple(np.shape(u0_like)),
                                 implementation=implementation)
    make = ivpsolvers.correction_ts0 if family == "ts0" else ivpsolvers.correction_ts1
    correction = make(ode_order=ode_order, error_unit=error_unit,
                      error_calibration=error_calibration)
    strategy = ivpsolvers.strategy_fixedpoint(prior, correction)
    solvers = {"dynamic": ivpsolvers.solver_dynamic, "none": ivpsolvers.solver,
               "mle": ivpsolvers.solver_mle}
    if calibrate not in solvers:
        raise ValueError(f"unknown calibration {calibrate!r}")
    solver = solvers[calibrate](strategy)
    asolver = ivpsolve.adaptive(solver, atol=atol, rtol=rtol,
                                control=ivpsolve.control_proportional_integral())
    ssm = solver.ssm

    def solve_(u0: tuple, p, output_scale=1.0):
        _check_tuple(u0)

        def vf_wrapped(*y, t):
            return vf(*y, t=t, p=p)

        like = torch.as_tensor(u0[0])
        save_at_t = torch.as_tensor(save_at, dtype=like.dtype, device=like.device)
        init = _taylor_init(solver, vf_wrapped, u0, save_at_t[0],
                            num_derivatives + 1 - ode_order, output_scale)
        sol = ivpsolve.solve_adaptive_save_at(vf_wrapped, init, save_at=save_at_t, dt0=dt0,
                                              adaptive_solver=asolver)
        # backward marginalization; the terminal state goes at the end
        margs = stats.markov_marginals(stats.markov_select_terminal(sol.posterior), reverse=True)
        mean = torch.cat([margs.mean, sol.posterior.init.mean[-1:]])
        return ssm.qoi_from_sample(mean), {"solution": sol, "u0_solve": sol.u}

    return solve_


def solve_via_interpolate(method: str, vf, u0_like, /, save_at, *, dt0, atol, rtol):
    """Smoother + save-every-step + searchsorted interpolation, O(#steps)
    memory (``odecheckpts_tpu/facade.py:122-160``).  The save-every-step
    driver solves one IVP, so an ensemble is solved lane by lane: the qoi
    is stacked to (T, ..., d), ``aux["solution"]`` is then a list of the
    lanes' solutions and ``aux["u0_solve"]`` the list of their values."""
    small_value = 1e-6
    family, num_derivatives = _parse_method(method)
    if family != "ts0":
        raise ValueError("solve_via_interpolate supports ts0 only")
    prior = ivpsolvers.prior_ibm(num_derivatives=num_derivatives,
                                 ode_shape=tuple(np.shape(u0_like)))
    strategy = ivpsolvers.strategy_smoother(prior, ivpsolvers.correction_ts0())
    solver = ivpsolvers.solver_dynamic(strategy)
    asolver = ivpsolve.adaptive(solver, atol=atol, rtol=rtol,
                                control=ivpsolve.control_proportional_integral())

    def one(u0, vf_wrapped, output_scale):
        like = u0[0]
        save_at_t = torch.as_tensor(save_at, dtype=like.dtype, device=like.device)
        init = _taylor_init(solver, vf_wrapped, u0, save_at_t[0], num_derivatives,
                            output_scale)
        # a small pad so that every save_at value is interior
        sol = ivpsolve.solve_adaptive_save_every_step(
            vf_wrapped, init, t0=save_at_t[0] - small_value, t1=save_at_t[-1] + small_value,
            dt0=dt0, adaptive_solver=asolver)
        dense, _ = stats.offgrid_marginals_searchsorted(ts=save_at_t, solution=sol,
                                                        solver=solver)
        return dense, sol

    def solve_(u0: tuple, p, output_scale=1.0):
        _check_tuple(u0)

        def vf_wrapped(*y, t):
            return vf(*y, t=t, p=p)

        u0 = tuple(torch.as_tensor(u) for u in u0)
        batch = u0[0].shape[:-1]
        if not batch:
            dense, sol = one(u0, vf_wrapped, output_scale)
            return dense, {"solution": sol, "u0_solve": sol.u}
        lanes = [one(tuple(u.reshape((-1, u.shape[-1]))[i] for u in u0), vf_wrapped,
                     output_scale) for i in range(int(np.prod(batch)))]
        dense = torch.stack([d for d, _ in lanes], dim=1)
        sols = [s for _, s in lanes]
        return (dense.reshape(dense.shape[:1] + batch + dense.shape[2:]),
                {"solution": sols, "u0_solve": [s.u for s in sols]})

    return solve_


def solve_rk(method: str, vf, _u0_like, /, save_at, *, dt0, atol, rtol, ode_order=1):
    """Adaptive Runge-Kutta baseline with the reference's diffrax signature
    (``odecheckpts_tpu/facade.py:163-183``): ``solve_(u0_tuple, p)`` returns
    the states at ``save_at`` (T, ..., d) and ``{"solution", "u0_solve",
    "num_steps"}``."""
    _second_order(ode_order)

    def solve_(u0: tuple, p):
        _check_tuple(u0)
        (init,) = u0
        ys, num_steps = rk.solve_rk_save_at(method, vf, init, save_at=save_at, dt0=dt0,
                                            atol=atol, rtol=rtol, params=p)
        return ys, {"solution": ys, "u0_solve": ys, "num_steps": num_steps}

    return solve_


# the reference names this factory after diffrax
solve_diffrax = solve_rk


def solve_nystrom(method: str, vf2, _u0_like, /, save_at, *, dt0, atol, rtol):
    """Nystrom baseline for ``u'' = vf2(u, t=, p=)`` (position-only force):
    ``u0`` is ``(position, velocity)``; returns the positions at
    ``save_at`` (``odecheckpts_tpu/facade.py:191-212``)."""

    def solve_(u0: tuple, p):
        _check_tuple(u0)
        pos0, vel0 = u0
        (us, vs), num_evals = rk.solve_nystrom_save_at(
            method, vf2, pos0, vel0, save_at=save_at, dt0=dt0, atol=atol, rtol=rtol, params=p)
        return us, {"solution": (us, vs), "u0_solve": us, "num_steps": num_evals}

    return solve_


def asolve_scipy(method: str, vf, /, time_span, *, atol, rtol):
    """Ground-truth trajectories by ``scipy.integrate.solve_ivp`` on the host
    CPU, one IVP (``odecheckpts_tpu/facade.py:215-236``): returns
    ``(ts, ys)`` as numpy arrays."""
    import scipy.integrate

    def solve_(u0: tuple, p):
        _check_tuple(u0)
        (y0,) = u0
        y0 = np.asarray(torch.as_tensor(y0).detach().cpu())

        def vf_scipy(t, y):
            with torch.no_grad():
                return np.asarray(torch.as_tensor(vf(torch.as_tensor(y), t=t, p=p)).cpu())

        solution = scipy.integrate.solve_ivp(vf_scipy, y0=y0, t_span=time_span, atol=atol,
                                             rtol=rtol, method=method)
        return solution.t, solution.y.T

    return solve_
