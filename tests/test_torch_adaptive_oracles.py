"""Port oracles of the adaptive single solve (the torch forms of the
reference's ``tests/test_solve.py``, ``test_bounded_driver.py``,
``test_error_units.py``, ``test_calibration.py`` and
``test_full_precision_guard.py`` tests) and the fused twins against the
port's own generic solve (the torch forms of ``tests/test_batched.py:22,
382``, ``tests/test_batched_dense.py:60`` and
``tests/test_batched_blockdiag.py:27``), all in float64 on the CPU.  No JAX
here beyond the shared helpers of ``test_torch_adaptive``.
"""

import numpy as np
import pytest
import scipy.integrate
import torch

from odecheckpts_torch import batched as tbatched
from odecheckpts_torch import ivpsolve as tivpsolve
from odecheckpts_torch import ivpsolvers as tsolvers
from odecheckpts_torch import problems as tproblems
from odecheckpts_torch import stats as tstats
from odecheckpts_torch import taylor as ttaylor
from odecheckpts_torch.ssm.base import Normal as TNormal
from test_torch_adaptive import (_every_step_setup, _logistic_exact, _logistic_init, _rigid,
                                 _solver, _u0s)


@pytest.mark.parametrize("impl", ["isotropic", "dense"])
@pytest.mark.parametrize("calibrate", ["dynamic", "none", "mle"])
def test_save_at_fixedpoint_matches_closed_form(impl, calibrate):
    """Torch form of the reference's test of the same name: filtered and
    smoothed checkpoint values within rtol 1e-5 of the closed form; the
    solution scales with the checkpoints only."""
    solver = _solver(tsolvers, "fixedpoint", impl=impl, nu=3, d=1, calibrate=calibrate)
    vf, init, tspan = _logistic_init(solver, 3)
    save_at = np.linspace(*tspan, 7)
    sol = tivpsolve.solve_adaptive_save_at(
        vf, init, save_at=save_at, dt0=0.1,
        adaptive_solver=tivpsolve.adaptive(solver, atol=1e-8, rtol=1e-8))
    np.testing.assert_allclose(sol.u.numpy()[:, 0], _logistic_exact(save_at), rtol=1e-5)
    seq = tstats.markov_select_terminal(sol.posterior)
    margs = tstats.markov_marginals(seq, reverse=True)
    mean = torch.cat([margs.mean, sol.posterior.init.mean[-1:]])
    np.testing.assert_allclose(sol.ssm.qoi(mean).numpy()[:, 0], _logistic_exact(save_at),
                               rtol=1e-5)
    assert sol.u.shape[0] == 7 and sol.posterior.init.mean.shape[0] == 7
    # the quickstart's terminal value (u(2.5) ~ 0.5751)
    assert abs(float(sol.u[-1, 0]) - 0.5751) < 1e-4


def test_mle_calibration_equals_rms_of_step_sigmas():
    """Torch form of the reference's test: the MLE output scale is the RMS
    of the per-step sigma-hats, recomputed independently from the
    uncalibrated run's stored states (rtol 5e-3: the terminal overshoot the
    driver interpolates away is not shared), and the MLE posterior is the
    uncalibrated one with every factor times it (rtol 1e-9)."""
    vf = _rigid(tproblems, (0.0, 10.0))
    nu = 3
    u0 = torch.tensor([1.0, 0.0, 0.9], dtype=torch.float64)
    prior = tsolvers.prior_ibm(num_derivatives=nu, ode_shape=(3,))
    strat = tsolvers.strategy_smoother(prior, tsolvers.correction_ts0())

    def run(make_solver):
        solver = make_solver(strat)
        tc = ttaylor.odejet_padded_scan(lambda u: vf(u, t=0.0), (u0,), num=nu)
        init = solver.initial_condition(tc, 1.0)
        return tivpsolve.solve_adaptive_save_every_step(
            vf, init, t0=0.0, t1=10.0, dt0=0.1,
            adaptive_solver=tivpsolve.adaptive(solver, atol=1e-6, rtol=1e-6))

    sol_none, sol_mle = run(tsolvers.solver), run(tsolvers.solver_mle)
    np.testing.assert_array_equal(sol_mle.t.numpy(), sol_none.t.numpy())
    np.testing.assert_allclose(sol_mle.u.numpy(), sol_none.u.numpy(), rtol=1e-12)
    means = sol_none.posterior.init.mean
    m_pred, cache = prior.extrapolate_mean(means[:-1], torch.diff(sol_none.t))
    z, jacs = tsolvers.linearize(strat, vf, m_pred, sol_none.t[1:])
    sigmas, _ = tsolvers.error_and_scale(strat, z, jacs, cache)
    rms = float(torch.sqrt(torch.mean(sigmas**2)))
    factor = float(sol_mle.output_scale[0])
    np.testing.assert_allclose(factor, rms, rtol=5e-3)
    np.testing.assert_allclose(sol_mle.u_std.numpy(), sol_none.u_std.numpy() * factor, rtol=1e-9)
    np.testing.assert_allclose(sol_mle.posterior.init.cholesky.numpy(),
                               sol_none.posterior.init.cholesky.numpy() * factor,
                               rtol=1e-9, atol=1e-300)


def test_vmap_over_tolerances():
    """Torch form: one batched solve over three tolerances (the batch from
    the tolerances, the init shared): each within 10 sqrt(tol) of the closed
    form, the tightest the most steps; and each lane equal to its own
    one-IVP solve bit for bit."""
    solver = _solver(tsolvers, "fixedpoint", nu=3, d=1)
    vf, init, tspan = _logistic_init(solver, 3)
    save_at = np.linspace(*tspan, 5)
    tols = torch.tensor([1e-3, 1e-5, 1e-7], dtype=torch.float64)
    sol = tivpsolve.solve_adaptive_save_at(
        vf, init, save_at=save_at, dt0=0.1,
        adaptive_solver=tivpsolve.adaptive(solver, atol=1e-3 * tols, rtol=tols))
    us = sol.u.movedim(1, 0).numpy()
    assert us.shape == (3, 5, 1)
    for i, tol in enumerate(tols.tolist()):
        np.testing.assert_allclose(us[i, :, 0], _logistic_exact(save_at), rtol=10 * tol**0.5)
        one = tivpsolve.solve_adaptive_save_at(
            vf, init, save_at=save_at, dt0=0.1,
            adaptive_solver=tivpsolve.adaptive(solver, atol=1e-3 * tol, rtol=tol))
        np.testing.assert_array_equal(one.u.numpy(), us[i])
        np.testing.assert_array_equal(one.num_steps.numpy(), sol.num_steps[:, i].numpy())
    assert int(sol.num_steps[-1, 2]) > int(sol.num_steps[-1, 0])


def test_bounded_matches_eager_save_every_step():
    """Torch form: the bounded driver's valid entries are the eager driver's
    accepted steps (equal here: one package, one arithmetic)."""
    vf, init, (t0, t1), asolver = _every_step_setup(tproblems)
    eager = tivpsolve.solve_adaptive_save_every_step(
        vf, init, t0=t0, t1=t1, dt0=0.1, adaptive_solver=asolver)
    bounded, (valid, _) = tivpsolve.solve_adaptive_save_every_step_bounded(
        vf, init, t0=t0, t1=t1, dt0=0.1, adaptive_solver=asolver, max_steps=256)
    ts_b, us_b = bounded.t[valid].numpy(), bounded.u[valid].numpy()
    n = min(len(eager.t) - 1, len(ts_b))
    assert n > 10
    np.testing.assert_allclose(ts_b[:n], eager.t.numpy()[:n], rtol=1e-8)
    np.testing.assert_allclose(us_b[:n], eager.u.numpy()[:n], rtol=1e-6)


def test_compact_bounded_solution():
    vf, init, (t0, t1), asolver = _every_step_setup(tproblems)
    sol_b, (valid, _) = tivpsolve.solve_adaptive_save_every_step_bounded(
        vf, init, t0=t0, t1=t1, dt0=0.1, adaptive_solver=asolver, max_steps=256)
    sol_c = tivpsolve.compact_bounded_solution(sol_b, valid)
    sol_e = tivpsolve.solve_adaptive_save_every_step(
        vf, init, t0=t0, t1=t1, dt0=0.1, adaptive_solver=asolver)
    n = min(len(sol_c.t), len(sol_e.t) - 1)
    np.testing.assert_allclose(sol_c.t.numpy()[:n], sol_e.t.numpy()[:n], rtol=1e-8)
    np.testing.assert_allclose(sol_c.u.numpy()[:n], sol_e.u.numpy()[:n], rtol=1e-6)
    assert sol_c.posterior.init.mean.shape[0] == len(sol_c.t)
    assert sol_c.posterior.conditional.matrix.shape[0] == len(sol_c.t)
    with pytest.raises(ValueError, match="one IVP"):
        tivpsolve.compact_bounded_solution(sol_b, valid[:, None].expand(-1, 2))


def test_eager_every_step_refuses_an_ensemble():
    solver = _solver(tsolvers, "smoother", nu=3, d=1)
    vf, init, tspan = _logistic_init(solver, 3)
    batched = (TNormal(init[0].mean.expand(2, -1, -1), init[0].cholesky.expand(2, -1, -1)),
               init[1])
    with pytest.raises(ValueError, match="bounded"):
        tivpsolve.solve_adaptive_save_every_step(
            vf, batched, t0=0.0, t1=1.0, dt0=0.1,
            adaptive_solver=tivpsolve.adaptive(solver, atol=1e-6, rtol=1e-6))


def test_residual_mode_takes_more_steps_and_agrees():
    """Torch form (the reference's runs through ``facade``, queue 1 item 6:
    here ``solve_adaptive_save_at`` and the smoothing pass): the residual
    unit takes more steps, both agree to rtol 1e-3, residual within 1e-4 of
    the closed form."""
    def run(unit, tol=1e-5):
        solver = _solver(tsolvers, "fixedpoint", nu=3, d=1, unit=unit)
        vf, init, tspan = _logistic_init(solver, 3)
        save_at = np.linspace(*tspan, 5)
        sol = tivpsolve.solve_adaptive_save_at(
            vf, init, save_at=save_at, dt0=0.1,
            adaptive_solver=tivpsolve.adaptive(solver, atol=1e-3 * tol, rtol=tol))
        return _smoothed(sol), int(sol.num_steps[-1]), save_at

    u_q, n_q, _ = run("qoi")
    u_r, n_r, save_at = run("residual")
    assert n_r > n_q
    np.testing.assert_allclose(u_q, u_r, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(u_r[:, 0], _logistic_exact(save_at), rtol=1e-4)


def _smoothed(sol):
    """The facade's output: backward marginals at the checkpoints, the
    terminal state stacked on (time-leading; batch axes after)."""
    seq = tstats.markov_select_terminal(sol.posterior)
    margs = tstats.markov_marginals(seq, reverse=True)
    mean = torch.cat([margs.mean, sol.posterior.init.mean[-1:]])
    return sol.ssm.qoi(mean).numpy()


def _rigid_truth(u0, save_at):
    p1, p2, p3 = -2.0, 1.25, -0.5
    return scipy.integrate.solve_ivp(
        lambda _t, y: [p1 * y[1] * y[2], p2 * y[0] * y[2], p3 * y[0] * y[1]],
        y0=np.asarray(u0), t_span=(save_at[0], save_at[-1]), t_eval=save_at,
        rtol=1e-12, atol=1e-12, method="LSODA").y.T


@pytest.mark.parametrize("rtol", [1e-3, 1e-6, pytest.param(1e-9, marks=pytest.mark.slow)])
def test_rigid_body_rmse_tracks_rtol(rtol):
    """Torch form (``ivpsolve`` directly; the reference's runs through
    ``facade``): TS0(4) fixedpoint, smoothed values on (0, 50) within 1.5 rtol
    (RMSE) of LSODA(1e-12)."""
    solver = _solver(tsolvers, "fixedpoint")
    vf = _rigid(tproblems, (0.0, 50.0))
    u0 = torch.tensor([1.0, 0.0, 0.9], dtype=torch.float64)
    save_at = np.linspace(0.0, 50.0, 5)
    tc = ttaylor.odejet_padded_scan(lambda u: vf(u, t=0.0), (u0,), num=4)
    sol = tivpsolve.solve_adaptive_save_at(
        vf, solver.initial_condition(tc, 1.0), save_at=save_at, dt0=0.1,
        adaptive_solver=tivpsolve.adaptive(solver, atol=1e-3 * rtol, rtol=rtol))
    truth = _rigid_truth(u0.numpy(), save_at)
    rmse = float(np.sqrt(np.mean((_smoothed(sol)[1:] - truth[1:]) ** 2)))
    assert rmse < 1.5 * rtol, f"rmse={rmse:.3e} at rtol={rtol:.0e}"


def test_full_precision_guard_sets_and_restores_matmul_precision():
    """Torch counterpart of ``tests/test_full_precision_guard.py``: every
    public solve driver carries the guard, and the guard runs the solve at
    "highest" float32 matmul precision and restores the caller's setting."""
    drivers = [n for n in dir(tivpsolve) if n.startswith("solve_")
               and callable(getattr(tivpsolve, n))]
    assert {"solve_adaptive_save_at", "solve_adaptive_terminal_values",
            "solve_adaptive_save_every_step", "solve_adaptive_save_every_step_bounded",
            "solve_adaptive_parallel_in_time", "solve_fixed_grid"} <= set(drivers)
    missing = [n for n in drivers if not getattr(getattr(tivpsolve, n), "__full_precision__",
                                                 False)]
    assert not missing, missing
    seen = {}

    @tivpsolve._full_precision
    def probe():
        seen["inside"] = torch.get_float32_matmul_precision()

    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        probe()
        assert seen["inside"] == "highest"
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)


def test_forced_accept_at_the_time_resolution():
    """A lane whose step falls below 4 eps max(|t|, 1) is accepted whatever
    its error (the loop stays total), as in the reference's ``_make_step``."""
    solver = _solver(tsolvers, "filter", nu=3, d=1)
    vf, init, _ = _logistic_init(solver, 3)
    asolver = tivpsolve.adaptive(solver, atol=1e-300, rtol=1e-300)
    state = tivpsolve._init_state(asolver, init, 1e6, 3e-10)
    step = tivpsolve._make_step(vf, asolver, init[1])
    new = step(state)
    assert int(new.num_steps) == 1 and float(new.t) > 1e6


# -- fused twins against the port's generic solve ------------------------------


def _generic_save_at(vf, u0s, params_vf, save_at, tols, *, nu=4, impl="isotropic",
                     method="ts0", dt0=0.1):
    """The reference's ``build_batched_solve`` / ``facade.solve`` path in the
    port: Taylor init, fixedpoint dynamic save_at at atol 1e-3 rtol, the
    smoothing pass; smoothed values (B, T, d) and final step counts."""
    d = u0s.shape[1]
    solver = _solver(tsolvers, "fixedpoint", impl=impl, nu=nu, method=method, d=d)
    tc = ttaylor.odejet_padded_scan(lambda u: params_vf(u, t=save_at[0]), (u0s.T,), num=nu)
    init = solver.initial_condition([c.T for c in tc], 1.0)
    sol = tivpsolve.solve_adaptive_save_at(
        vf, init, save_at=save_at, dt0=dt0,
        adaptive_solver=tivpsolve.adaptive(solver, atol=1e-3 * tols, rtol=tols))
    return np.moveaxis(_smoothed(sol), 1, 0), sol.num_steps[-1].numpy()


@pytest.mark.parametrize("nu", [4, 3])
def test_fused_twin_matches_generic_solver(nu):
    """Torch forms of ``test_xla_engine_matches_generic_vmapped_solver``
    (fixedpoint; the fused filter is ROADMAP queue 1 item 5) and of
    ``test_nondefault_order_matches_generic``: the isotropic twin
    (``engine="torch"``) against the generic solve, 8 lanes at rtol 1e-4 /
    1e-6, f64: values to rtol 1e-7 (nu = 4) / 1e-5 (nu = 3), final step
    counts to rtol 0.05 / 0.10, the reference's bounds."""
    vf_p, _, _, params = tproblems.rigid_body()
    save_at = np.linspace(0.0, 10.0, 5)
    u0s = torch.tensor(_u0s(8))
    tols = torch.tensor(np.tile([1e-4, 1e-6], 4))
    u_s, _u_f, nsteps = tbatched.solve_save_at_batched(
        vf_p, u0s, params, save_at=save_at, dt0=0.1, tols=tols, num_derivatives=nu,
        engine="torch")
    vf = _rigid(tproblems)
    u_ref, steps_ref = _generic_save_at(vf, u0s, lambda u, t: vf_p(u, t=t, p=params),
                                        save_at, tols, nu=nu)
    rtol_u, rtol_n = (1e-7, 0.05) if nu == 4 else (1e-5, 0.10)
    np.testing.assert_allclose(u_s.numpy(), u_ref, rtol=rtol_u, atol=1e-10)
    np.testing.assert_allclose(nsteps[:, -1].numpy(), steps_ref, rtol=rtol_n)


def test_fused_dense_ts1_matches_generic_solver():
    """Torch form of ``test_dense_ts1_vdp_as_system_matches_generic``: Van der
    Pol (mu = 10) as a d = 2 system, TS1(4) on the dense backend, the dense
    twin against the generic solve: values rtol 2e-4, steps rtol 0.05."""
    mu = 10.0

    def vf(y, *, t, p=()):
        return torch.stack([y[1], mu * ((1.0 - y[0] ** 2) * y[1]) - y[0]])

    save_at = np.linspace(0.0, 3.0, 4)
    u0s = torch.tensor([[2.0, 0.0], [1.9, 0.1], [2.1, -0.1], [2.0, 0.2]], dtype=torch.float64)
    tols = torch.full((4,), 1e-6, dtype=torch.float64)
    u_s, _u_f, n_fus = tbatched.solve_save_at_batched(
        vf, u0s, (), save_at=save_at, dt0=0.01, tols=tols, correction="ts1",
        implementation="dense", engine="torch")
    u_ref, n_ref = _generic_save_at(vf, u0s, lambda u, t: vf(u, t=t), save_at, tols,
                                    impl="dense", method="ts1", dt0=0.01)
    np.testing.assert_allclose(u_s.numpy(), u_ref, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(n_fus[:, -1].numpy().astype(float), n_ref.astype(float),
                               rtol=0.05)


def test_fused_blockdiag_matches_generic_solver():
    """Torch form of ``test_blockdiag_xla_engine_matches_generic_vmapped``:
    the blockdiag twin against the generic blockdiag solve, 4 lanes at tol
    1e-4..1e-6, f64: values rtol 1e-4, final steps rtol 0.05."""
    vf_p, _, _, params = tproblems.rigid_body()
    save_at = np.linspace(0.0, 10.0, 5)
    u0s = torch.tensor(_u0s(4))
    tols = torch.tensor([1e-4, 1e-5, 1e-6, 1e-4])
    u_s, _u_f, n_fus = tbatched.solve_save_at_batched(
        vf_p, u0s, params, save_at=save_at, dt0=0.1, tols=tols, implementation="blockdiag",
        engine="torch")
    vf = _rigid(tproblems)
    u_ref, n_ref = _generic_save_at(vf, u0s, lambda u, t: vf_p(u, t=t, p=params), save_at,
                                    tols, impl="blockdiag")
    np.testing.assert_allclose(u_s.numpy(), u_ref, rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(n_fus[:, -1].numpy().astype(float), n_ref.astype(float),
                               rtol=0.05)
