"""Port differential tests of the adaptive single solve (``ivpsolve``'s
adaptive drivers, ``solver_mle``) against the JAX reference.  The oracles of
the reference's own tests and the fused twins against the generic solve are
in ``test_torch_adaptive_oracles.py``.

The same numpy inputs (the reference's Taylor init, numpy-seeded initial
values) go through both packages.  The port solves an ensemble with its
batch axes written out; the reference ``vmap``s its one-IVP driver.  In
float64 the per-lane step counts are equal and the checkpoint values agree
to rtol 1e-10 (the two packages differ only by matmul and QR rounding);
covariance factors are compared through L L^T.  The every-step drivers'
grids are compared to rtol 1e-6: the step-size controller reads an error
estimate whose last bits are rounding, so the accepted times of the two
packages drift apart by about 1e-8 relative over a few hundred steps while
the values at the checkpoints (which the drift moves only by the local
error times it) stay at rtol 1e-10.  Blockdiag runs at tol <= 1e-6: at
1e-4..1e-5 its per-dimension sigma amplifies the last bit and the reference
moves against itself (ROADMAP section 3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import ivpsolve as jivpsolve
from odecheckpts_tpu import ivpsolvers as jsolvers
from odecheckpts_tpu import problems as jproblems
from odecheckpts_tpu import taylor as jtaylor
from odecheckpts_torch import interop
from odecheckpts_torch import ivpsolve as tivpsolve
from odecheckpts_torch import ivpsolvers as tsolvers
from odecheckpts_torch import problems as tproblems
from odecheckpts_torch import taylor as ttaylor

TOLS = np.array([1e-4, 1e-6, 1e-5, 1e-7])


def _strategy(lib, kind):
    return {"filter": lib.strategy_filter, "smoother": lib.strategy_smoother,
            "fixedpoint": lib.strategy_fixedpoint}[kind]


def _solver(lib, kind="fixedpoint", *, impl="isotropic", nu=4, method="ts0", d=3,
            calibrate="dynamic", unit="qoi"):
    prior = lib.prior_ibm(num_derivatives=nu, ode_shape=(d,), implementation=impl)
    corr = (lib.correction_ts0 if method == "ts0" else lib.correction_ts1)(error_unit=unit)
    strat = _strategy(lib, kind)(prior, corr)
    return {"dynamic": lib.solver_dynamic, "none": lib.solver, "mle": lib.solver_mle}[
        calibrate](strat)


def _rigid(lib, tspan=(0.0, 10.0)):
    vf_p, _, _, params = lib.rigid_body(time_span=tspan)
    return lambda u, *, t: vf_p(u, t=t, p=params)


def _logistic(lib):
    vf_p, (u0,), tspan, params = lib.logistic()
    return (lambda u, *, t: vf_p(u, t=t, p=params)), u0, tspan


def _u0s(batch, seed=0):
    rng = np.random.default_rng(seed)
    return np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((batch, 3)))


def _inits(jsolver, jvf, u0s, nu, t0=0.0, scale=1.0):
    """The reference's Taylor init of every lane (vmapped), as the reference's
    arrays and as the port's tensors."""
    def one(u0):
        tc = jtaylor.odejet_padded_scan(lambda u: jvf(u, t=t0), (u0,), num=nu)
        return jsolver.initial_condition(tc, scale)[0]

    rv = jax.vmap(one)(jnp.asarray(u0s)) if u0s.ndim == 2 else one(jnp.asarray(u0s))
    as_np = ((np.asarray(rv.mean), np.asarray(rv.cholesky)), np.asarray(scale, np.float64))
    return (rv, jnp.asarray(scale, jnp.float64)), interop.init_to_torch(as_np)


def _np(x, batched=False):
    """A port output as numpy, the batch axis first (the reference's vmap)."""
    x = x.numpy()
    return np.moveaxis(x, 1, 0) if batched and x.ndim > 1 else x


def _close(got, want, rtol):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _gram(x):
    x = np.asarray(x)
    return x @ np.swapaxes(x, -1, -2)


def _assert_solutions_match(tsol, jsol, rtol=1e-10, rtol_scaled=1e-5, batched=True):
    """Per-lane step counts equal, the values ``u`` to ``rtol``; what scales
    with the step sigmas (the output scales, ``u_std``, the stacked means'
    higher derivatives, the Grams of the factors and the conditionals) to
    ``rtol_scaled``: a sigma is the norm of a residual that cancels down to
    the local error (1e-8 of the state at these tolerances), so its relative
    rounding is about 1e-8 and the covariance algebra carries that on
    (observed up to 1.2e-6 on the fixedpoint gains)."""
    np.testing.assert_array_equal(_np(tsol.num_steps, batched), np.asarray(jsol.num_steps))
    _close(_np(tsol.u, batched), jsol.u, rtol)
    for got, want in ((tsol.u_std, jsol.u_std), (tsol.output_scale, jsol.output_scale),
                      (tsol.posterior.init.mean, jsol.posterior.init.mean)):
        _close(_np(got, batched), want, rtol_scaled)
    _close(_gram(_np(tsol.posterior.init.cholesky, batched)),
           _gram(jsol.posterior.init.cholesky), rtol_scaled)
    if jsol.posterior.conditional is None:
        assert tsol.posterior.conditional is None
        return
    tc, jc = tsol.posterior.conditional, jsol.posterior.conditional
    _close(_np(tc.matrix, batched), jc.matrix, rtol_scaled)
    _close(_np(tc.noise.mean, batched), jc.noise.mean, rtol_scaled)
    _close(_gram(_np(tc.noise.cholesky, batched)), _gram(jc.noise.cholesky), rtol_scaled)


@functools.lru_cache(maxsize=None)
def _save_at_pair(kind, impl, method, tols, tspan, calibrate="dynamic", nu=4):
    """The rigid-body ensemble (4 lanes, numpy seed 0) through both packages'
    ``solve_adaptive_save_at``, atol 1e-3 rtol, 5 checkpoints."""
    tols = np.asarray(tols)
    save_at = np.linspace(*tspan, 5)
    jsolver = _solver(jsolvers, kind, impl=impl, method=method, calibrate=calibrate, nu=nu)
    tsolver = _solver(tsolvers, kind, impl=impl, method=method, calibrate=calibrate, nu=nu)
    jvf, tvf = _rigid(jproblems, tspan), _rigid(tproblems, tspan)
    u0s = _u0s(len(tols))
    jinit, tinit = _inits(jsolver, jvf, u0s, nu)

    def solve_one(mean, chol, tol):
        asolver = jivpsolve.adaptive(jsolver, atol=1e-3 * tol, rtol=tol)
        return jivpsolve.solve_adaptive_save_at(
            jvf, (jinit[0]._replace(mean=mean, cholesky=chol), jinit[1]),
            save_at=jnp.asarray(save_at), dt0=0.1, adaptive_solver=asolver)

    jsol = jax.jit(jax.vmap(solve_one))(jinit[0].mean, jinit[0].cholesky, jnp.asarray(tols))
    tol_t = torch.tensor(tols)
    tsol = tivpsolve.solve_adaptive_save_at(
        tvf, tinit, save_at=save_at, dt0=0.1,
        adaptive_solver=tivpsolve.adaptive(tsolver, atol=1e-3 * tol_t, rtol=tol_t))
    return tsol, jsol


@pytest.mark.parametrize("kind", ["filter", "smoother", "fixedpoint"])
def test_rigid_body_save_at_matches_reference(kind):
    """Isotropic TS0(4), f64, rtol 1e-4..1e-7 on (0, 10): identical per-lane
    step counts, values to rtol 1e-10."""
    tsol, jsol = _save_at_pair(kind, "isotropic", "ts0", tuple(TOLS), (0.0, 10.0))
    _assert_solutions_match(tsol, jsol)
    assert tsol.u.shape == (5, 4, 3) and tsol.posterior.init.mean.shape == (5, 4, 5, 3)


@pytest.mark.parametrize("impl,method,tols", [
    ("dense", "ts1", (1e-5, 1e-6)), ("dense", "ts0", (1e-5, 1e-6)),
    ("blockdiag", "ts0", (1e-6, 1e-7))])
def test_rigid_body_save_at_matches_reference_on_dense_and_blockdiag(impl, method, tols):
    """Fixedpoint save_at on the dense (TS1 and TS0) and blockdiag backends,
    f64 on (0, 3): identical per-lane step counts, values to rtol 1e-10."""
    tsol, jsol = _save_at_pair("fixedpoint", impl, method, tols, (0.0, 3.0))
    _assert_solutions_match(tsol, jsol)


def test_mle_save_at_matches_reference():
    """``solver_mle``: the posterior of the rigid-body save_at solve rescaled
    by the RMS of the step sigmas, as the reference rescales it."""
    tsol, jsol = _save_at_pair("fixedpoint", "isotropic", "ts0", tuple(TOLS[:2]), (0.0, 10.0),
                               calibrate="mle")
    _assert_solutions_match(tsol, jsol)
    # one factor per lane, the same at every checkpoint
    scales = tsol.output_scale.numpy()
    np.testing.assert_array_equal(scales, np.broadcast_to(scales[0], scales.shape))


def test_mle_blockdiag_has_one_scale_per_dimension():
    tsol, jsol = _save_at_pair("fixedpoint", "blockdiag", "ts0", (1e-6,), (0.0, 3.0),
                               calibrate="mle")
    _assert_solutions_match(tsol, jsol)
    assert tsol.output_scale.shape == (5, 1, 3)


@pytest.mark.parametrize("impl", ["isotropic", "dense"])
def test_terminal_values_match_reference_and_logistic_closed_form(impl):
    """Torch form of ``test_terminal_values_match_logistic_closed_form``
    (rtol 1e-6 against the closed form), and the reference's terminal solve
    itself: equal step count, values to rtol 1e-10 (the covariance to 1e-5,
    see ``_assert_solutions_match``)."""
    jvf, ju0, tspan = _logistic(jproblems)
    tvf, _, _ = _logistic(tproblems)
    jsolver = _solver(jsolvers, "filter", impl=impl, d=1)
    tsolver = _solver(tsolvers, "filter", impl=impl, d=1)
    jinit, tinit = _inits(jsolver, jvf, np.asarray(ju0), 4)
    kw = dict(t0=tspan[0], t1=tspan[1], dt0=0.1)
    jsol = jax.jit(lambda: jivpsolve.solve_adaptive_terminal_values(
        jvf, jinit, adaptive_solver=jivpsolve.adaptive(jsolver, atol=1e-9, rtol=1e-9), **kw))()
    tsol = tivpsolve.solve_adaptive_terminal_values(
        tvf, tinit, adaptive_solver=tivpsolve.adaptive(tsolver, atol=1e-9, rtol=1e-9), **kw)
    np.testing.assert_allclose(tsol.u.numpy(), _logistic_exact([tspan[1]]), rtol=1e-6)
    assert int(tsol.num_steps) == int(jsol.num_steps) > 5
    _close(tsol.u.numpy(), jsol.u, 1e-10)
    _close(tsol.u_std.numpy(), jsol.u_std, 1e-5)
    _close(_gram(tsol.posterior.init.cholesky.numpy()), _gram(jsol.posterior.init.cholesky),
           1e-5)


def _logistic_exact(ts, u0=0.1):
    c = (1.0 - u0) / u0
    return 1.0 / (1.0 + c * np.exp(-np.asarray(ts)))


def _logistic_init(solver, nu, lib=tproblems):
    vf, u0, tspan = _logistic(lib)
    tc = ttaylor.odejet_padded_scan(lambda u: vf(u, t=tspan[0]), (u0,), num=nu)
    return vf, solver.initial_condition(tc, 1.0), tspan


def _every_step_setup(lib, kind="smoother", tol=1e-6, nu=3):
    """The logistic problem for the every-step drivers in the reference
    (``lib`` = ``jproblems``) or the port."""
    jax_side = lib is jproblems
    vf, u0, tspan = _logistic(lib)
    solver = _solver(jsolvers if jax_side else tsolvers, kind, nu=nu, d=1)
    tc = (jtaylor if jax_side else ttaylor).odejet_padded_scan(
        lambda u: vf(u, t=tspan[0]), (u0,), num=nu)
    init = solver.initial_condition(tc, 1.0)
    ivp = jivpsolve if jax_side else tivpsolve
    return vf, init, tspan, ivp.adaptive(solver, atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["smoother", "filter"])
def test_save_every_step_matches_reference(kind):
    """The eager every-step driver against the reference's on the logistic
    problem (nu = 3, tol 1e-6): the same number of entries, accepted times
    to rtol 1e-6 and values to rtol 1e-6 (see the module docstring)."""
    jvf, jinit, (t0, t1), jas = _every_step_setup(jproblems, kind)
    tvf, tinit, _, tas = _every_step_setup(tproblems, kind)
    jsol = jivpsolve.solve_adaptive_save_every_step(jvf, jinit, t0=t0, t1=t1, dt0=0.1,
                                                    adaptive_solver=jas)
    tsol = tivpsolve.solve_adaptive_save_every_step(tvf, tinit, t0=t0, t1=t1, dt0=0.1,
                                                    adaptive_solver=tas)
    np.testing.assert_array_equal(tsol.num_steps.numpy(), np.asarray(jsol.num_steps))
    _close(tsol.t.numpy(), jsol.t, 1e-6)
    _close(tsol.u.numpy(), jsol.u, 1e-6)
    _close(tsol.u_std.numpy(), jsol.u_std, 1e-5)
    assert float(tsol.t[-1]) == t1


def test_bounded_driver_and_compaction_match_reference():
    """The bounded driver (256 attempts, logistic, smoother) against the
    reference's: the same valid mask, times and values to rtol 1e-6, and the
    same compacted lengths."""
    jvf, jinit, (t0, t1), jas = _every_step_setup(jproblems)
    tvf, tinit, _, tas = _every_step_setup(tproblems)
    kw = dict(t0=t0, t1=t1, dt0=0.1, max_steps=256)
    jsol, (jvalid, (jrv, _)) = jax.jit(lambda: jivpsolve.solve_adaptive_save_every_step_bounded(
        jvf, jinit, adaptive_solver=jas, **kw))()
    tsol, (tvalid, (trv, _)) = tivpsolve.solve_adaptive_save_every_step_bounded(
        tvf, tinit, adaptive_solver=tas, **kw)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tsol.num_steps.numpy(), np.asarray(jsol.num_steps))
    _close(tsol.t.numpy(), jsol.t, 1e-6)
    _close(tsol.u.numpy(), jsol.u, 1e-6)
    _close(trv.mean.numpy(), jrv.mean, 1e-6)
    tc = tivpsolve.compact_bounded_solution(tsol, tvalid)
    jc = jivpsolve.compact_bounded_solution(jsol, jvalid)
    assert tc.t.shape == jc.t.shape and tc.posterior.init.mean.shape == jc.posterior.init.mean.shape


def test_blockdiag_f32_solve_with_an_exact_zero_component_matches_reference():
    """The blockdiag row's workload in float32 (the rigid body with its third
    component scaled by 1e4, tol 1e-5, fixedpoint TS0(4), dynamic): u0's
    second component is exactly 0, so that dimension's first residual is 0,
    its output scale sits at the floor tiny^(1/2) and its predicted variance
    underflows.  The correction keeps that dimension's predicted state
    (``linalg.rank1_gain``) where ``0 / 0`` made the state NaN and the solve
    creep on at the time resolution.  Against the jitted reference (which
    gets through because its fused arithmetic leaves that residual nonzero;
    run op by op it is NaN too): every value finite, per-lane final step
    counts within 5% and the values over the scale within 20 tol."""
    s3, tol, tspan = 1e4, 1e-5, (0.0, 10.0)
    save_at = np.linspace(*tspan, 5).astype(np.float32)
    u0s = (np.array([1.0, 0.0, 0.9 * s3]) * (1.0 + 0.05 * np.random.default_rng(0)
                                             .standard_normal((4, 3)))).astype(np.float32)
    assert np.all(u0s[:, 1] == 0.0)

    def jvf(u, *, t):
        w = u[2] / s3
        return jnp.stack([-2.0 * u[1] * w, 1.25 * u[0] * w, (s3 * -0.5) * u[0] * u[1]])

    jsolver = _solver(jsolvers, "fixedpoint", impl="blockdiag")
    tsolver = _solver(tsolvers, "fixedpoint", impl="blockdiag")

    def solve_one(u0):
        tc = jtaylor.odejet_padded_scan(lambda u: jvf(u, t=0.0), (u0,), num=4)
        return jivpsolve.solve_adaptive_save_at(
            jvf, jsolver.initial_condition(tc, 1.0), save_at=jnp.asarray(save_at), dt0=0.01,
            adaptive_solver=jivpsolve.adaptive(jsolver, atol=1e-3 * tol, rtol=tol))

    jsol = jax.jit(jax.vmap(solve_one))(jnp.asarray(u0s))
    tvf_p, _, _, params = tproblems.rigid_body_anisotropic(time_span=tspan, scale=(1.0, 1.0, s3))

    def tvf(u, *, t):
        return tvf_p(u, t=t, p=params)

    tc = ttaylor.odejet_padded_scan(lambda u: tvf(u, t=0.0), (torch.tensor(u0s).T,), num=4)
    tinit = tsolver.initial_condition([c.T.to(torch.float32).contiguous() for c in tc], 1.0)
    tsol = tivpsolve.solve_adaptive_save_at(
        tvf, tinit, save_at=torch.tensor(save_at), dt0=0.01,
        adaptive_solver=tivpsolve.adaptive(tsolver, atol=1e-3 * tol, rtol=tol))
    assert tsol.u.dtype == torch.float32
    for x in (tsol.u, tsol.u_std, tsol.posterior.init.mean, tsol.posterior.init.cholesky):
        assert bool(torch.all(torch.isfinite(x)))
    steps, jsteps = _np(tsol.num_steps, True)[:, -1], np.asarray(jsol.num_steps)[:, -1]
    np.testing.assert_allclose(steps, jsteps, rtol=0.05)
    scale = np.array([1.0, 1.0, s3])
    np.testing.assert_allclose(_np(tsol.u, True) / scale, np.asarray(jsol.u) / scale,
                               rtol=0, atol=20 * tol)
