"""Port differential tests of the fixed-grid path's building blocks and of
the sequential ``solve_fixed_grid`` against the JAX reference, in f64.

The same numpy inputs go through both packages.  The single-step methods are
held to rtol 1e-12 (the same operations in the same order), whole solves
over 32 steps to rtol 1e-10 (rounding differences of the two matmul and QR
implementations accumulate over the steps).  Covariance factors of a solve
are compared through L L^T.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import ivpsolve as jivpsolve
from odecheckpts_tpu import ivpsolvers as jsolvers
from odecheckpts_tpu import problems as jproblems
from odecheckpts_tpu import stats as jstats
from odecheckpts_tpu import taylor as jtaylor
from odecheckpts_tpu.ssm.base import Normal as JNormal
from odecheckpts_torch import interop
from odecheckpts_torch import ivpsolve as tivpsolve
from odecheckpts_torch import ivpsolvers as tsolvers
from odecheckpts_torch import problems as tproblems
from odecheckpts_torch import stats as tstats
from odecheckpts_torch import taylor as ttaylor
from odecheckpts_torch.ssm.base import Normal as TNormal

NU, D = 3, 3
N = NU + 1
TSPAN = (0.0, 2.0)
STRATEGIES = ("filter", "smoother", "fixedpoint")


def _ssms():
    return (jsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,)),
            tsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,)))


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _state(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, D)), np.tril(rng.standard_normal((N, N))) + 2.0 * np.eye(N)


def test_promote_output_scale_and_select_deriv_match_reference():
    jssm, tssm = _ssms()
    mean, _ = _state(0)
    _close(tssm.promote_output_scale(1.5), jssm.promote_output_scale(1.5))
    for i in range(N):
        _close(tssm.select_deriv(torch.tensor(mean), i), jssm.select_deriv(jnp.asarray(mean), i))


def test_extrapolate_mean_matches_reference():
    jssm, tssm = _ssms()
    mean, _ = _state(1)
    jm, (jp, jpi) = jssm.extrapolate_mean(jnp.asarray(mean), jnp.asarray(0.37))
    tm, (tp, tpi) = tssm.extrapolate_mean(torch.tensor(mean), torch.tensor(0.37, dtype=torch.float64))
    _close(tm, jm)
    _close(tp, jp)
    _close(tpi, jpi)


@pytest.mark.parametrize("reversal", [False, True])
def test_extrapolate_cov_matches_reference(reversal):
    jssm, tssm = _ssms()
    mean, chol = _state(2)
    dt, scale = 0.21, 1.7
    jm, jcache = jssm.extrapolate_mean(jnp.asarray(mean), jnp.asarray(dt))
    tm, tcache = tssm.extrapolate_mean(torch.tensor(mean), torch.tensor(dt, dtype=torch.float64))
    jrv, jbwd = jssm.extrapolate_cov(JNormal(jnp.asarray(mean), jnp.asarray(chol)), jm, jcache,
                                     jnp.asarray(scale), reversal)
    trv, tbwd = tssm.extrapolate_cov(TNormal(torch.tensor(mean), torch.tensor(chol)), tm, tcache,
                                     torch.tensor(scale, dtype=torch.float64), reversal)
    _close(trv.mean, jrv.mean)
    _close(trv.cholesky, jrv.cholesky)
    if not reversal:
        assert jbwd is None and tbwd is None
        return
    _close(tbwd.matrix, jbwd.matrix)
    _close(tbwd.noise.mean, jbwd.noise.mean)
    _close(tbwd.noise.cholesky, jbwd.noise.cholesky)


@pytest.mark.parametrize("unit", ["qoi", "residual"])
def test_error_and_scale_deriv_matches_reference(unit):
    jssm, tssm = _ssms()
    z = np.random.default_rng(3).standard_normal(D)
    _, jcache = jssm.extrapolate_mean(jnp.zeros((N, D)), jnp.asarray(0.13))
    _, tcache = tssm.extrapolate_mean(torch.zeros((N, D), dtype=torch.float64),
                                      torch.tensor(0.13, dtype=torch.float64))
    jsig, jerr = jssm.error_and_scale_deriv(jnp.asarray(z), jcache, 1, unit=unit)
    tsig, terr = tssm.error_and_scale_deriv(torch.tensor(z), tcache, 1, unit=unit)
    _close(tsig, jsig)
    _close(terr, jerr)


def test_correct_deriv_matches_reference():
    jssm, tssm = _ssms()
    mean, chol = _state(4)
    z = np.random.default_rng(5).standard_normal(D)
    jrv, jobs = jssm.correct_deriv(JNormal(jnp.asarray(mean), jnp.asarray(chol)), jnp.asarray(z), 1)
    trv, tobs = tssm.correct_deriv(TNormal(torch.tensor(mean), torch.tensor(chol)), torch.tensor(z), 1)
    _close(trv.mean, jrv.mean)
    _close(trv.cholesky, jrv.cholesky)
    _close(tobs.mean, jobs.mean)
    _close(tobs.cholesky, jobs.cholesky)


def test_new_isotropic_methods_broadcast_over_a_leading_step_axis():
    # the parallel-in-time solve calls them on (w, n, d) stacks: every entry
    # must equal the unbatched call (rtol 1e-14: batched matmuls may reorder)
    _, tssm = _ssms()
    rng = np.random.default_rng(6)
    means = torch.tensor(rng.standard_normal((5, N, D)))
    chols = torch.tensor(np.tril(rng.standard_normal((5, N, N))) + 2.0 * np.eye(N))
    dts = torch.tensor(rng.uniform(0.1, 0.3, 5))
    scales = torch.tensor(rng.uniform(0.5, 2.0, 5))
    zs = torch.tensor(rng.standard_normal((5, D)))
    m_all, cache = tssm.extrapolate_mean(means, dts)
    rv_all, bwd_all = tssm.extrapolate_cov(TNormal(means, chols), m_all, cache, scales, True)
    sig_all, err_all = tssm.error_and_scale_deriv(zs, cache, 1)
    cor_all, _ = tssm.correct_deriv(rv_all, zs, 1)
    for k in range(5):
        m_k, cache_k = tssm.extrapolate_mean(means[k], dts[k])
        rv_k, bwd_k = tssm.extrapolate_cov(TNormal(means[k], chols[k]), m_k, cache_k, scales[k], True)
        sig_k, err_k = tssm.error_and_scale_deriv(zs[k], cache_k, 1)
        cor_k, _ = tssm.correct_deriv(rv_k, zs[k], 1)
        for got, want in ((m_all[k], m_k), (rv_all.cholesky[k], rv_k.cholesky),
                          (bwd_all.matrix[k], bwd_k.matrix),
                          (bwd_all.noise.cholesky[k], bwd_k.noise.cholesky),
                          (sig_all[k], sig_k), (err_all[k], err_k),
                          (cor_all.mean[k], cor_k.mean), (cor_all.cholesky[k], cor_k.cholesky)):
            _close(got, want.numpy(), rtol=1e-14)


def _problem(lib):
    vf_p, u0s, _tspan, params = lib.rigid_body(time_span=TSPAN)

    def vf(u, *, t):
        return vf_p(u, t=t, p=params)

    return vf, u0s


def _solvers(strategy, calibration):
    out = []
    for lib in (jsolvers, tsolvers):
        prior = lib.prior_ibm(num_derivatives=NU, ode_shape=(D,))
        strat = getattr(lib, f"strategy_{strategy}")(prior, lib.correction_ts0())
        out.append(lib.solver_dynamic(strat) if calibration == "dynamic" else lib.solver(strat))
    return out


def _inits(jsolver, tsolver):
    """The reference's Taylor init as numpy arrays, handed to both packages."""
    jvf, ju0s = _problem(jproblems)
    tcoeffs = jtaylor.odejet_padded_scan(lambda u: jvf(u, t=TSPAN[0]), ju0s, num=NU)
    jinit = jsolver.initial_condition(tcoeffs, 1.0)
    as_np = ((np.asarray(jinit[0].mean), np.asarray(jinit[0].cholesky)), np.asarray(jinit[1]))
    return jinit, interop.init_to_torch(as_np)


@pytest.mark.parametrize("unit", ["qoi", "residual"])
def test_linearize_error_and_scale_and_correct_match_reference(unit):
    jvf, _ = _problem(jproblems)
    tvf, _ = _problem(tproblems)
    mean, chol = _state(7)
    strats = []
    for lib in (jsolvers, tsolvers):
        prior = lib.prior_ibm(num_derivatives=NU, ode_shape=(D,))
        strats.append(lib.strategy_filter(prior, lib.correction_ts0(error_unit=unit)))
    jstrat, tstrat = strats
    jm, jcache = jstrat.ssm.extrapolate_mean(jnp.asarray(mean), jnp.asarray(0.2))
    tm, tcache = tstrat.ssm.extrapolate_mean(torch.tensor(mean), torch.tensor(0.2, dtype=torch.float64))
    jz, jjac = jsolvers.linearize(jstrat, jvf, jm, 0.2)
    tz, tjac = tsolvers.linearize(tstrat, tvf, tm, 0.2)
    assert jjac == () and tjac == ()
    _close(tz, jz)
    jsig, jerr = jsolvers.error_and_scale(jstrat, jz, jjac, jcache)
    tsig, terr = tsolvers.error_and_scale(tstrat, tz, tjac, tcache)
    _close(tsig, jsig)
    _close(terr, jerr)
    jrv, _ = jsolvers.correct(jstrat, JNormal(jm, jnp.asarray(chol)), jz, jjac)
    trv, _ = tsolvers.correct(tstrat, TNormal(tm, torch.tensor(chol)), tz, tjac)
    _close(trv.mean, jrv.mean)
    _close(trv.cholesky, jrv.cholesky)


def _gram(x):
    x = np.asarray(x)
    return x @ np.swapaxes(x, -1, -2)


def _assert_solutions_match(tsol, jsol, rtol):
    got = interop.solution_to_numpy(tsol)
    _close(got["t"], jsol.t, rtol)
    _close(got["u"], jsol.u, rtol)
    _close(got["u_std"], jsol.u_std, rtol)
    _close(got["output_scale"], jsol.output_scale, rtol)
    _close(got["mean"], jsol.posterior.init.mean, rtol)
    _close(_gram(got["cholesky"]), _gram(jsol.posterior.init.cholesky), rtol)
    np.testing.assert_array_equal(tsol.num_steps.numpy(), np.asarray(jsol.num_steps))
    jcond = jsol.posterior.conditional
    if jcond is None:
        assert got["cond_matrix"] is None
        return
    _close(got["cond_matrix"], jcond.matrix, rtol)
    _close(got["cond_mean"], jcond.noise.mean, rtol)
    _close(_gram(got["cond_cholesky"]), _gram(jcond.noise.cholesky), rtol)


@pytest.mark.parametrize("calibration", ["none", "dynamic"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sequential_fixed_grid_matches_reference(strategy, calibration):
    jsolver, tsolver = _solvers(strategy, calibration)
    jinit, tinit = _inits(jsolver, tsolver)
    jvf, _ = _problem(jproblems)
    tvf, _ = _problem(tproblems)
    grid = np.linspace(*TSPAN, 33)
    jsol = jivpsolve.solve_fixed_grid(jvf, jinit, grid=jnp.asarray(grid), solver=jsolver)
    tsol = tivpsolve.solve_fixed_grid(tvf, tinit, grid=grid, solver=tsolver)
    assert tsol.u.dtype == torch.float64 and tsol.u.shape == (33, D)
    _assert_solutions_match(tsol, jsol, rtol=1e-10)


def test_markov_marginals_of_a_fixed_grid_posterior_match_reference():
    # a fixed-grid MarkovSeq stacks T conditionals with the identity first
    jsolver, tsolver = _solvers("smoother", "dynamic")
    jinit, tinit = _inits(jsolver, tsolver)
    jvf, _ = _problem(jproblems)
    tvf, _ = _problem(tproblems)
    grid = np.linspace(*TSPAN, 17)
    jsol = jivpsolve.solve_fixed_grid(jvf, jinit, grid=jnp.asarray(grid), solver=jsolver)
    tsol = tivpsolve.solve_fixed_grid(tvf, tinit, grid=grid, solver=tsolver)
    jmarg = jstats.markov_marginals(jstats.markov_select_terminal(jsol.posterior))
    tmarg = tstats.markov_marginals(tstats.markov_select_terminal(tsol.posterior))
    assert tmarg.mean.shape == (16, N, D)
    _close(tmarg.mean, jmarg.mean, rtol=1e-9)
    _close(_gram(tmarg.cholesky.numpy()), _gram(jmarg.cholesky), rtol=1e-9)


def test_float32_solve_stays_in_float32_and_near_float64():
    _, tsolver = _solvers("filter", "dynamic")
    tvf, u0s = _problem(tproblems)
    tcoeffs = ttaylor.odejet_padded_scan(lambda u: tvf(u, t=TSPAN[0]), u0s, num=NU)
    rv, scale = tsolver.initial_condition(tcoeffs, 1.0)
    init32 = (TNormal(rv.mean.float(), rv.cholesky.float()), scale.float())
    grid = np.linspace(*TSPAN, 65)
    sol64 = tivpsolve.solve_fixed_grid(tvf, (rv, scale), grid=grid, solver=tsolver)
    sol32 = tivpsolve.solve_fixed_grid(tvf, init32, grid=grid, solver=tsolver)
    assert sol32.u.dtype == torch.float32 and sol32.t.dtype == torch.float32
    # f32 rounding over 64 steps of an O(1) solution: a few 1e-6
    np.testing.assert_allclose(sol32.u.numpy(), sol64.u.numpy(), rtol=0, atol=5e-5)


def test_parallel_options_on_the_sequential_path_raise():
    _, tsolver = _solvers("filter", "dynamic")
    jsolver, _ = _solvers("filter", "dynamic")
    _, tinit = _inits(jsolver, tsolver)
    tvf, _ = _problem(tproblems)
    grid = np.linspace(*TSPAN, 5)
    for kw in (dict(form="sqrt"), dict(warmstart="rk"), dict(damping=0.5),
               dict(combine_engine="ll"), dict(iteration_tol=1e-6), dict(time_shard=(None, "t"))):
        with pytest.raises(ValueError, match="parallel-in-time"):
            tivpsolve.solve_fixed_grid(tvf, tinit, grid=grid, solver=tsolver, **kw)
    with pytest.raises(ValueError, match="strictly increasing"):
        tivpsolve.solve_fixed_grid(tvf, tinit, grid=grid[::-1].copy(), solver=tsolver)
    with pytest.raises(ValueError, match="1-D"):
        tivpsolve.solve_fixed_grid(tvf, tinit, grid=np.zeros((2, 2)), solver=tsolver)


def test_calibration_constants_and_what_is_left_out():
    assert (tsolvers.NONE, tsolvers.DYNAMIC, tsolvers.MLE) == (
        jsolvers.NONE, jsolvers.DYNAMIC, jsolvers.MLE)
    jsolver, tsolver = _solvers("filter", "none")
    assert tsolver.calibration == tsolvers.NONE == jsolver.calibration
    with pytest.raises(NotImplementedError, match="item 2"):
        tsolvers.solver_mle(tsolver.strategy)
    _, tinit = _inits(jsolver, tsolver)
    tvf, _ = _problem(tproblems)
    mle = tsolvers.Solver(tsolver.strategy, tsolvers.MLE)
    with pytest.raises(NotImplementedError, match="item 2"):
        tivpsolve.solve_fixed_grid(tvf, tinit, grid=np.linspace(0, 1, 3), solver=mle)
    dense = tsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,), implementation="dense")
    ts1 = tsolvers.strategy_filter(dense, tsolvers.correction_ts1())
    with pytest.raises(NotImplementedError, match="item 3"):
        tsolvers.linearize(ts1, tvf, torch.zeros(N * D, dtype=torch.float64), 0.0)
    ts0_dense = tsolvers.strategy_filter(dense, tsolvers.correction_ts0())
    with pytest.raises(NotImplementedError, match="item 3"):
        tsolvers.correct(ts0_dense, None, None, ())
    with pytest.raises(ValueError, match="error_unit"):
        tsolvers.correction_ts0(error_unit="bogus")


def test_interop_carries_init_and_solution():
    jsolver, tsolver = _solvers("smoother", "none")
    jinit, tinit = _inits(jsolver, tsolver)
    assert isinstance(tinit[0], TNormal) and tinit[0].mean.dtype == torch.float64
    np.testing.assert_array_equal(tinit[0].mean.numpy(), np.asarray(jinit[0].mean))
    assert float(tinit[1]) == 1.0
    tvf, _ = _problem(tproblems)
    sol = tivpsolve.solve_fixed_grid(tvf, tinit, grid=np.linspace(0, 1, 4), solver=tsolver)
    as_np = interop.solution_to_numpy(sol)
    assert as_np["mean"].shape == (4, N, D) and as_np["cond_matrix"].shape == (4, N, N)
    np.testing.assert_array_equal(as_np["cond_matrix"][0], np.eye(N))  # the identity at t0
    assert all(isinstance(v, np.ndarray) for v in as_np.values())
