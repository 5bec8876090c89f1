"""Port differential tests of the parallel-in-time fixed-grid solve against
the JAX reference's, in f64 on the same grid (rigid body, nu = 3, T = 33,
window 8, 4 sweeps).

Both packages run the same algorithm on the same numpy inputs; the port
writes the window algebra batched where the reference maps one-step
functions, so the two differ by matmul and QR rounding that the sweeps and
the window carry compound: ``u`` and the stacked means agree to rtol 1e-9
(observed: 1e-12 or better), factors through L L^T.  The jitted reference
solves are shared across tests (one compile per configuration).
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
from odecheckpts_tpu import stats as jstats
from odecheckpts_tpu import taylor as jtaylor
from odecheckpts_torch import interop
from odecheckpts_torch import ivpsolve as tivpsolve
from odecheckpts_torch import ivpsolvers as tsolvers
from odecheckpts_torch import parallel_time as tpt
from odecheckpts_torch import problems as tproblems
from odecheckpts_torch import stats as tstats

NU, D, T = 3, 3, 33
TSPAN = (0.0, 2.0)
GRID = np.linspace(*TSPAN, T)
BASE = dict(parallel=True, window=8, iterations=4)
RTOL = 1e-9


def _vf(lib):
    vf_p, u0s, _tspan, params = lib.rigid_body(time_span=TSPAN)
    return (lambda u, *, t: vf_p(u, t=t, p=params)), u0s


def _solver(lib, strategy, calibration="dynamic"):
    prior = lib.prior_ibm(num_derivatives=NU, ode_shape=(D,))
    strat = getattr(lib, f"strategy_{strategy}")(prior, lib.correction_ts0())
    return lib.solver_dynamic(strat) if calibration == "dynamic" else lib.solver(strat)


@functools.lru_cache(maxsize=None)
def _setup(strategy, calibration="dynamic"):
    """(jvf, jinit, jsolver), (tvf, tinit, tsolver): the reference's Taylor
    init as numpy arrays for both."""
    jvf, ju0s = _vf(jproblems)
    tvf, _ = _vf(tproblems)
    jsolver, tsolver = _solver(jsolvers, strategy, calibration), _solver(tsolvers, strategy,
                                                                         calibration)
    tcoeffs = jtaylor.odejet_padded_scan(lambda u: jvf(u, t=TSPAN[0]), ju0s, num=NU)
    jinit = jsolver.initial_condition(tcoeffs, 1.0)
    as_np = ((np.asarray(jinit[0].mean), np.asarray(jinit[0].cholesky)), np.asarray(jinit[1]))
    return (jvf, jinit, jsolver), (tvf, interop.init_to_torch(as_np), tsolver)


def _both(strategy="filter", calibration="dynamic", **kw):
    (jvf, jinit, jsolver), (tvf, tinit, tsolver) = _setup(strategy, calibration)
    jkw = dict(kw)
    if isinstance(jkw.get("warmstart"), np.ndarray):
        jkw["warmstart"] = jnp.asarray(jkw["warmstart"])
    jout = jivpsolve.solve_fixed_grid(jvf, jinit, grid=jnp.asarray(GRID), solver=jsolver,
                                      **{**BASE, **jkw})
    tout = tivpsolve.solve_fixed_grid(tvf, tinit, grid=GRID, solver=tsolver, **{**BASE, **kw})
    return jout, tout


def _gram(x):
    x = np.asarray(x)
    return x @ np.swapaxes(x, -1, -2)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


def _assert_match(tsol, jsol):
    got = interop.solution_to_numpy(tsol)
    _close(got["u"], jsol.u)
    _close(got["u_std"], jsol.u_std)
    _close(got["output_scale"], jsol.output_scale)
    _close(got["mean"], jsol.posterior.init.mean)
    _close(_gram(got["cholesky"]), _gram(jsol.posterior.init.cholesky))
    assert got["u"].shape == (T, D) and np.all(np.isfinite(got["u"]))


@pytest.mark.parametrize("form,engine", [("cov", None), ("sqrt", None), ("sqrt", "ll")])
def test_parallel_solve_matches_reference(form, engine):
    jsol, tsol = _both(form=form, combine_engine=engine)
    _assert_match(tsol, jsol)
    assert tsol.posterior.conditional is None


@pytest.mark.parametrize("warmstart", ["rk", "rk:4", "sie"])
def test_warm_starts_match_reference(warmstart):
    jsol, tsol = _both(form="sqrt", combine_engine="ll", warmstart=warmstart)
    _assert_match(tsol, jsol)
    # warm-started windows converge toward the sequential solve: within 1e-4
    # after 4 sweeps from the RK4 start, 2e-3 from the first-order "sie" start
    _, (tvf, tinit, tsolver) = _setup("filter")
    seq = tivpsolve.solve_fixed_grid(tvf, tinit, grid=GRID, solver=tsolver)
    atol = 2e-3 if warmstart == "sie" else 1e-4
    np.testing.assert_allclose(tsol.u.numpy(), seq.u.numpy(), rtol=0, atol=atol)


def test_a_given_warm_start_matches_reference_and_is_validated():
    (jvf, jinit, jsolver), (tvf, tinit, tsolver) = _setup("filter")
    seq = jivpsolve.solve_fixed_grid(jvf, jinit, grid=jnp.asarray(GRID), solver=jsolver)
    given = np.array(seq.posterior.init.mean)[1:]  # (T - 1, n, d)
    jsol, tsol = _both(form="sqrt", warmstart=given)
    _assert_match(tsol, jsol)
    with pytest.raises(ValueError, match="precomputed warmstart must have shape"):
        tivpsolve.solve_fixed_grid(tvf, tinit, grid=GRID, solver=tsolver, **BASE, form="sqrt",
                                   warmstart=given[:-1])


@pytest.mark.parametrize("strategy", ["smoother", "fixedpoint"])
def test_reversal_strategies_match_reference_through_the_marginals(strategy):
    jsol, tsol = _both(strategy, form="sqrt", combine_engine="ll", warmstart="rk")
    _assert_match(tsol, jsol)
    got = interop.solution_to_numpy(tsol)
    jcond = jsol.posterior.conditional
    assert got["cond_matrix"].shape == (T, NU + 1, NU + 1)
    _close(got["cond_matrix"], jcond.matrix)
    _close(got["cond_mean"], jcond.noise.mean)
    _close(_gram(got["cond_cholesky"]), _gram(jcond.noise.cholesky))
    jmarg = jstats.markov_marginals(jstats.markov_select_terminal(jsol.posterior))
    tmarg = tstats.markov_marginals(tstats.markov_select_terminal(tsol.posterior))
    _close(tmarg.mean.numpy(), jmarg.mean, rtol=1e-8)
    _close(_gram(tmarg.cholesky.numpy()), _gram(jmarg.cholesky), rtol=1e-8)


def test_iteration_tol_with_diagnostics_matches_reference():
    (jsol, jdiag), (tsol, tdiag) = _both(
        "filter", "none", form="cov", damping=0.2, iterations=30, iteration_tol=1e-9,
        return_diagnostics=True)
    _assert_match(tsol, jsol)
    tdiag = interop.diagnostics_to_numpy(tdiag)
    assert tdiag["window_size"] == jdiag["window_size"] == 8
    assert tdiag["num_windows"] == jdiag["num_windows"] == 4
    np.testing.assert_array_equal(tdiag["window_diverged"], np.asarray(jdiag["window_diverged"]))
    np.testing.assert_array_equal(tdiag["window_finite"], np.asarray(jdiag["window_finite"]))
    # the final-sweep deltas sit below the tolerance that stopped the sweeps
    assert np.all(tdiag["window_delta"] < 1e-7)
    np.testing.assert_allclose(tdiag["window_delta"], np.asarray(jdiag["window_delta"]),
                               rtol=0, atol=1e-10)


def test_a_forced_fallback_equals_the_sequential_solve():
    # fallback_rtol tiny: every window diverts to the sequential filter, whose
    # steps are the sequential solve's own (the carry between windows is the
    # filtered state): equal to rounding of the factor's representation
    _, (tvf, tinit, tsolver) = _setup("smoother")
    seq = tivpsolve.solve_fixed_grid(tvf, tinit, grid=GRID, solver=tsolver)
    for form in ("sqrt", "cov"):
        sol, diag = tivpsolve.solve_fixed_grid(
            tvf, tinit, grid=GRID, solver=tsolver, **BASE, form=form, fallback_rtol=1e-300,
            return_diagnostics=True)
        assert bool(torch.all(diag["window_diverged"])) and bool(torch.all(diag["window_finite"]))
        tol = 1e-12 if form == "sqrt" else 1e-6  # cov: a jittered Cholesky per window
        _close(sol.u.numpy(), seq.u.numpy(), rtol=tol)
        _close(sol.output_scale.numpy(), seq.output_scale.numpy(), rtol=tol)
        if form == "sqrt":
            _close(sol.posterior.conditional.matrix.numpy(),
                   seq.posterior.conditional.matrix.numpy(), rtol=1e-9)
    ungated = tivpsolve.solve_fixed_grid(tvf, tinit, grid=GRID, solver=tsolver, **BASE,
                                         form="sqrt", fallback_rtol=None,
                                         return_diagnostics=True)[1]
    assert not bool(torch.any(ungated["window_diverged"]))


def test_the_last_window_is_padded_and_options_without_preconditioning_match():
    # T - 1 = 32 steps in windows of 5: the last window holds 2 valid steps
    (jvf, jinit, jsolver), (tvf, tinit, tsolver) = _setup("filter")
    kw = dict(parallel=True, window=5, iterations=3, form="sqrt", precondition=False,
              deviation=False)
    jsol = jivpsolve.solve_fixed_grid(jvf, jinit, grid=jnp.asarray(GRID), solver=jsolver, **kw)
    tsol = tivpsolve.solve_fixed_grid(tvf, tinit, grid=GRID, solver=tsolver, **kw)
    _assert_match(tsol, jsol)


def test_value_errors_of_the_parallel_solve():
    _, (tvf, tinit, tsolver) = _setup("filter")
    kw = dict(grid=GRID, solver=tsolver, parallel=True)
    with pytest.raises(ValueError, match="form must be"):
        tivpsolve.solve_fixed_grid(tvf, tinit, form="bogus", **kw)
    with pytest.raises(ValueError, match="combine_engine must be"):
        tivpsolve.solve_fixed_grid(tvf, tinit, form="sqrt", combine_engine="pallas", **kw)
    with pytest.raises(ValueError, match="pass form='sqrt'"):
        tivpsolve.solve_fixed_grid(tvf, tinit, form="cov", combine_engine="ll", **kw)
    for bad in ("rk4", "rk:0", "sie:x", 3):
        with pytest.raises(ValueError, match="warmstart must be"):
            tivpsolve.solve_fixed_grid(tvf, tinit, form="sqrt", warmstart=bad, **kw)
    assert tpt._parse_warmstart(None) is None
    assert tpt._parse_warmstart("rk") == ("rk4", 1)
    assert tpt._parse_warmstart("sie:16") == ("sie", 16)
    assert tpt._parse_warmstart(np.zeros((2, 2))) == ("given", None)


def test_what_is_left_out_raises_and_the_cuda_engine_has_no_fallback():
    _, (tvf, tinit, tsolver) = _setup("filter")
    kw = dict(grid=GRID, solver=tsolver, parallel=True, form="sqrt")
    with pytest.raises(NotImplementedError, match="item 8"):
        tivpsolve.solve_fixed_grid(tvf, tinit, time_shard=(object(), "t"), **kw)
    with pytest.raises(RuntimeError, match="CUDA tensors"):  # CPU tensors: no card, no answer
        tivpsolve.solve_fixed_grid(tvf, tinit, combine_engine="cuda", **kw)
    for implementation in ("dense", "blockdiag"):
        prior = tsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,),
                                   implementation=implementation)
        with pytest.raises(NotImplementedError, match="item 3"):
            tpt._adapters(prior)
    mle = tsolvers.Solver(tsolver.strategy, tsolvers.MLE)
    with pytest.raises(NotImplementedError, match="item 2"):
        tivpsolve.solve_fixed_grid(tvf, tinit, grid=GRID, solver=mle, parallel=True)
    with pytest.raises(NotImplementedError, match="item 5"):
        tsolvers.correction_ts0(ode_order=2)
    with pytest.raises(NotImplementedError, match="item 2"):
        tivpsolve.solve_adaptive_parallel_in_time(tvf, tinit, t0=0.0, t1=1.0)
