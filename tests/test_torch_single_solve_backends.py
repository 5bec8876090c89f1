"""Port differential tests of the single-solve surface of the dense and
blockdiag backends (``ssm/dense``, ``ssm/blockdiag``), of the ``linalg``
functions they use, of ``ssm.register`` and of the TS1 linearization, op by
op against the JAX reference.

The same numpy inputs (random states with a leading batch axis of 5; the
reference maps its one-IVP methods over it with ``vmap``) go through both
packages, in float64 (held to rtol 1e-12) and float32 (rtol 2e-5: the port
sums products in order and takes f32 ``sqrt`` / ``log`` from f64 rounded
once, the reference's eager XLA products sum in their own order).
Covariance factors are compared as they come: both packages' QRs fix the
sign of the diagonal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import ivpsolve as jivpsolve
from odecheckpts_tpu import ivpsolvers as jsolvers
from odecheckpts_tpu import linalg as jlinalg
from odecheckpts_tpu import problems as jproblems
from odecheckpts_tpu.ssm.base import Normal as JNormal
from odecheckpts_torch import ivpsolve as tivpsolve
from odecheckpts_torch import ivpsolvers as tsolvers
from odecheckpts_torch import linalg as tlinalg
from odecheckpts_torch import problems as tproblems
from odecheckpts_torch import ssm as tssm_lib
from odecheckpts_torch import taylor as ttaylor
from odecheckpts_torch.ssm.base import Normal as TNormal

NU, D, B = 3, 3, 5
N = NU + 1
DTYPES = {"f64": (np.float64, 1e-12), "f32": (np.float32, 2e-5)}


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-30))


def _ssms(impl):
    return (jsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,), implementation=impl),
            tsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,), implementation=impl))


def _random(seed, dtype):
    rng = np.random.default_rng(seed)

    def lower(*shape):
        k = shape[-1]
        return (np.tril(rng.standard_normal(shape)) + 2.0 * np.eye(k)).astype(dtype)

    return rng, lower


def _state(impl, seed, dtype):
    """A batch of B means and lower factors in the backend's layout, dts and
    (per lane, per dimension on blockdiag) output scales."""
    rng, lower = _random(seed, dtype)
    if impl == "dense":
        mean, chol = rng.standard_normal((B, N * D)), lower(B, N * D, N * D)
        scale = rng.uniform(0.5, 2.0, B)
    else:
        mean, chol = rng.standard_normal((B, D, N)), lower(B, D, N, N)
        scale = rng.uniform(0.5, 2.0, (B, D))
    return (mean.astype(dtype), chol, rng.uniform(0.05, 0.3, B).astype(dtype),
            scale.astype(dtype))


def _both(x):
    return jnp.asarray(x), torch.tensor(x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["dense", "blockdiag"])
@pytest.mark.parametrize("reversal", [False, True])
def test_extrapolation_matches_reference(impl, dtype, reversal):
    np_dtype, rtol = DTYPES[dtype]
    jssm, tssm = _ssms(impl)
    mean, chol, dt, scale = (_both(x) for x in _state(impl, 0, np_dtype))

    def one(m, c, h, s):
        m_pred, cache = jssm.extrapolate_mean(m, h)
        rv, bwd = jssm.extrapolate_cov(JNormal(m, c), m_pred, cache, s, reversal)
        return m_pred, cache, rv, bwd

    jm, jcache, jrv, jbwd = jax.vmap(one)(mean[0], chol[0], dt[0], scale[0])
    tm, tcache = tssm.extrapolate_mean(mean[1], dt[1])
    trv, tbwd = tssm.extrapolate_cov(TNormal(mean[1], chol[1]), tm, tcache, scale[1], reversal)
    for got, want in ((tm, jm), (tcache[0], jcache[0]), (tcache[1], jcache[1]),
                      (trv.mean, jrv.mean), (trv.cholesky, jrv.cholesky)):
        _close(got, want, rtol)
    if not reversal:
        assert jbwd is None and tbwd is None
        return
    for got, want in ((tbwd.matrix, jbwd.matrix), (tbwd.noise.mean, jbwd.noise.mean),
                      (tbwd.noise.cholesky, jbwd.noise.cholesky)):
        _close(got, want, rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["dense", "blockdiag"])
def test_promote_select_qoi_std_and_rescale_match_reference(impl, dtype):
    np_dtype, rtol = DTYPES[dtype]
    jssm, tssm = _ssms(impl)
    mean, chol, _dt, scale = (_both(x) for x in _state(impl, 1, np_dtype))
    _close(tssm.promote_output_scale(torch.tensor(np_dtype(1.5))),
           jssm.promote_output_scale(jnp.asarray(np_dtype(1.5))), rtol)
    for i in range(N):
        _close(tssm.select_deriv(mean[1], i), jax.vmap(lambda m: jssm.select_deriv(m, i))(mean[0]),
               rtol)
    _close(tssm.qoi_std(TNormal(mean[1], chol[1])),
           jax.vmap(lambda m, c: jssm.qoi_std(JNormal(m, c)))(mean[0], chol[0]), rtol)
    factor = scale if impl == "blockdiag" else (jnp.asarray(scale[0]), scale[1])
    _close(tssm.rescale_cholesky(chol[1], factor[1]),
           jax.vmap(jssm.rescale_cholesky)(chol[0], factor[0]), rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("unit", ["qoi", "residual"])
@pytest.mark.parametrize("method", ["ts0", "ts1"])
def test_dense_corrections_match_reference(method, unit, dtype):
    """``h_q_unit``, ``error_and_scale``, ``h_l_rows`` and ``correct_affine``
    (TS0: no Jacobian; TS1: a random one per lane)."""
    np_dtype, rtol = DTYPES[dtype]
    jssm, tssm = _ssms("dense")
    mean, chol, dt, _scale = (_both(x) for x in _state("dense", 2, np_dtype))
    rng = np.random.default_rng(3)
    z = _both(rng.standard_normal((B, D)).astype(np_dtype))
    jac = _both(rng.standard_normal((B, D, D)).astype(np_dtype))
    jacs = (jac,) if method == "ts1" else ()

    def one(m, c, h, zz, *jj):
        _, cache = jssm.extrapolate_mean(m, h)
        h_q = jssm.h_q_unit(cache, 1, jj)
        sigma, err = jssm.error_and_scale(zz, h_q, cache, unit=unit)
        h_l = jssm.h_l_rows(c, 1, jj)
        rv, obs = jssm.correct_affine(JNormal(m, c), zz, h_l)
        return h_q, sigma, err, h_l, rv, obs

    jout = jax.vmap(one)(mean[0], chol[0], dt[0], z[0], *(j[0] for j in jacs))
    _, tcache = tssm.extrapolate_mean(mean[1], dt[1])
    t_jacs = tuple(j[1] for j in jacs)
    h_q = tssm.h_q_unit(tcache, 1, t_jacs)
    sigma, err = tssm.error_and_scale(z[1], h_q, tcache, unit=unit)
    h_l = tssm.h_l_rows(chol[1], 1, t_jacs)
    rv, obs = tssm.correct_affine(TNormal(mean[1], chol[1]), z[1], h_l)
    for got, want in zip((h_q, sigma, err, h_l, rv.mean, rv.cholesky, obs.mean, obs.cholesky),
                         (*jout[:4], jout[4].mean, jout[4].cholesky, jout[5].mean,
                          jout[5].cholesky)):
        _close(got, want, rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("unit", ["qoi", "residual"])
def test_blockdiag_corrections_match_reference(unit, dtype):
    np_dtype, rtol = DTYPES[dtype]
    jssm, tssm = _ssms("blockdiag")
    mean, chol, dt, _scale = (_both(x) for x in _state("blockdiag", 4, np_dtype))
    z = _both(np.random.default_rng(5).standard_normal((B, D)).astype(np_dtype))

    def one(m, c, h, zz):
        _, cache = jssm.extrapolate_mean(m, h)
        sigma, err = jssm.error_and_scale_deriv(zz, cache, 1, unit=unit)
        rv, obs = jssm.correct_deriv(JNormal(m, c), zz, 1)
        return sigma, err, rv, obs

    jsig, jerr, jrv, jobs = jax.vmap(one)(mean[0], chol[0], dt[0], z[0])
    _, tcache = tssm.extrapolate_mean(mean[1], dt[1])
    tsig, terr = tssm.error_and_scale_deriv(z[1], tcache, 1, unit=unit)
    trv, tobs = tssm.correct_deriv(TNormal(mean[1], chol[1]), z[1], 1)
    for got, want in ((tsig, jsig), (terr, jerr), (trv.mean, jrv.mean),
                      (trv.cholesky, jrv.cholesky), (tobs.mean, jobs.mean),
                      (tobs.cholesky, jobs.cholesky)):
        _close(got, want, rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("noise", [False, True])
def test_linalg_revert_observation_logdet_and_lower_solve_match_reference(noise, dtype):
    np_dtype, rtol = DTYPES[dtype]
    rng, lower = _random(6, np_dtype)
    l_prev = _both(lower(B, 7, 7))
    h_l = _both(rng.standard_normal((B, 3, 7)).astype(np_dtype))
    l_noise = _both(lower(B, 3, 3)) if noise else (None, None)
    jout = jax.vmap(lambda a, b, c: jlinalg.revert_observation(a, b, c))(
        l_prev[0], h_l[0], l_noise[0]) if noise else jax.vmap(jlinalg.revert_observation)(
        l_prev[0], h_l[0])
    tout = tlinalg.revert_observation(l_prev[1], h_l[1], l_noise[1])
    for got, want in zip(tout, jout):
        _close(got, want, rtol)
    _close(tlinalg.tri_logdet(l_prev[1]), jax.vmap(jlinalg.tri_logdet)(l_prev[0]), rtol)
    rhs = _both(rng.standard_normal((B, 7, 2)).astype(np_dtype))
    _close(tlinalg.tri_solve_lower(l_prev[1], rhs[1]),
           jax.vmap(jlinalg.tri_solve_lower)(l_prev[0], rhs[0]), rtol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ts1_linearize_matches_reference(dtype):
    """TS1 ``linearize`` on the dense backend: the residual and the
    ``torch.func.jacfwd`` Jacobian of the rigid body, one IVP and a batch
    (mapped), in the state's dtype, against the reference's ``jax.jacfwd``."""
    np_dtype, rtol = DTYPES[dtype]
    jssm, tssm = _ssms("dense")
    jvf_p, _, _, params = jproblems.rigid_body()
    tvf_p, _, _, _ = tproblems.rigid_body()
    jstrat = jsolvers.strategy_filter(jssm, jsolvers.correction_ts1())
    tstrat = tsolvers.strategy_filter(tssm, tsolvers.correction_ts1())
    mean = _both(np.random.default_rng(7).standard_normal((B, N * D)).astype(np_dtype))
    t = _both(np.linspace(0.1, 0.5, B).astype(np_dtype))
    jz, (jjac,) = jax.vmap(lambda m, s: jsolvers.linearize(
        jstrat, lambda u, *, t: jvf_p(u, t=t, p=params), m, s))(mean[0], t[0])
    tvf = lambda u, *, t: tvf_p(u, t=t, p=params)  # noqa: E731
    tz, (tjac,) = tsolvers.linearize(tstrat, tvf, mean[1], t[1])
    _close(tz, jz, rtol)
    _close(tjac, jjac, rtol)
    z1, (jac1,) = tsolvers.linearize(tstrat, tvf, mean[1][0], t[1][0])
    _close(z1, np.asarray(jz[0]), rtol)
    _close(jac1, np.asarray(jjac[0]), rtol)


def test_register_makes_a_backend_choosable():
    class Custom(tssm_lib.IsotropicSSM):
        name = "isotropic"

    tssm_lib.register("custom-isotropic", Custom)
    try:
        prior = tsolvers.prior_ibm(num_derivatives=2, ode_shape=(3,),
                                   implementation="custom-isotropic")
        assert type(prior) is Custom and prior.n == 3
    finally:
        tssm_lib._BACKENDS.pop("custom-isotropic")
    with pytest.raises(ValueError, match="unknown implementation"):
        tsolvers.prior_ibm(num_derivatives=2, ode_shape=(3,), implementation="custom-isotropic")


def _rigid_save_at(impl, tol=1e-7, nu=3):
    vf_p, (u0,), tspan, params = tproblems.rigid_body()
    vf = lambda u, *, t: vf_p(u, t=t, p=params)  # noqa: E731
    prior = tsolvers.prior_ibm(num_derivatives=nu, ode_shape=(3,), implementation=impl)
    solver = tsolvers.solver_dynamic(tsolvers.strategy_fixedpoint(prior,
                                                                  tsolvers.correction_ts0()))
    tc = ttaylor.odejet_padded_scan(lambda u: vf(u, t=tspan[0]), (u0,), num=nu)
    return tivpsolve.solve_adaptive_save_at(
        vf, solver.initial_condition(tc, 1.0), save_at=np.linspace(*tspan, 6), dt0=0.1,
        adaptive_solver=tivpsolve.adaptive(solver, atol=tol, rtol=tol))


def test_blockdiag_matches_isotropic_solution():
    """Torch form of the reference's test of the same name: the blockdiag
    solve within rtol 1e-4 (atol 1e-7) of the isotropic one, with one output
    scale per dimension."""
    sol_bd, sol_iso = _rigid_save_at("blockdiag"), _rigid_save_at("isotropic")
    np.testing.assert_allclose(sol_bd.u.numpy(), sol_iso.u.numpy(), rtol=1e-4, atol=1e-7)
    assert sol_bd.output_scale.shape[-1] == 3


def test_blockdiag_save_at_matches_reference_step_for_step():
    """The same solve in the reference (tol 1e-7, f64): equal step counts,
    values to rtol 1e-10."""
    vf_p, (u0,), tspan, params = jproblems.rigid_body()
    from odecheckpts_tpu import taylor as jtaylor

    jvf = lambda u, *, t: vf_p(u, t=t, p=params)  # noqa: E731
    prior = jsolvers.prior_ibm(num_derivatives=3, ode_shape=(3,), implementation="blockdiag")
    solver = jsolvers.solver_dynamic(jsolvers.strategy_fixedpoint(prior,
                                                                  jsolvers.correction_ts0()))
    tc = jtaylor.odejet_padded_scan(lambda u: jvf(u, t=tspan[0]), (u0,), num=3)
    jsol = jax.jit(lambda: jivpsolve.solve_adaptive_save_at(
        jvf, solver.initial_condition(tc, 1.0), save_at=jnp.linspace(*tspan, 6), dt0=0.1,
        adaptive_solver=jivpsolve.adaptive(solver, atol=1e-7, rtol=1e-7)))()
    tsol = _rigid_save_at("blockdiag")
    np.testing.assert_array_equal(tsol.num_steps.numpy(), np.asarray(jsol.num_steps))
    _close(tsol.u, jsol.u, 1e-10)
