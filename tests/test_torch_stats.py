"""Port differential tests of ``stats`` (the marginal likelihood, joint
sampling and off-grid marginals) and of the SSM methods they call
(``condition_qoi``, ``qoi_from_sample``, ``base_shape``, ``transform_base``,
``conditional_sample``) against the JAX reference, in float64.

Posteriors are solved once per backend by the reference (module-scope
fixtures) and carried into the port with ``interop``; the data and the
methods' random inputs come from numpy seeds; ``markov_sample`` takes the
reference's own noise (``jax.random.split`` and ``normal``, as
``odecheckpts_tpu/stats.py:110-115`` draws it).  Tolerances: the SSM
methods 1e-12, ``log_marginal_likelihood`` relative 1e-10 on every backend,
the brute-force joint Gaussian 1e-8, samples and off-grid marginals 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_lml_bruteforce import _dense_joint

from odecheckpts_tpu import ivpsolve as jivpsolve
from odecheckpts_tpu import ivpsolvers as jsolvers
from odecheckpts_tpu import problems as jproblems
from odecheckpts_tpu import stats as jstats
from odecheckpts_tpu import taylor as jtaylor
from odecheckpts_tpu.ssm.base import Conditional as JConditional
from odecheckpts_tpu.ssm.base import Normal as JNormal
from odecheckpts_torch import interop
from odecheckpts_torch import ivpsolve as tivpsolve
from odecheckpts_torch import ivpsolvers as tsolvers
from odecheckpts_torch import problems as tproblems
from odecheckpts_torch import stats as tstats
from odecheckpts_torch import taylor as ttaylor
from odecheckpts_torch.ssm.base import Conditional, MarkovSeq, Normal

BACKENDS = ("isotropic", "dense", "blockdiag")
NU, D, B = 3, 3, 4
N = NU + 1


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-30))


def _ssms(impl, d=D):
    return (jsolvers.prior_ibm(num_derivatives=NU, ode_shape=(d,), implementation=impl),
            tsolvers.prior_ibm(num_derivatives=NU, ode_shape=(d,), implementation=impl))


def _rv(impl, rng, batch=()):
    """A random state of one backend's layout (lower factors, a positive
    diagonal), with leading batch axes."""
    shapes = {"isotropic": ((N, D), (N, N)), "dense": ((N * D,), (N * D, N * D)),
              "blockdiag": ((D, N), (D, N, N))}[impl]
    mean = rng.standard_normal(batch + shapes[0])
    k = shapes[1][-1]
    chol = np.tril(rng.standard_normal(batch + shapes[1])) + 2.0 * np.eye(k)
    return mean, chol


def _to_torch_seq(jseq, tssm):
    """A reference ``MarkovSeq`` as the port's, through numpy."""
    init = Normal(*interop.to_torch((np.asarray(jseq.init.mean), np.asarray(jseq.init.cholesky))))
    c = jseq.conditional
    cond = Conditional(interop.to_torch(np.asarray(c.matrix)), Normal(
        *interop.to_torch((np.asarray(c.noise.mean), np.asarray(c.noise.cholesky)))))
    return MarkovSeq(init, cond, ssm=tssm)


@pytest.fixture(scope="module")
def posteriors():
    """One fixedpoint save_at solve of the rigid body per backend (TS0, nu
    = 3, dynamic calibration, tol 1e-6, 6 checkpoints), by the reference,
    and the port's copy of each posterior."""
    vf_p, (u0,), _tspan, params = jproblems.rigid_body()

    def vf(u, *, t):
        return vf_p(u, t=t, p=params)

    save_at = jnp.linspace(0.0, 3.0, 6)
    out = {}
    for impl in BACKENDS:
        jssm, tssm = _ssms(impl)
        strat = jsolvers.strategy_fixedpoint(jssm, jsolvers.correction_ts0())
        solver = jsolvers.solver_dynamic(strat)
        tc = jtaylor.odejet_padded_scan(lambda u: vf(u, t=0.0), (u0,), num=NU)
        init = solver.initial_condition(tc, 1.0)
        asolver = jivpsolve.adaptive(solver, atol=1e-6, rtol=1e-6)
        sol = jax.jit(lambda init=init, asolver=asolver: jivpsolve.solve_adaptive_save_at(
            vf, init, save_at=save_at, dt0=0.1, adaptive_solver=asolver))()
        out[impl] = (sol, _to_torch_seq(sol.posterior, tssm))
    return out


@pytest.mark.parametrize("impl", BACKENDS)
@pytest.mark.parametrize("batched", [False, True], ids=["one", "batched"])
def test_condition_qoi_matches_reference(impl, batched):
    rng = np.random.default_rng(3)
    jssm, tssm = _ssms(impl)
    batch = (B,) if batched else ()
    mean, chol = _rv(impl, rng, batch)
    data = rng.standard_normal(batch + (D,))
    std = 0.3
    if batched:
        want_ll, want_rv = jax.vmap(lambda m, c, y: jssm.condition_qoi(JNormal(m, c), y, std))(
            jnp.asarray(mean), jnp.asarray(chol), jnp.asarray(data))
    else:
        want_ll, want_rv = jssm.condition_qoi(JNormal(jnp.asarray(mean), jnp.asarray(chol)),
                                              jnp.asarray(data), std)
    got_ll, got_rv = tssm.condition_qoi(Normal(*interop.to_torch((mean, chol))),
                                        torch.tensor(data), std)
    _close(got_ll, want_ll, 1e-12)
    _close(got_rv.mean, want_rv.mean, 1e-12)
    _close(got_rv.cholesky, want_rv.cholesky, 1e-12)


@pytest.mark.parametrize("impl", BACKENDS)
def test_sampling_methods_match_reference(impl):
    rng = np.random.default_rng(4)
    jssm, tssm = _ssms(impl)
    assert tssm.base_shape() == jssm.base_shape()
    mean, chol = _rv(impl, rng)
    gain = np.tril(rng.standard_normal(chol.shape)) + np.triu(rng.standard_normal(chol.shape))
    xi = rng.standard_normal((2,) + jssm.base_shape())
    x = rng.standard_normal((2,) + jssm.base_shape())
    jrv = JNormal(jnp.asarray(mean), jnp.asarray(chol))
    trv = Normal(*interop.to_torch((mean, chol)))
    _close(tssm.transform_base(trv, torch.tensor(xi)), jssm.transform_base(jrv, jnp.asarray(xi)),
           1e-12)
    jcond = JConditional(jnp.asarray(gain), jrv)
    tcond = Conditional(torch.tensor(gain), trv)
    want = jssm.conditional_sample(jcond, jnp.asarray(x), jnp.asarray(xi))
    got = tssm.conditional_sample(tcond, torch.tensor(x), torch.tensor(xi))
    _close(got, want, 1e-12)
    _close(tssm.qoi_from_sample(got), jssm.qoi_from_sample(want), 1e-12)


@pytest.mark.parametrize("impl", BACKENDS)
def test_log_marginal_likelihood_matches_reference(posteriors, impl):
    jsol, tseq = posteriors[impl]
    rng = np.random.default_rng(5)
    data = np.asarray(jsol.u) + 0.05 * rng.standard_normal(np.shape(jsol.u))
    std = 0.03 * (1.0 + rng.random(len(data)))
    want = jstats.log_marginal_likelihood(jnp.asarray(data), standard_deviation=jnp.asarray(std),
                                          posterior=jsol.posterior)
    got = tstats.log_marginal_likelihood(torch.tensor(data), standard_deviation=torch.tensor(std),
                                         posterior=tseq)
    assert got.dtype == torch.float64 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


def test_log_marginal_likelihood_batched_equals_lanes(posteriors):
    """An ensemble's posterior (time-leading, then the batch axis) gives each
    lane's likelihood; a scalar standard deviation broadcasts."""
    _, tseq = posteriors["isotropic"]
    lanes = [tseq, MarkovSeq(Normal(tseq.init.mean * 1.1, tseq.init.cholesky * 0.9),
                             tseq.conditional, ssm=tseq.ssm)]

    def stack(*xs):
        return torch.stack(xs, dim=1)

    batched = MarkovSeq(
        Normal(*(stack(a, b) for a, b in zip(lanes[0].init, lanes[1].init))),
        Conditional(stack(lanes[0].conditional.matrix, lanes[1].conditional.matrix),
                    Normal(*(stack(a, b) for a, b in zip(lanes[0].conditional.noise,
                                                         lanes[1].conditional.noise)))),
        ssm=tseq.ssm)
    data = lanes[0].init.mean[:, 0, :]
    got = tstats.log_marginal_likelihood(stack(data, data * 0.98), standard_deviation=0.05,
                                         posterior=batched)
    want = [tstats.log_marginal_likelihood(y, standard_deviation=0.05, posterior=s)
            for y, s in zip((data, data * 0.98), lanes)]
    assert got.shape == (2,)
    _close(got, torch.stack(want), 1e-14)


def test_log_marginal_likelihood_matches_dense_joint_gaussian():
    """The port's own solve of the reference's brute-force case
    (``tests/test_lml_bruteforce.py``): the backward Kalman pass equals the
    joint-Gaussian log-density of the observations."""
    vf, u0s, tspan, params = tproblems.logistic()
    nu, d, num = 2, 1, 5
    n = nu + 1
    prior = tsolvers.prior_ibm(num_derivatives=nu, ode_shape=(d,))
    solver = tsolvers.solver_dynamic(tsolvers.strategy_fixedpoint(prior,
                                                                  tsolvers.correction_ts0()))

    def vf_p(u, *, t):
        return vf(u, t=t, p=params)

    tco = ttaylor.odejet_padded_scan(lambda u: vf_p(u, t=tspan[0]), u0s, num=nu)
    sol = tivpsolve.solve_adaptive_save_at(
        vf_p, solver.initial_condition(tco, 1.0), save_at=np.linspace(*tspan, num=num), dt0=0.1,
        adaptive_solver=tivpsolve.adaptive(solver, atol=1e-6, rtol=1e-6))
    data = sol.u + 0.05 * torch.tensor(np.random.default_rng(0).standard_normal(sol.u.shape))
    sigma = 0.03
    lml = float(tstats.log_marginal_likelihood(data, standard_deviation=sigma * torch.ones(num),
                                               posterior=sol.posterior))

    mean, cov = _dense_joint(tstats.markov_select_terminal(sol.posterior), n, d, num)
    h = np.zeros((num * d, num * n * d))
    for k in range(num):
        for i in range(d):
            h[k * d + i, k * n * d + i] = 1.0
    resid = data.numpy().reshape(num * d) - h @ mean
    chol = np.linalg.cholesky(h @ cov @ h.T + sigma**2 * np.eye(num * d))
    white = np.linalg.solve(chol, resid)
    want = float(-0.5 * white @ white - np.sum(np.log(np.diag(chol)))
                 - 0.5 * num * d * np.log(2 * np.pi))
    np.testing.assert_allclose(lml, want, rtol=1e-8)


def test_log_marginal_likelihood_gradient_matches_reference(posteriors):
    """d lml / d data (the reference's ``test_log_marginal_likelihood_
    differentiable``, on every entry of the data)."""
    jsol, tseq = posteriors["isotropic"]
    data = np.asarray(jsol.u) + 0.01

    def jloss(y):
        return -jstats.log_marginal_likelihood(y, standard_deviation=1e-2,
                                               posterior=jsol.posterior)

    want = jax.grad(jloss)(jnp.asarray(data))
    y = torch.tensor(data, requires_grad=True)
    (-tstats.log_marginal_likelihood(y, standard_deviation=1e-2, posterior=tseq)).backward()
    _close(y.grad, want, 1e-9)


@pytest.mark.parametrize("impl", BACKENDS)
@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_markov_sample_with_reference_noise(posteriors, impl, parallel):
    jsol, tseq = posteriors[impl]
    jseq = jstats.markov_select_terminal(jsol.posterior)
    shape = (3,)
    key = jax.random.PRNGKey(7)
    (jq, js), (jqt, jst) = jstats.markov_sample(key, jseq, shape=shape, parallel=parallel)
    # the reference's draws, as stats.py:110-115 makes them
    num = jseq.conditional.matrix.shape[0]
    k_init, k_steps = jax.random.split(key)
    eps_init = jax.random.normal(k_init, shape + jseq.init.mean.shape, jnp.float64)
    eps_steps = jax.random.normal(k_steps, (num,) + shape + jseq.ssm.base_shape(), jnp.float64)
    (tq, ts_), (tqt, tst) = tstats.markov_sample(
        (torch.tensor(np.asarray(eps_init)), torch.tensor(np.asarray(eps_steps))),
        tstats.markov_select_terminal(tseq), shape=shape, parallel=parallel)
    for got, want in ((tq, jq), (ts_, js), (tqt, jqt), (tst, jst)):
        _close(got, want, 1e-10)


def test_markov_sample_generator_means_converge_on_an_ensemble(posteriors):
    """With a ``torch.Generator`` on a two-lane ensemble: the sample shapes
    (the sample axes, then time, then the batch axes) and the sample means
    at the backward marginals' means (the reference's
    ``test_markov_sample_mean_converges_to_marginal_means``)."""
    _, tseq = posteriors["isotropic"]

    def stack(x):
        return torch.stack([x, x], dim=1)

    seq = tstats.markov_select_terminal(MarkovSeq(
        Normal(stack(tseq.init.mean), stack(tseq.init.cholesky)),
        Conditional(stack(tseq.conditional.matrix),
                    Normal(stack(tseq.conditional.noise.mean),
                           stack(tseq.conditional.noise.cholesky))), ssm=tseq.ssm))
    gen = torch.Generator().manual_seed(0)
    (qoi, samples), (qoi_t, sample_t) = tstats.markov_sample(gen, seq, shape=(4000,))
    num = seq.conditional.matrix.shape[0]
    assert qoi.shape == (4000, num, 2, D) and samples.shape == (4000, num, 2, N, D)
    assert qoi_t.shape == (4000, 2, D) and sample_t.shape == (4000, 2, N, D)
    margs = tstats.markov_marginals(seq)
    want = torch.cat([margs.mean[:, :, 0], seq.init.mean[None, :, 0]])
    got = torch.cat([qoi, qoi_t[:, None]], dim=1).mean(0)
    spread = torch.cat([margs.cholesky, seq.init.cholesky[None]]).abs().amax()
    assert float((got - want).abs().max()) < 5.0 * float(spread) / np.sqrt(4000.0)


@pytest.fixture(scope="module")
def every_step():
    """A save-every-step smoother solve of the logistic problem by the
    reference (TS0(3), dynamic calibration, tol 1e-6 on (0, 2.5))."""
    vf_p, (u0,), tspan, params = jproblems.logistic()

    def vf(u, *, t):
        return vf_p(u, t=t, p=params)

    prior = jsolvers.prior_ibm(num_derivatives=3, ode_shape=(1,))
    solver = jsolvers.solver_dynamic(jsolvers.strategy_smoother(prior, jsolvers.correction_ts0()))
    tc = jtaylor.odejet_padded_scan(lambda u: vf(u, t=0.0), (u0,), num=3)
    sol = jivpsolve.solve_adaptive_save_every_step(
        vf, solver.initial_condition(tc, 1.0), t0=tspan[0], t1=tspan[1], dt0=0.1,
        adaptive_solver=jivpsolve.adaptive(solver, atol=1e-6, rtol=1e-6))
    return sol, solver


def test_offgrid_marginals_searchsorted_matches_reference(every_step):
    jsol, jsolver = every_step
    grid = np.asarray(jsol.t)
    rng = np.random.default_rng(6)
    # interior times, two exactly on grid points (the snapped branches)
    ts = np.sort(np.concatenate([rng.uniform(grid[0], grid[-1], 9), grid[[3, 7]]]))
    want_u, want = jstats.offgrid_marginals_searchsorted(ts=jnp.asarray(ts), solution=jsol,
                                                         solver=jsolver)
    tssm = tsolvers.prior_ibm(num_derivatives=3, ode_shape=(1,))
    post = _to_torch_seq(jsol.posterior, tssm)
    from odecheckpts_torch.ssm.base import Solution

    tsol = Solution(t=torch.tensor(grid), u=torch.tensor(np.asarray(jsol.u)),
                    u_std=torch.tensor(np.asarray(jsol.u_std)),
                    output_scale=torch.tensor(np.asarray(jsol.output_scale)), marginals=None,
                    posterior=post, num_steps=torch.tensor(np.asarray(jsol.num_steps)), ssm=tssm)
    got_u, got = tstats.offgrid_marginals_searchsorted(ts=torch.tensor(ts), solution=tsol,
                                                       solver=None)
    _close(got_u, want_u, 1e-10)
    _close(got.mean, want.mean, 1e-10)
    _close(got.cholesky @ got.cholesky.transpose(-1, -2),
           np.asarray(want.cholesky) @ np.swapaxes(np.asarray(want.cholesky), -1, -2), 1e-10)
