"""Port differential tests of the training path (``control_flow``,
``train`` and reverse-mode gradients through the adaptive solve) against the
JAX reference, in float64.

* the bounded loop equals the unbounded one (values and gradients, with and
  without ``remat``), and counts the lanes it leaves at its bound;
* d(Taylor coefficients)/d(weights) of the tanh MLP equals ``jax.jacrev``;
* ``linalg.qr_r``'s gradient equals ``jax.grad``'s (with the power-of-two
  rescaling engaged and not);
* the nlml and its gradient on ``tests/test_train.py``'s logistic setup and
  on experiment 7's softplus MLP (two trajectories, 12 points, the weights
  carried through ``interop``) equal the reference's to relative 1e-8;
* ``fit`` with ``torch.optim.Adam`` follows ``optax.adam`` over 10 steps to
  1e-8.

The reference's losses are jitted under its bounded loop
(``control_flow.overwrite_with_bounded``), computed once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import control_flow as jcontrol_flow
from odecheckpts_tpu import facade as jfacade
from odecheckpts_tpu import linalg as jlinalg
from odecheckpts_tpu import problems as jproblems
from odecheckpts_tpu import stats as jstats
from odecheckpts_tpu import taylor as jtaylor
from odecheckpts_tpu import train as jtrain
from odecheckpts_torch import control_flow, interop, linalg
from odecheckpts_torch import facade as tfacade
from odecheckpts_torch import problems as tproblems
from odecheckpts_torch import stats as tstats
from odecheckpts_torch import taylor as ttaylor
from odecheckpts_torch import train as ttrain

GRAD_RTOL = 1e-8


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-30))


# -- the bounded loop ----------------------------------------------------------


def _geometric(lib):
    def cond(c):
        return c[0] < 100.0

    def body(c):
        return (c[0] + c[1], c[1] * 1.1)

    return cond, body


def test_bounded_while_loop_matches_unbounded_and_reference():
    cond, body = _geometric(torch)
    init = (torch.tensor(0.0, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64))
    a = control_flow.while_loop(cond, body, init)
    b = control_flow.bounded_while_loop(cond, body, init, max_steps=100)
    want = jcontrol_flow.bounded_while_loop(*_geometric(jnp), (jnp.asarray(0.0),
                                                               jnp.asarray(1.0)), max_steps=100)
    for x, y, w in zip(a, b, want):
        assert float(x) == float(y)
        np.testing.assert_allclose(float(y), float(w), rtol=1e-14)


def test_bounded_loop_masks_lanes_and_counts_capped_ones():
    """Per-lane trip counts (a lane stops where its ``cond`` turns false);
    lanes still running at the bound keep their state there and are
    counted."""
    def cond(c):
        return c[0] < c[1]

    def body(c):
        return (c[0] + 1.0, c[1])

    init = (torch.zeros(3, dtype=torch.float64), torch.tensor([2.0, 5.0, 9.0],
                                                              dtype=torch.float64))
    full = control_flow.while_loop(cond, body, init)
    control_flow.reset_counters()
    capped = control_flow.bounded_while_loop(cond, body, init, max_steps=6, remat=False)
    np.testing.assert_array_equal(full[0].numpy(), [2.0, 5.0, 9.0])
    np.testing.assert_array_equal(capped[0].numpy(), [2.0, 5.0, 6.0])
    assert control_flow.counters == {"attempts": 6, "capped_lanes": 1}


# -- the logistic setup of tests/test_train.py ------------------------------------


def _logistic_vf(u, *, t, p):
    return p * u * (1.0 - u)


SAVE_AT = np.linspace(0.0, 2.0, num=8)
U0 = np.array([0.2])


@functools.lru_cache(maxsize=None)
def _logistic_data():
    """The reference's observations of ``tests/test_train.py::_data``."""
    solve_true = jfacade.solve("ts0-3", _logistic_vf, jnp.zeros(1), jnp.asarray(SAVE_AT),
                               dt0=0.1, atol=1e-6, rtol=1e-6, calibrate="none")
    with jcontrol_flow.overwrite_with_bounded(max_steps=128):
        y = jax.jit(lambda: solve_true((jnp.asarray(U0),), 1.4)[0])()
    return np.asarray(y)[:, 0]


def _logistic_losses(tol=1e-5):
    y = _logistic_data()
    jsolve = jfacade.solve("ts0-3", _logistic_vf, jnp.zeros(1), jnp.asarray(SAVE_AT), dt0=0.1,
                           atol=tol, rtol=tol, calibrate="none")
    jloss = jtrain.nlml(jsolve, jtrain.Observations(jnp.asarray(SAVE_AT), jnp.asarray(y), 1e-3),
                        u0=(jnp.asarray(U0),))
    tsolve = tfacade.solve("ts0-3", _logistic_vf, np.zeros(1), SAVE_AT, dt0=0.1, atol=tol,
                           rtol=tol, calibrate="none")
    tloss = ttrain.nlml(tsolve, ttrain.Observations(torch.tensor(SAVE_AT), torch.tensor(y), 1e-3),
                        u0=(torch.tensor(U0),))
    return jloss, tloss


@functools.lru_cache(maxsize=None)
def _reference_value_and_grad():
    """The reference's jitted loss and gradient under its bounded loop (128
    attempts), as ``jtrain.gradient_step`` forms them."""
    jloss, _ = _logistic_losses()
    with jcontrol_flow.overwrite_with_bounded(max_steps=128):
        fn = jax.jit(jax.value_and_grad(jloss))
        fn(jnp.asarray(1.0))  # trace under the bounded loop
    return fn


def _reference_logistic_grads():
    fn = _reference_value_and_grad()
    return {theta: tuple(float(v) for v in fn(jnp.asarray(theta))) for theta in (1.0, 1.4)}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_logistic_nlml_gradient_matches_jax_grad(remat):
    want = _reference_logistic_grads()
    _, tloss = _logistic_losses()
    got = {}
    for theta in (1.0, 1.4):
        th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
        with control_flow.overwrite_with_bounded(max_steps=128, remat=remat):
            loss = tloss(th)
            (grad,) = torch.autograd.grad(loss, th)
        got[theta] = (float(loss.detach()), float(grad))
        np.testing.assert_allclose(got[theta], want[theta], rtol=GRAD_RTOL)
    # the reference's own assertions: the truth has the lower loss, and the
    # gradient at 1.0 points towards it
    assert got[1.4][0] < got[1.0][0] and got[1.0][1] < 0.0


def test_unbounded_loop_gives_the_bounded_gradient():
    """Autograd through the default loop (no bound) gives the bounded loop's
    loss and gradient exactly: the bound only caps the attempts."""
    _, tloss = _logistic_losses()
    out = []
    for bounded in (True, False):
        th = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        if bounded:
            with control_flow.overwrite_with_bounded(max_steps=128):
                loss = tloss(th)
        else:
            loss = tloss(th)
        out.append((float(loss.detach()), float(torch.autograd.grad(loss, th)[0])))
    assert out[0] == out[1]


# -- Taylor coefficients and qr_r ------------------------------------------------------


def test_taylor_coefficients_gradient_matches_jacrev():
    """d(the Taylor coefficients of the tanh MLP field at u0)/d(weights):
    the port's nested ``torch.func.jvp`` under autograd against
    ``jax.jacrev`` of the reference's ``jet``."""
    jvf, (ju0,), _, (jparams,) = jproblems.neural_ode_mlp(layer_sizes=(2, 5, 1))
    tvf = tproblems.neural_ode_mlp(layer_sizes=(2, 5, 1))[0]
    num = 4

    def jcoeffs(params):
        tc = jtaylor.odejet_padded_scan(lambda u: jvf(u, t=0.0, p=(params,)), (ju0,), num=num)
        return jnp.stack(tc)

    want_value = jcoeffs(jparams)
    want = jax.jacrev(jcoeffs)(jparams)  # a list of (dw, db) of shape (num + 1, 1, ...)

    tparams = interop.params_to_torch(jax.tree.map(np.asarray, jparams))
    leaves = [x.requires_grad_(True) for layer in tparams for x in layer]
    tc = torch.stack(ttaylor.odejet_padded_scan(
        lambda u: tvf(u, t=0.0, p=(tparams,)), (torch.tensor(np.asarray(ju0)),), num=num))
    _close(tc, want_value, 1e-12)
    rows = [torch.autograd.grad(tc[k, 0], leaves, retain_graph=True) for k in range(num + 1)]
    want_leaves = [np.asarray(x) for layer in want for x in layer]
    for i, w in enumerate(want_leaves):
        got = torch.stack([row[i] for row in rows])  # (num + 1, ...)
        _close(got, w[:, 0], 1e-12)


@pytest.mark.parametrize("scale", [1.0, 1e120], ids=["plain", "rescaled"])
def test_qr_r_gradient_matches_jax_grad(scale):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 7, 4)) * scale
    x[1, :, 2] = 0.0  # an exactly zero column (rank-deficient, as after a correction)
    w = rng.standard_normal((3, 4, 4))
    want = jax.jit(jax.grad(lambda a: jnp.sum(jnp.asarray(w) * jlinalg.qr_r(a) / scale)))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    torch.sum(torch.tensor(w) * linalg.qr_r(xt) / scale).backward()
    assert bool(torch.all(torch.isfinite(xt.grad)))
    _close(xt.grad, want, 1e-10)


# -- experiment 7's MLP -------------------------------------------------------------------


def _softplus_mlp(log, exp):
    def vf(u, *, t=None, p=None):
        x = u
        for w, b in p[:-1]:
            x = log(1.0 + exp(x @ w + b))
        w, b = p[-1]
        return x @ w + b

    return vf


def test_experiment7_batched_nlml_gradient_matches_reference_vmap():
    """Experiment 7's loss (``experiments/7_learn_ode_dynamics/learn_ode.py:
    117-149``) on two trajectories of 12 points: the batch mean of -lml
    through ``facade.solve("ts0-4", dt0=1, tol 1e-3, calibrate="none")``
    under the bounded loop (512 attempts), and its gradient in the (2, 4, 4,
    2) MLP's weights, against the reference's ``vmap``ped loss."""
    rng = np.random.default_rng(5)
    sizes = (2, 4, 4, 2)
    params = [(rng.standard_normal((a, b)) / np.sqrt(a), rng.standard_normal(b) / np.sqrt(a))
              for a, b in zip(sizes[:-1], sizes[1:])]
    ts = np.linspace(0.0, 10.0, 48)[:12]
    ys = rng.uniform(-0.6, 1.0, (2, 1, 2)) * np.cos(ts)[None, :, None]  # (B, T, 2)

    jsolve = jfacade.solve("ts0-4", _softplus_mlp(jnp.log, jnp.exp), jnp.zeros(2),
                           jnp.asarray(ts), dt0=1.0, atol=1e-3, rtol=1e-3, calibrate="none")

    def jloss(p):
        def one(y):
            _u, aux = jsolve((y[0],), p)
            return -jstats.log_marginal_likelihood(y, standard_deviation=1e-2 * jnp.ones(len(ts)),
                                                   posterior=aux["solution"].posterior)

        return jnp.mean(jax.vmap(one)(jnp.asarray(ys)))

    with jcontrol_flow.overwrite_with_bounded(max_steps=512):
        want_l, want_g = jax.jit(jax.value_and_grad(jloss))(
            [tuple(map(jnp.asarray, layer)) for layer in params])

    tsolve = tfacade.solve("ts0-4", _softplus_mlp(torch.log, torch.exp), np.zeros(2), ts,
                           dt0=1.0, atol=1e-3, rtol=1e-3, calibrate="none")
    tparams = interop.params_to_torch(params)
    leaves = [x.requires_grad_(True) for layer in tparams for x in layer]
    ys_t = torch.tensor(ys).movedim(0, 1)  # (T, B, 2): time-leading, as the solution
    loss = ttrain.nlml(tsolve, ttrain.Observations(torch.tensor(ts), ys_t, 1e-2),
                       u0=(ys_t[0],))
    with control_flow.overwrite_with_bounded(max_steps=512):
        value = loss(tparams)
        grads = torch.autograd.grad(value, leaves)
    np.testing.assert_allclose(float(value.detach()), float(want_l), rtol=GRAD_RTOL)
    for g, w in zip(grads, [np.asarray(x) for layer in want_g for x in layer], strict=True):
        _close(g, w, GRAD_RTOL)


def test_stats_and_train_losses_agree_on_an_ensemble():
    """``train.nlml`` of an ensemble is the mean of ``stats``' per-lane
    log-likelihoods."""
    tsolve = tfacade.solve("ts0-3", _logistic_vf, np.zeros(1), SAVE_AT, dt0=0.1, atol=1e-5,
                           rtol=1e-5, calibrate="none")
    u0s = torch.tensor([[0.2], [0.3]], dtype=torch.float64)
    ys = torch.tensor(_logistic_data())[:, None, None].expand(8, 2, 1)
    loss = ttrain.nlml(tsolve, ttrain.Observations(torch.tensor(SAVE_AT), ys, 1e-3), u0=(u0s,))
    _u, aux = tsolve((u0s,), torch.tensor(1.2, dtype=torch.float64))
    lml = tstats.log_marginal_likelihood(ys, standard_deviation=1e-3,
                                         posterior=aux["solution"].posterior)
    assert lml.shape == (2,)
    assert float(loss(torch.tensor(1.2, dtype=torch.float64))) == float(-lml.mean())


# -- fit ---------------------------------------------------------------------------


def test_fit_adam_follows_optax_adam():
    optax = pytest.importorskip("optax")
    _, tloss = _logistic_losses()
    # the reference's fit loop (train.py:124-130) on its jitted loss and gradient
    fn, opt = _reference_value_and_grad(), optax.adam(0.1)
    want_theta, want_losses = jnp.asarray(0.8), []
    state = opt.init(want_theta)
    with jcontrol_flow.overwrite_with_bounded(max_steps=128):
        for _ in range(10):
            value, grad = fn(want_theta)
            updates, state = opt.update(grad, state)
            want_theta = optax.apply_updates(want_theta, updates)
            want_losses.append(float(value))
    got_theta, got_losses = ttrain.fit(
        tloss, torch.tensor(0.8, dtype=torch.float64),
        functools.partial(torch.optim.Adam, lr=0.1), num_steps=10, max_solver_steps=128)
    np.testing.assert_allclose(got_losses, want_losses, rtol=GRAD_RTOL)
    np.testing.assert_allclose(float(got_theta), float(want_theta), rtol=GRAD_RTOL)


def test_fit_keeps_progress_on_keyboard_interrupt():
    def loss_fn(theta):
        return torch.sum((theta["w"] - 1.0) ** 2)

    def callback(i, value):
        if i == 2:
            raise KeyboardInterrupt

    theta0 = {"w": torch.zeros(2, dtype=torch.float64)}
    theta, losses = ttrain.fit(loss_fn, theta0, functools.partial(torch.optim.SGD, lr=0.1),
                               num_steps=10, callback=callback)
    assert len(losses) == 3 and set(theta) == {"w"}
    assert float(theta0["w"].abs().max()) == 0.0  # the start is not changed
    np.testing.assert_allclose(theta["w"].numpy(), [1.0 - 0.8**3] * 2, rtol=1e-12)


@pytest.mark.slow
def test_optimization_recovers_parameter():
    """Fit to convergence (``tests/test_train.py::test_optimization_recovers_
    parameter``): 60 Adam steps from 0.8 find the logistic rate 1.4."""
    _, tloss = _logistic_losses(tol=1e-6)
    theta, losses = ttrain.fit(tloss, torch.tensor(0.8, dtype=torch.float64),
                               functools.partial(torch.optim.Adam, lr=0.1), num_steps=60,
                               max_solver_steps=256)
    assert abs(float(theta) - 1.4) < 0.05, (theta, losses[-5:])
