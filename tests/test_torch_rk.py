"""Port differential tests of ``rk`` (the adaptive Runge-Kutta and Nystrom
baselines) against the JAX reference, in float64.

The same numpy inputs go through both packages: every tableau's
coefficients equal the reference's; ``solve_rk_save_at`` gives the
reference's values to rtol 1e-10 with equal ``num_steps`` (one IVP, and an
ensemble with its batch axis written out against the reference's ``vmap``);
the Nystrom solvers likewise; the gradient of a mean squared error through
the adaptive Tsit5 solve equals ``jax.grad``'s to relative 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import control_flow as jcontrol_flow
from odecheckpts_tpu import problems as jproblems
from odecheckpts_tpu import rk as jrk
from odecheckpts_torch import control_flow, interop
from odecheckpts_torch import problems as tproblems
from odecheckpts_torch import rk as trk

METHODS = ("bosh3", "tsit5", "dopri5", "dopri8")


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("method", METHODS)
def test_tableaus_match_reference(method):
    want, got = jrk._TABLEAUS[method](), trk._TABLEAUS[method]()
    for field in ("name", "order", "a", "b", "b_err", "c", "fsal", "b_err2"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("problem", ["logistic", "rigid_body"])
def test_solve_rk_save_at_matches_reference(method, problem):
    jvf, (ju0,), tspan, params = getattr(jproblems, problem)()
    tvf = getattr(tproblems, problem)()[0]
    save_at = np.linspace(*tspan, num=5)
    want, want_steps = jax.jit(lambda: jrk.solve_rk_save_at(
        method, jvf, ju0, save_at=jnp.asarray(save_at), dt0=0.1, atol=1e-8, rtol=1e-8,
        params=params))()
    got, got_steps = trk.solve_rk_save_at(method, tvf, torch.tensor(np.asarray(ju0)),
                                          save_at=save_at, dt0=0.1, atol=1e-8, rtol=1e-8,
                                          params=params)
    assert int(got_steps) == int(want_steps)
    _close(got, want, 1e-10)


@pytest.mark.parametrize("method", ["bosh3", "dopri8"])
def test_solve_rk_ensemble_matches_reference_vmap(method):
    """Four rigid-body lanes with per-lane tolerances: each lane's steps and
    values are the reference's ``vmap`` of its one-IVP solve."""
    jvf, _, tspan, params = jproblems.rigid_body()
    tvf = tproblems.rigid_body()[0]
    rng = np.random.default_rng(0)
    u0s = np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((4, 3)))
    tols = np.array([1e-5, 1e-7, 1e-6, 1e-9])
    save_at = np.linspace(*tspan, num=4)

    def one(u0, tol):
        return jrk.solve_rk_save_at(method, jvf, u0, save_at=jnp.asarray(save_at), dt0=0.1,
                                    atol=tol, rtol=tol, params=params)

    want, want_steps = jax.jit(jax.vmap(one))(jnp.asarray(u0s), jnp.asarray(tols))
    got, got_steps = trk.solve_rk_save_at(method, tvf, torch.tensor(u0s), save_at=save_at,
                                          dt0=0.1, atol=torch.tensor(tols),
                                          rtol=torch.tensor(tols), params=params)
    np.testing.assert_array_equal(got_steps.numpy(), np.asarray(want_steps))
    _close(got.movedim(1, 0), want, 1e-10)


def _harmonic(u, *, t=None, p=()):
    return -u


@pytest.mark.parametrize("method", ["verlet2", "yoshida4"])
def test_nystrom_save_at_matches_reference(method):
    save_at = np.linspace(0.0, 6.0, 5)
    u0, du0 = np.array([1.0, 0.5]), np.array([0.0, -0.3])
    (wu, wv), wn = jax.jit(lambda: jrk.solve_nystrom_save_at(
        method, _harmonic, jnp.asarray(u0), jnp.asarray(du0), save_at=jnp.asarray(save_at),
        dt0=0.1, atol=1e-8, rtol=1e-8))()
    (gu, gv), gn = trk.solve_nystrom_save_at(method, _harmonic, torch.tensor(u0),
                                             torch.tensor(du0), save_at=save_at, dt0=0.1,
                                             atol=1e-8, rtol=1e-8)
    assert int(gn) == int(wn)
    _close(gu, wu, 1e-10)
    _close(gv, wv, 1e-10)


@pytest.mark.parametrize("method", ["verlet2", "yoshida4"])
def test_nystrom_fixed_matches_reference(method):
    grid = np.linspace(0.0, 2.0 * np.pi, 65)
    u0, du0 = np.array([1.0]), np.array([0.0])
    wu, wv = jrk.solve_nystrom_fixed(method, _harmonic, jnp.asarray(u0), jnp.asarray(du0),
                                     grid=jnp.asarray(grid))
    gu, gv = trk.solve_nystrom_fixed(method, _harmonic, torch.tensor(u0),
                                     torch.tensor(du0), grid=grid)
    _close(gu, wu, 1e-12)
    _close(gv, wv, 1e-12)


def test_nystrom_rejects_unknown_method():
    u0, du0 = torch.tensor([1.0]), torch.tensor([0.0])
    with pytest.raises(ValueError, match="Nystrom"):
        trk.solve_nystrom_save_at("rkn64", _harmonic, u0, du0,
                                  save_at=torch.tensor([0.0, 1.0]), dt0=0.1, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="Nystrom"):
        trk.solve_nystrom_fixed("rkn64", _harmonic, u0, du0, grid=torch.tensor([0.0, 1.0]))


def _softplus_mlp(lib):
    """Experiment 7's softplus MLP vector field
    (``experiments/7_learn_ode_dynamics/learn_ode.py:52-76``)."""
    log, exp = (jnp.log, jnp.exp) if lib is jnp else (torch.log, torch.exp)

    def vf(u, *, t=None, p=None):
        x = u
        for w, b in p[:-1]:
            x = log(1.0 + exp(x @ w + b))
        w, b = p[-1]
        return x @ w + b

    return vf


def _mlp_params(seed=1, sizes=(2, 4, 4, 2)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((a, b)) / np.sqrt(a), rng.standard_normal(b) / np.sqrt(a))
            for a, b in zip(sizes[:-1], sizes[1:])]


def test_rk_mse_gradient_matches_jax_grad():
    """MSE of two trajectories through the adaptive Tsit5 solve against
    data, differentiated in the MLP's weights: the port's autograd against
    ``jax.grad`` of the reference's ``vmap``ped loss, relative 1e-8."""
    params = _mlp_params()
    rng = np.random.default_rng(2)
    save_at = np.linspace(0.0, 2.0, 8)
    u0s = rng.uniform(-0.6, 1.0, (2, 2))
    ys = rng.standard_normal((2, 8, 2)) * 0.3

    def jloss(p):
        def one(u0, y):
            u, _ = jrk.solve_rk_save_at("tsit5", _softplus_mlp(jnp), u0,
                                        save_at=jnp.asarray(save_at), dt0=0.1, atol=1e-6,
                                        rtol=1e-6, params=p)
            return jnp.mean((u - y) ** 2)

        return jnp.mean(jax.vmap(one)(jnp.asarray(u0s), jnp.asarray(ys)))

    jparams = [tuple(jnp.asarray(x) for x in layer) for layer in params]
    with jcontrol_flow.overwrite_with_bounded(max_steps=256):
        want_l, want_g = jax.jit(jax.value_and_grad(jloss))(jparams)

    tparams = interop.params_to_torch(params)
    leaves = [x.requires_grad_(True) for layer in tparams for x in layer]
    with control_flow.overwrite_with_bounded(max_steps=256):
        u, _ = trk.solve_rk_save_at("tsit5", _softplus_mlp(torch), torch.tensor(u0s),
                                    save_at=save_at, dt0=0.1, atol=1e-6, rtol=1e-6,
                                    params=tparams)
        loss = torch.mean((u.movedim(1, 0) - torch.tensor(ys)) ** 2)
        grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-10)
    for g, w in zip(grads, [np.asarray(x) for layer in want_g for x in layer], strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8, atol=1e-8 * np.max(np.abs(w)))
