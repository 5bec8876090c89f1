"""Port differential tests of ``facade`` (the solve factories) against the JAX
reference, in float64, on the cases of ``tests/test_facade.py``.

Each factory's closure gets the same inputs in both packages: ``solve``
(fixedpoint save_at) and ``solve_rk`` / ``solve_nystrom`` give the
reference's values to rtol 1e-10; ``solve_via_interpolate`` (the every-step
smoother) to 1e-7, as its accepted grid drifts from the reference's by
about 1e-8 relative (``tests/test_torch_adaptive.py``); ``asolve_scipy``
runs the same scipy call.  The port's closures also take leading batch axes
on ``u0``, which the reference ``vmap``s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odecheckpts_tpu import facade as jfacade
from odecheckpts_tpu import problems as jproblems
from odecheckpts_torch import facade as tfacade
from odecheckpts_torch import problems as tproblems


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-30))


def _logistic():
    jvf, (ju0,), tspan, args = jproblems.logistic()
    tvf, (tu0,), _, _ = tproblems.logistic()
    return jvf, tvf, ju0, tu0, tspan, args


_MATRIX_KW = dict(dt0=0.1, atol=1e-3, rtol=1e-3)


@functools.lru_cache(maxsize=None)
def _reference_matrix(name, method):
    """The reference's closure of the test matrix on the logistic problem
    (jitted where the reference's factory is jittable), its qoi and
    ``u0_solve`` as numpy arrays; computed once per (name, method)."""
    jvf, _, ju0, _, tspan, args = _logistic()
    save_at = jnp.linspace(*tspan, num=5)
    solve = getattr(jfacade, name)(method, jvf, ju0, save_at, **_MATRIX_KW)
    if name == "solve_via_interpolate":  # an eager loop in the reference
        u, aux = solve((ju0,), args)
    else:
        u, aux = jax.jit(lambda: solve((ju0,), args))()
    return np.asarray(u), np.asarray(aux["u0_solve"])


@pytest.mark.parametrize("m0", ["ts0-2", "ts0-4"])
@pytest.mark.parametrize("m1", ["bosh3", "tsit5"])
@pytest.mark.parametrize("variant", ["checkpoint", "interpolate"])
def test_two_solvers_return_the_same_solution(m0, m1, variant):
    """The reference's test matrix: the probabilistic factory and the RK
    factory agree to sqrt(tol), and each equals the reference's."""
    _, tvf, _, tu0, tspan, args = _logistic()
    save_at = np.linspace(*tspan, num=5)
    name, rtol = {"checkpoint": ("solve", 1e-10),
                  "interpolate": ("solve_via_interpolate", 1e-7)}[variant]
    got1, aux1 = getattr(tfacade, name)(m0, tvf, tu0, save_at, **_MATRIX_KW)((tu0,), args)
    want1, want_u0_solve = _reference_matrix(name, m0)
    _close(got1, want1, rtol)
    assert "u0_solve" in aux1
    _close(aux1["u0_solve"], want_u0_solve, rtol)

    got2, aux2 = tfacade.solve_rk(m1, tvf, tu0, save_at, **_MATRIX_KW)((tu0,), args)
    assert "u0_solve" in aux2
    _close(got2, _reference_matrix("solve_rk", m1)[0], 1e-10)
    assert np.allclose(got1.numpy(), got2.numpy(), atol=np.sqrt(1e-3), rtol=np.sqrt(1e-3))


def test_checkpoint_solution_length_is_memory_proxy():
    _, tvf, _, tu0, tspan, args = _logistic()
    save_at = np.linspace(*tspan, num=5)
    _, aux_c = tfacade.solve("ts0-4", tvf, tu0, save_at, dt0=0.1, atol=1e-6, rtol=1e-6)(
        (tu0,), args)
    assert len(aux_c["u0_solve"]) == 5
    _, aux_i = tfacade.solve_via_interpolate("ts0-4", tvf, tu0, save_at, dt0=0.1, atol=1e-6,
                                             rtol=1e-6)((tu0,), args)
    assert len(aux_i["u0_solve"]) > 5  # O(#steps)


def test_asolve_scipy_matches_reference_and_probabilistic():
    """The same scipy call as the reference's (on a short span, where the
    reference's eager vector field is cheap), and the reference's check of
    the probabilistic solve against LSODA(1e-12)."""
    jvf, (ju0,), tspan, args = jproblems.rigid_body()
    tvf, (tu0,), _, _ = tproblems.rigid_body()
    short = (0.0, 1.0)
    ts, ys = tfacade.asolve_scipy("LSODA", tvf, short, atol=1e-8, rtol=1e-8)((tu0,), args)
    jts, jys = jfacade.asolve_scipy("LSODA", jvf, short, atol=1e-8, rtol=1e-8)((ju0,), args)
    np.testing.assert_allclose(ts, jts, rtol=1e-12)
    np.testing.assert_allclose(ys, jys, rtol=1e-12, atol=1e-14)
    # the reference's case on (0, 3) instead of (0, 10), for the test's time
    ts, ys = tfacade.asolve_scipy("LSODA", tvf, (0.0, 3.0), atol=1e-12, rtol=1e-12)((tu0,), args)
    u_prob, _ = tfacade.solve("ts0-4", tvf, tu0, np.array([0.0, 3.0]), dt0=0.1, atol=1e-10,
                              rtol=1e-10)((tu0,), args)
    np.testing.assert_allclose(u_prob[-1].numpy(), ys[-1], rtol=1e-6)


@pytest.mark.parametrize("impl", ["isotropic", "blockdiag", "scalar"])
def test_facade_backend_selection_matches_reference(impl):
    jvf, tvf, ju0, tu0, tspan, args = _logistic()
    save_at = np.linspace(*tspan, num=4)
    kw = dict(dt0=0.1, atol=1e-7, rtol=1e-7, implementation=impl)
    jsolve = jfacade.solve("ts0-3", jvf, ju0, jnp.asarray(save_at), **kw)
    want, jaux = jax.jit(lambda: jsolve((ju0,), args))()
    got, aux = tfacade.solve("ts0-3", tvf, tu0, save_at, **kw)((tu0,), args)
    _close(got, want, 1e-10)
    np.testing.assert_array_equal(aux["solution"].num_steps.numpy(),
                                  np.asarray(jaux["solution"].num_steps))


@pytest.mark.parametrize("calibrate", ["none", "mle"])
def test_solve_calibrations_and_ts1_match_reference(calibrate):
    jvf, (ju0,), _, args = jproblems.rigid_body()
    tvf, (tu0,), _, _ = tproblems.rigid_body()
    save_at = np.linspace(0.0, 1.0, 3)
    kw = dict(dt0=0.1, atol=1e-5, rtol=1e-5, calibrate=calibrate, implementation="dense")
    jsolve = jfacade.solve("ts1-3", jvf, ju0, jnp.asarray(save_at), **kw)
    want, jaux = jax.jit(lambda: jsolve((ju0,), args))()
    got, aux = tfacade.solve("ts1-3", tvf, tu0, save_at, **kw)((tu0,), args)
    _close(got, want, 1e-10)
    _close(aux["solution"].u_std, jaux["solution"].u_std, 1e-6)


def test_batched_u0_equals_lanes():
    """Leading batch axes on ``u0``: each lane of ``solve``, ``solve_rk`` and
    ``solve_via_interpolate`` equals its one-IVP solve."""
    _, tvf, _, tu0, tspan, args = _logistic()
    save_at = np.linspace(*tspan, num=5)
    u0s = torch.tensor([[0.1], [0.3], [0.05]], dtype=torch.float64)
    kw = dict(dt0=0.1, atol=1e-5, rtol=1e-5)
    for build in (tfacade.solve, tfacade.solve_via_interpolate, tfacade.solve_rk):
        method = "tsit5" if build is tfacade.solve_rk else "ts0-3"
        solve = build(method, tvf, tu0, save_at, **kw)
        got, _ = solve((u0s,), args)
        assert got.shape == (5, 3, 1)
        for lane in range(3):
            want, _ = solve((u0s[lane],), args)
            _close(got[:, lane], want.numpy(), 1e-10)


def test_solve_nystrom_matches_reference():
    def vf2(u, *, t=None, p=()):
        return -p * u

    save_at = np.linspace(0.0, 3.0, 4)
    u0 = (np.array([1.0]), np.array([0.2]))
    kw = dict(dt0=0.1, atol=1e-8, rtol=1e-8)
    jsolve = jfacade.solve_nystrom("yoshida4", vf2, None, jnp.asarray(save_at), **kw)
    want, jaux = jax.jit(lambda: jsolve(tuple(map(jnp.asarray, u0)), 2.0))()
    got, aux = tfacade.solve_nystrom("yoshida4", vf2, None, save_at, **kw)(
        tuple(map(torch.tensor, u0)), 2.0)
    _close(got, want, 1e-10)
    assert int(aux["num_steps"]) == int(jaux["num_steps"])


def test_second_order_and_misuse_raise():
    """``ode_order=2`` is ported (``test_torch_second_order.py``): a
    second-order solve handed one initial array has too few Taylor
    coefficients, and ``solve_rk`` takes no order above 2."""
    _, tvf, _, tu0, tspan, args = _logistic()
    save_at = np.linspace(*tspan, num=3)
    with pytest.raises(ValueError):
        tfacade.solve("ts0-3", tvf, tu0, save_at, dt0=0.1, atol=1e-3, rtol=1e-3, ode_order=2)(
            (torch.tensor(np.asarray(tu0)),), args)
    with pytest.raises(ValueError, match="ode_order 1 or 2"):
        tfacade.solve_rk("tsit5", tvf, tu0, save_at, dt0=0.1, atol=1e-3, rtol=1e-3, ode_order=3)
    with pytest.raises(ValueError, match="Tuple expected"):
        tfacade.solve("ts0-3", tvf, tu0, save_at, dt0=0.1, atol=1e-3, rtol=1e-3)(tu0, args)
    with pytest.raises(ValueError, match="calibration"):
        tfacade.solve("ts0-3", tvf, tu0, save_at, dt0=0.1, atol=1e-3, rtol=1e-3, calibrate="x")
    with pytest.raises(ValueError, match="correction family"):
        tfacade.solve("rk4-3", tvf, tu0, save_at, dt0=0.1, atol=1e-3, rtol=1e-3)
