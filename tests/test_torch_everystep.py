"""Port differential tests: the save-every-step path (``StepLL`` with the
smoother and the filter strategy, the twin of K7; the interpolation for those
strategies; ``batched_everystep``) against the JAX reference.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances and why:

* One attempt of ``StepLL(strategy=...)`` against ``make_step_ll(strategy=
  ...)`` run op by op (``jax.disable_jit``), all 17 arrays: f64 rtol 1e-12,
  f32 rtol 1e-5 of each array's largest entry, as for the fixedpoint
  strategy in ``test_torch_batched.py``; and as there, a lane of an f32
  array that misses 1e-5 (the jitted warm-up leaves lanes on an
  ill-conditioned state on some hosts: up to 5.7e-3 between the two f32
  results there, each as far from the exact result) is judged by the
  reference's attempt in f64 (``torch_f64_judge``: within twice the
  reference's own f32 distance, the largest over its attempt and 8 attempts
  from the mean nudged by one ulp, or within 1e-5), with the same accepted
  lanes.
* ``_interpolate_at`` for a smoother and a filter strategy, the strategies'
  ``needs_reversal``, ``qoi_std`` and the state converters without reversal:
  f64 rtol 1e-12, or exact where nothing is computed.
* Whole f64 solves against ``solve_every_step_batched(engine="xla")``: equal
  ``valid`` masks and ``num_steps``.  The slot times agree to 1e-4 of t1 and
  not to roundoff (measured: 1.3e-6 on one rtol 1e-4 lane, below 1e-8 on
  the others): right after the exact Taylor init the residual z is nearly
  all cancellation, and the jitted reference contracts multiply-add pairs
  into FMA, so its first error estimates, and the first accepted step sizes,
  differ from the twin's in the 7th digit; the time grid keeps and grows
  that shift.  A value at a slot moves with its slot's time (by u' dt):
  1e-4 of the largest entry (measured 1e-5), and the standard deviations
  likewise.  Values at fixed times do not see the shift: ``u_t1`` agrees to
  rtol 1e-7 (measured 4e-10).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_f64_judge as judge

from odecheckpts_tpu import batched as jb
from odecheckpts_tpu import batched_everystep as je
from odecheckpts_tpu import ivpsolve as jivpsolve
from odecheckpts_tpu import ivpsolvers as jsolvers
from odecheckpts_tpu import problems as jp
from odecheckpts_tpu.ssm.base import Conditional as JCond
from odecheckpts_tpu.ssm.base import Normal as JNormal
from odecheckpts_torch import batched as tb
from odecheckpts_torch import batched_everystep as te
from odecheckpts_torch import interop, kernels
from odecheckpts_torch import ivpsolve as tivpsolve
from odecheckpts_torch import ivpsolvers as tsolvers
from odecheckpts_torch import problems as tp
from odecheckpts_torch.ssm.base import Conditional as TCond
from odecheckpts_torch.ssm.base import Normal as TNormal

NP = {"f64": np.float64, "f32": np.float32}
TORCH = {"f64": torch.float64, "f32": torch.float32}
INPUT_NAMES = ("atol", "rtol", "dt_max", "dt_floor", "tiny_scale")
NU, D, B = 4, 3, 6
N = NU + 1


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


def _close_tree(got, want, rtol=1e-12):
    for g, w in zip(jax.tree.leaves(interop.to_numpy(tuple(got))), jax.tree.leaves(tuple(want))):
        _close(g, w, rtol)


# ---------------------------------------------------------------------------
# one attempt of the twin of K7 against make_step_ll(strategy=...)


def _jax_step(nu, strategy):
    vf, _, _, params = jp.rigid_body()
    return jb.make_step_ll(lambda args, t: vf(*args, t=t[0], p=params), nu=nu, d=3,
                           strategy=strategy, error_calibration=10.0)


def _start(nu, dtype, strategy, batch=16, warm_steps=25):
    """A mid-solve lanes-last state as numpy arrays: the port's Taylor init
    for ``strategy``, advanced by the reference's jitted step."""
    rng = np.random.default_rng(0)
    u0s = (np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((batch, 3))))
    tols = np.tile([1e-2, 1e-4, 1e-6, 1e-3], batch // 4)
    vf, _, _, params = tp.rigid_body()
    state, _, inputs = tb.initial_state(
        vf, torch.tensor(u0s.astype(NP[dtype])), params, save_at=np.array([0.0, 10.0], NP[dtype]),
        dt0=0.1, tols=torch.tensor(tols.astype(NP[dtype])), num_derivatives=nu,
        strategy=strategy)
    state = interop.state_to_numpy(state)
    extra = (np.full((1, batch), 10.0, NP[dtype]),) + tuple(inputs[k].numpy() for k in INPUT_NAMES)
    step = jax.jit(_jax_step(nu, strategy))
    s = tuple(jnp.asarray(x) for x in state)
    for _ in range(warm_steps):
        s = step(s, *(jnp.asarray(x) for x in extra))
    return tuple(np.asarray(x) for x in s), extra


def _reference_attempt(nu, strategy, state, extra, np_dtype):
    """The reference's attempt op by op in ``np_dtype`` (inputs widened)."""
    with jax.disable_jit():
        out = _jax_step(nu, strategy)(tuple(jnp.asarray(x, np_dtype) for x in state),
                                      *(jnp.asarray(x, np_dtype) for x in extra))
    return tuple(np.asarray(x) for x in out)


@functools.lru_cache(maxsize=None)
def _one_attempt(nu, dtype, strategy):
    """The start state, the twin's attempt, the reference's attempt op by op
    and, in f32, the reference's attempt in f64 on the widened inputs."""
    state, extra = _start(nu, dtype, strategy)
    vf, _, _, params = tp.rigid_body()
    step = tb.make_step_ll(vf, params, nu=nu, d=3, error_calibration=10.0, dtype=TORCH[dtype],
                           strategy=strategy)
    got = interop.state_to_numpy(step(interop.state_to_torch(state), *interop.to_torch(extra)))
    ref = _reference_attempt(nu, strategy, state, extra, np.float64) if dtype == "f32" else None
    return state, got, _reference_attempt(nu, strategy, state, extra, NP[dtype]), ref


@functools.lru_cache(maxsize=None)
def _nudged_draws(nu, strategy):
    """The reference's f32 and f64 attempts from the f32 start state with its
    mean nudged by one ulp (``torch_f64_judge.nudged_means``)."""
    state, extra = _start(nu, "f32", strategy)
    return tuple((_reference_attempt(nu, strategy, s, extra, np.float32),
                  _reference_attempt(nu, strategy, s, extra, np.float64))
                 for s in judge.nudged_means(state))


def _draws(nu, strategy, i):
    return lambda: [(w[i], r[i]) for w, r in _nudged_draws(nu, strategy)]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("nu", [2, 4])
@pytest.mark.parametrize("strategy", ["smoother", "filter"])
def test_one_attempt_matches_jax_make_step_ll_with_strategy(strategy, nu, dtype):
    state, got, want, ref = _one_attempt(nu, dtype, strategy)
    accepted = got[0] != state[0]
    assert int(np.sum(accepted)) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
    if dtype == "f64":
        for g, w in zip(got, want):
            _close(g, w, 1e-12)
    else:
        judge.assert_same_accepted(got[0], want[0], state[0])
        for i, (g, w, r) in enumerate(zip(got, want, ref)):
            judge.assert_as_accurate_as_reference(g, w, r, 1e-5, draws=_draws(nu, strategy, i),
                                                  what=f"array {i}")
    if strategy == "filter":  # no reversal: the backward arrays pass through
        for i in (3, 4, 5):
            np.testing.assert_array_equal(got[i], state[i])
    else:  # the previous backward conditional is the pre-attempt one where accepted
        np.testing.assert_array_equal(got[10][:, :, accepted[0]], state[3][:, :, accepted[0]])


@pytest.mark.parametrize("fault", ["shifted_lane", "off_by_one"])
def test_one_attempt_f64_judge_catches_seeded_faults(fault):
    """A fault seeded into the smoother attempt's f32 mean (array 1) fails
    the judge of ``test_one_attempt_matches_jax_make_step_ll_with_strategy``:
    a well-conditioned lane moved by 5e-5 of the array's largest entry, or
    lanes off by one."""
    _, got, want, ref = _one_attempt(4, "f32", "smoother")
    draws = _draws(4, "smoother", 1)
    judge.assert_as_accurate_as_reference(got[1], want[1], ref[1], 1e-5, draws=draws)
    if fault == "shifted_lane":
        bad = judge.shifted_lane(got[1], judge.well_conditioned_lane(want[1], ref[1],
                                                                    draws=draws()))
    else:
        bad = judge.off_by_one(got[1])
    with pytest.raises(AssertionError):
        judge.assert_as_accurate_as_reference(bad, want[1], ref[1], 1e-5, draws=draws)


def test_fixedpoint_is_the_default_strategy_and_its_bits_are_unchanged():
    state, extra = _start(4, "f32", "fixedpoint", batch=8, warm_steps=10)
    vf, _, _, params = tp.rigid_body()
    default = tb.make_step_ll(vf, params, nu=4, d=3)
    named = tb.make_step_ll(vf, params, nu=4, d=3, strategy="fixedpoint")
    assert default.strategy == named.strategy == "fixedpoint"
    a = default(interop.state_to_torch(state), *interop.to_torch(extra))
    b = named(interop.state_to_torch(state), *interop.to_torch(extra))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    smoother = tb.make_step_ll(vf, params, nu=4, d=3, strategy="smoother")(
        interop.state_to_torch(state), *interop.to_torch(extra))
    for i in (0, 1, 2, 6, 13, 14, 15, 16):  # everything but the backward arrays
        torch.testing.assert_close(smoother[i], a[i], rtol=0, atol=0)
    assert not torch.equal(smoother[3], a[3])


# ---------------------------------------------------------------------------
# strategies, interpolation, qoi_std, converters


def _ssms():
    return (jsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,)),
            tsolvers.prior_ibm(num_derivatives=NU, ode_shape=(D,)))


def _normal(rng, lead=(B,)):
    return (rng.standard_normal(lead + (N, D)), np.tril(rng.standard_normal(lead + (N, N))))


def _cond(rng, lead=(B,)):
    return (np.triu(rng.standard_normal(lead + (N, N))) + np.eye(N),) + _normal(rng, lead)


def _jn(x):
    return JNormal(*(jnp.asarray(a) for a in x))


def _tn(x):
    return TNormal(*(torch.tensor(a) for a in x))


def _jc(x):
    return None if x is None else JCond(jnp.asarray(x[0]), _jn(x[1:]))


def _tc(x):
    return None if x is None else TCond(torch.tensor(x[0]), _tn(x[1:]))


def _states(rng, t_ckpt, needs_rev):
    """Lane 0 sits exactly on the checkpoint; lane 1 lands within the snap
    threshold; the rest interpolate."""
    t = t_ckpt + rng.uniform(0.05, 0.5, B)
    t[0] = t_ckpt
    t_prev = t_ckpt - rng.uniform(0.05, 0.5, B)
    t_prev[1] = t_ckpt - 1e-14
    fields = dict(
        t=t, rv=_normal(rng), bwd=_cond(rng) if needs_rev else None,
        scale_step=rng.uniform(0.1, 3.0, B), t_prev=t_prev, rv_prev=_normal(rng),
        bwd_prev=_cond(rng) if needs_rev else None, dt=rng.uniform(0.01, 0.1, B),
        errn_prev=rng.uniform(0.1, 1.0, B), num_steps=np.arange(B, dtype=np.int32),
        mle_ssq=rng.uniform(0, 1, B),
    )
    wrap_j = {"rv": _jn, "rv_prev": _jn, "bwd": _jc, "bwd_prev": _jc}
    wrap_t = {"rv": _tn, "rv_prev": _tn, "bwd": _tc, "bwd_prev": _tc}
    js = jivpsolve._State(**{k: wrap_j.get(k, jnp.asarray)(v) for k, v in fields.items()})
    ts = tivpsolve._State(**{k: wrap_t.get(k, torch.tensor)(v) for k, v in fields.items()})
    return js, ts


@pytest.mark.parametrize("kind", ["smoother", "filter"])
def test_interpolate_at_matches_jax_for_smoother_and_filter(kind):
    jssm, tssm = _ssms()
    jstrat = getattr(jsolvers, f"strategy_{kind}")(jssm, jsolvers.correction_ts0())
    tstrat = getattr(tsolvers, f"strategy_{kind}")(tssm, tsolvers.correction_ts0())
    assert tstrat.kind == jstrat.kind == kind
    assert tstrat.needs_reversal == jstrat.needs_reversal == (kind != "filter")
    js, ts = _states(np.random.default_rng(2), 2.5, jstrat.needs_reversal)
    want = jax.vmap(lambda s: jivpsolve._interpolate_at(jstrat, s, 2.5))(js)
    got = tivpsolve._interpolate_at(tstrat, ts, 2.5)
    _close_tree(got[0][0], want[0][0])  # the emitted marginal
    if kind == "filter":
        assert got[0][1] is None and got[1].bwd is None and got[1].bwd_prev is None
        for name in ("t", "t_prev", "dt", "scale_step"):
            _close(getattr(got[1], name).numpy(), getattr(want[1], name))
        _close_tree(got[1].rv_prev, want[1].rv_prev)
    else:
        _close_tree(got[0][1], want[0][1])  # the one-step conditional, not a composition
        _close_tree(got[1], want[1])
    assert tsolvers.strategy_fixedpoint(tssm, tsolvers.correction_ts0()).needs_reversal


def test_qoi_std_matches_jax():
    jssm, tssm = _ssms()
    rv = _normal(np.random.default_rng(3), (4, B))
    want = jax.vmap(jax.vmap(jssm.qoi_std))(_jn(rv))
    got = tssm.qoi_std(_tn(rv))
    assert got.shape == (4, B, D)
    _close(got.numpy(), want)


def test_state_converters_without_reversal_match_jax():
    js, ts = _states(np.random.default_rng(4), 2.5, needs_rev=False)
    want = jb._generic_to_state(js, False, jnp.float64)
    got = tb._generic_to_state(ts, torch.float64, needs_rev=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not bool(torch.any(got[3])) and not bool(torch.any(got[12]))  # zeros
    back = tb._state_to_generic(got, needs_rev=False)
    assert back.bwd is None and back.bwd_prev is None
    np.testing.assert_array_equal(back.rv.mean.numpy(), ts.rv.mean.numpy())


# ---------------------------------------------------------------------------
# whole solves


def _ensemble(dtype=np.float64, batch=4):
    rng = np.random.default_rng(3)
    u0s = np.array([1.0, 0.0, 0.9]) * (1.0 + 0.04 * rng.standard_normal((batch, 3)))
    return u0s.astype(dtype), np.asarray([1e-4, 1e-6, 1e-5, 1e-4], dtype)[:batch]


def _both(strategy, max_steps=256):
    u0s, tols = _ensemble()
    jvf, _, _, jparams = jp.rigid_body()
    vf, _, _, params = tp.rigid_body()
    kw = dict(t0=0.0, t1=8.0, dt0=0.1, max_steps=max_steps, strategy=strategy)
    want = je.solve_every_step_batched(jvf, jnp.asarray(u0s), jparams, tols=jnp.asarray(tols),
                                       engine="xla", lanes=4, **kw)
    got = te.solve_every_step_batched(vf, torch.tensor(u0s), params, tols=torch.tensor(tols),
                                      engine="cuda", **kw)
    return got, want


@pytest.mark.parametrize("strategy", ["smoother", "filter"])
def test_every_step_solve_matches_jax(strategy):
    got, want = _both(strategy)
    valid = np.asarray(want.valid)
    assert got.t.shape == (4, 257) and got.u.shape == (4, 257, 3)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.num_steps.numpy(), np.asarray(want.num_steps))
    assert got.num_steps.dtype == torch.int32
    # the rtol 1e-6 lane needs more than 256 attempts: it ends short of t1 in both
    last = np.max(np.where(valid, np.asarray(want.t), 0.0), axis=1)
    assert last[1] < 7.0 and np.all(last[[0, 2, 3]] > 7.0)
    assert 100 < int(valid[0].sum()) < 257

    def at_slots(name, rtol):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        mask = valid if w.ndim == 2 else valid[..., None]
        _close(np.where(mask, g, 0.0), np.where(mask, w, 0.0), rtol)

    at_slots("t", 1e-4)
    at_slots("u", 1e-4)
    at_slots("u_std", 1e-4)
    _close(got.u_t1.numpy(), want.u_t1, 1e-7)
    _close(got.u_std_t1.numpy(), want.u_std_t1, 1e-5)
    if strategy == "filter":
        assert got.marginal_u is None and got.marginal_u_std is None
        assert want.marginal_u is None
    else:
        at_slots("marginal_u", 1e-4)
        at_slots("marginal_u_std", 1e-4)
        # the backward pass did something: smoothed and filtered means differ
        diff = np.abs(got.marginal_u.numpy() - got.u.numpy())[valid]
        assert np.max(diff) > 1e-12
        # slot 0 is the initial condition: its smoothed marginal stays on u0
        _close(got.marginal_u[:, 0].numpy(), _ensemble()[0], 1e-6)


def test_compact_matches_jax_compact():
    got, want = _both("smoother", max_steps=64)
    for lane in (0, 1):
        c_t, c_j = te.compact(got, lane), je.compact(want, lane)
        assert set(c_t) == set(c_j) == {"t", "u", "u_std", "marginal_u", "marginal_u_std"}
        assert c_t["t"].shape == c_j["t"].shape and c_t["u"].shape == c_j["u"].shape
        assert np.all(np.diff(c_t["t"]) > 0) and c_t["t"][0] == 0.0
        _close(c_t["t"], c_j["t"], 1e-4)
        _close(c_t["marginal_u"], c_j["marginal_u"], 1e-4)
    filt = te.solve_every_step_batched(
        tp.rigid_body()[0], torch.tensor(_ensemble()[0]), tp.rigid_body()[3], t0=0.0, t1=8.0,
        dt0=0.1, tols=torch.tensor(_ensemble()[1]), max_steps=8, strategy="filter")
    assert te.compact(filt, 0)["marginal_u"] is None


def test_every_step_engines_agree_in_f32_and_reject_what_the_reference_rejects():
    u0s, tols = _ensemble(np.float32)
    vf, _, _, params = tp.rigid_body()
    kw = dict(t0=0.0, t1=8.0, dt0=0.1, tols=torch.tensor(tols), max_steps=48)
    before = dict(kernels.LAUNCHES)
    a = te.solve_every_step_batched(vf, torch.tensor(u0s), params, engine="cuda", **kw)
    b = te.solve_every_step_batched(vf, (torch.tensor(u0s),), params, engine="torch", **kw)
    assert kernels.LAUNCHES == before  # CPU tensors: the twin ran
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.u.dtype == torch.float32 and a.valid.dtype == torch.bool
    assert bool(torch.all(torch.isfinite(a.marginal_u[a.valid])))
    assert bool(torch.all(a.valid[:, 0])) and bool(torch.all(a.t[:, 0] == 0.0))
    with pytest.raises(ValueError, match="save_at concept"):
        te.solve_every_step_batched(vf, torch.tensor(u0s), params, strategy="fixedpoint", **kw)
    with pytest.raises(ValueError, match="cuda-loop"):
        te.solve_every_step_batched(vf, torch.tensor(u0s), params, engine="cuda-loop", **kw)
    with pytest.raises(MemoryError):
        te.solve_every_step_batched(vf, torch.tensor(u0s), params, hbm_budget=1024, **kw)


@pytest.mark.parametrize("option", [
    dict(calibration="none"), dict(ode_order=2), dict(correction="ts1"),
    dict(error_unit="residual"), dict(num_derivatives=5),
])
def test_unported_every_step_options_name_their_roadmap_item(option):
    u0s, tols = _ensemble(np.float32)
    vf, _, _, params = tp.rigid_body()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        te.solve_every_step_batched(vf, torch.tensor(u0s), params, t0=0.0, t1=8.0, dt0=0.1,
                                    tols=torch.tensor(tols), max_steps=8, **option)
