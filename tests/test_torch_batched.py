"""Port differential tests: the batched f32 path (twin of K1, the driver, the
memory guard) against the JAX reference, plus the kernel wrapper's contract.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances and why:

* One attempt: f64 rtol 1e-12, f32 rtol 1e-5, relative to each array's
  largest entry.  The reference step runs op by op (``jax.disable_jit``):
  under ``jit`` XLA's CPU backend contracts multiply-add pairs into FMA,
  while the twin (and the CUDA kernel, built with ``-fmad=false``) rounds
  every operation on its own.  The mid-solve start comes from 25 jitted
  reference steps, and how those contract depends on the host: on some
  hosts they leave lanes on an ill-conditioned state, where the two f32
  results differ beyond 1e-5 (up to 4.5e-5 of the largest entry at nu = 4)
  and each is as far from the exact result as the other.  So a lane of an
  f32 array that misses 1e-5 is judged by the reference's attempt in f64 on
  the exactly widened inputs (``torch_f64_judge``): the twin must be no
  farther from it than twice the reference's own f32 distance (the largest
  over its attempt and 8 attempts from the mean nudged by one ulp), or
  within 1e-5; and the twin and the reference accept the same lanes.
  Seeded faults (a well-conditioned lane moved by 5e-5 of the array's
  largest entry, lanes off by one) fail that judge.
* One interval in f64 against the jitted interpret-mode kernel: identical
  step counts, every state array within rtol 1e-7 of its largest entry
  (after ~100 steps the FMA-contracted roundoff reaches ~5e-9 there).
* The whole slice in f64: identical step counts, checkpoint values within
  rtol 1e-9.
* The whole slice in f32 against the reference run without the compiler's
  rewrites of its arithmetic (``torch_uncontracted``: jitted under flags
  that give the op-by-op arithmetic bit for bit, every operation rounded
  on its own, as in the twin and the kernels).  Jitted as it is, XLA
  contracts the reference's multiply-adds into FMA, and that hides a tail
  of the f32 fixedpoint smoother at rtol 1e-6 (a lane whose last step
  lands just above ``_interpolate_at``'s snap threshold before a
  checkpoint, where the emitted conditional amplifies the f32 state's
  roundoff): on 1,024 perturbed lanes, 35 of the port's and 23 of the
  uncontracted reference's smoothed values miss the f64 solve by more than
  100 rtol, 1 of the jitted reference's (``test_torch_smoothing.py``).  So
  filtered and smoothed values within rtol 2e-4 / atol 1e-6 of the
  uncontracted reference (the reference's own pallas-loop against xla
  tolerance), a lane that misses judged by the reference's f64 solve of
  the widened inputs as above (twice the reference's own distance on that
  lane, or 2e-4).  The port's CPU arithmetic is the same on every host
  (``odecheckpts_torch/rounded.py``, ``test_torch_rounded.py``), so this
  verdict is too.  Step counts within 2% per lane at rtol 1e-4 and within
  5% at rtol 1e-6: f32 step counts at rtol 1e-6 (8 ulps) are that
  sensitive, a 1-ulp change of u0 alone moves the twin's own per-lane step
  counts by up to 3.9%.

The kernel wrapper's own tests, and those that need the card, are in
``test_torch_kernels.py``, which imports no JAX.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_f64_judge as judge
import torch_uncontracted as uncontracted

from odecheckpts_tpu import batched as jb
from odecheckpts_tpu import harness as jh
from odecheckpts_tpu import problems as jp
from odecheckpts_torch import batched as tb
from odecheckpts_torch import harness as th
from odecheckpts_torch import interop, kernels
from odecheckpts_torch import problems as tp

NP = {"f64": np.float64, "f32": np.float32}
TORCH = {"f64": torch.float64, "f32": torch.float32}
INPUT_NAMES = ("atol", "rtol", "dt_max", "dt_floor", "tiny_scale")


def _ensemble(batch, dtype, seed=0, tols=(1e-4, 1e-6)):
    rng = np.random.default_rng(seed)
    u0s = np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((batch, 3)))
    tol = np.tile(np.asarray(tols), batch // len(tols))
    return u0s.astype(dtype), tol.astype(dtype)


def _normwise_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


def _jax_step(nu, kappa):
    vf, _, _, params = jp.rigid_body()

    def vfb(args, t):
        return vf(*args, t=t[0], p=params)

    return jb.make_step_ll(vfb, nu=nu, d=3, error_calibration=kappa)


def _start(nu, dtype, batch=16, warm_steps=25):
    """A mid-solve lanes-last state as numpy arrays: the port's Taylor init,
    carried to JAX with interop, advanced by the reference's jitted step."""
    u0s, tols = _ensemble(batch, NP[dtype], tols=(1e-2, 1e-4, 1e-6, 1e-3))
    save_at = np.linspace(0.0, 10.0, 5).astype(NP[dtype])
    vf, _, _, params = tp.rigid_body()
    state, _, inputs = tb.initial_state(
        vf, torch.tensor(u0s), params, save_at=save_at, dt0=0.1,
        tols=torch.tensor(tols), num_derivatives=nu,
    )
    state = interop.state_to_numpy(state)
    extra = (np.full((1, batch), save_at[1], NP[dtype]),) + tuple(
        inputs[k].numpy() for k in INPUT_NAMES)
    step = jax.jit(_jax_step(nu, 10.0))
    s = tuple(jnp.asarray(x) for x in state)
    for _ in range(warm_steps):
        s = step(s, *(jnp.asarray(x) for x in extra))
    return tuple(np.asarray(x) for x in s), extra


def _reference_attempt(nu, state, extra, np_dtype):
    """The reference's attempt op by op in ``np_dtype`` (inputs widened)."""
    with jax.disable_jit():
        out = _jax_step(nu, 10.0)(tuple(jnp.asarray(x, np_dtype) for x in state),
                                  *(jnp.asarray(x, np_dtype) for x in extra))
    return tuple(np.asarray(x) for x in out)


@functools.lru_cache(maxsize=None)
def _one_attempt(nu, dtype):
    """The start state, the twin's attempt, the reference's attempt op by op
    and, in f32, the reference's attempt in f64 on the widened inputs."""
    state, extra = _start(nu, dtype)
    vf, _, _, params = tp.rigid_body()
    step = tb.make_step_ll(vf, params, nu=nu, d=3, error_calibration=10.0,
                           dtype=TORCH[dtype])
    got = interop.state_to_numpy(step(interop.state_to_torch(state), *interop.to_torch(extra)))
    ref = _reference_attempt(nu, state, extra, np.float64) if dtype == "f32" else None
    return state, got, _reference_attempt(nu, state, extra, NP[dtype]), ref


@functools.lru_cache(maxsize=None)
def _nudged_draws(nu):
    """The reference's f32 and f64 attempts from the f32 start state with its
    mean nudged by one ulp (``torch_f64_judge.nudged_means``)."""
    state, extra = _start(nu, "f32")
    return tuple((_reference_attempt(nu, s, extra, np.float32),
                  _reference_attempt(nu, s, extra, np.float64))
                 for s in judge.nudged_means(state))


def _draws(nu, i):
    return lambda: [(w[i], r[i]) for w, r in _nudged_draws(nu)]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("nu", [2, 3, 4])
def test_one_attempt_matches_jax_make_step_ll(nu, dtype):
    state, got, want, ref = _one_attempt(nu, dtype)
    assert int(np.sum(got[0] != state[0])) > 0  # some lanes accepted
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
    if dtype == "f64":
        for g, w in zip(got, want):
            _normwise_close(g, w, 1e-12)
        return
    judge.assert_same_accepted(got[0], want[0], state[0])
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        judge.assert_as_accurate_as_reference(g, w, r, 1e-5, draws=_draws(nu, i),
                                              what=f"array {i}")


@pytest.mark.parametrize("fault", ["shifted_lane", "off_by_one"])
def test_one_attempt_f64_judge_catches_seeded_faults(fault):
    """A fault seeded into the twin's f32 mean (array 1) fails the judge of
    ``test_one_attempt_matches_jax_make_step_ll``: a well-conditioned lane
    moved by 5e-5 of the array's largest entry, or lanes off by one."""
    _, got, want, ref = _one_attempt(4, "f32")
    draws = _draws(4, 1)
    judge.assert_as_accurate_as_reference(got[1], want[1], ref[1], 1e-5, draws=draws)
    if fault == "shifted_lane":
        bad = judge.shifted_lane(got[1], judge.well_conditioned_lane(want[1], ref[1],
                                                                    draws=draws()))
    else:
        bad = judge.off_by_one(got[1])
    with pytest.raises(AssertionError):
        judge.assert_as_accurate_as_reference(bad, want[1], ref[1], 1e-5, draws=draws)


def test_one_interval_matches_jax_pallas_interval():
    nu, batch = 4, 16
    state, extra = _start(nu, "f64", batch=batch, warm_steps=0)
    jcall = jb._pallas_interval(_jax_step(nu, 10.0), interpret=True, lanes=batch)
    want = jcall(tuple(jnp.asarray(x) for x in state), *(jnp.asarray(x) for x in extra))
    vf, _, _, params = tp.rigid_body()
    step = tb.make_step_ll(vf, params, nu=nu, d=3, error_calibration=10.0,
                           dtype=torch.float64)
    t_next, *rest = interop.to_torch(extra)
    got = kernels.step_ll_interval(
        step, interop.state_to_torch(state), t_next, max_attempts=100_000,
        **dict(zip(INPUT_NAMES, rest)),
    )
    got = interop.state_to_numpy(got)
    assert np.all(got[0] >= extra[0])
    np.testing.assert_array_equal(got[15], np.asarray(want[15]))
    for g, w in zip(got, want):
        _normwise_close(g, w, 1e-7)


@functools.lru_cache(maxsize=None)
def _jax_solve(dtype, widened=False):
    """The reference's pallas-loop solve of the 8-lane ensemble in ``dtype``
    (with ``widened``: in f64 on the f32 inputs widened exactly)."""
    u0s, tols = _ensemble(8, NP[dtype])
    save_at = np.linspace(0.0, 10.0, 5).astype(NP[dtype])
    if widened:
        u0s, tols, save_at = (x.astype(np.float64) for x in (u0s, tols, save_at))
    jvf, _, _, jparams = jp.rigid_body()
    out = jb.solve_save_at_batched(
        jvf, jnp.asarray(u0s), jparams, save_at=jnp.asarray(save_at), dt0=0.1,
        tols=jnp.asarray(tols), engine="pallas-loop", interpret=True,
    )
    return tuple(np.asarray(x) for x in out)


@functools.lru_cache(maxsize=None)
def _torch_solve(dtype):
    u0s, tols = _ensemble(8, NP[dtype])
    save_at = np.linspace(0.0, 10.0, 5).astype(NP[dtype])
    vf = tp.rigid_body()[0]
    params = interop.to_torch(tuple(jp.rigid_body()[3]))  # the reference's, carried across
    return tb.solve_save_at_batched(
        vf, torch.tensor(u0s), params, save_at=save_at, dt0=0.1,
        tols=torch.tensor(tols), engine="cuda-loop",
    )


@functools.lru_cache(maxsize=None)
def _uncontracted():
    """The reference's f32 solve of the 8 lanes without the compiler's
    rewrites (``torch_uncontracted``), once the premise is shown to hold."""
    u0s, tols = _ensemble(8, np.float32)
    save_at = np.linspace(0.0, 10.0, 5).astype(np.float32)
    premise, [out] = uncontracted.solve([(u0s, tols, save_at)], *_start(4, "f32"))
    assert premise.all(), f"jitted under {uncontracted.FLAGS}, the step is not op by op"
    return out


def _judge_solve(values, which):
    """The f32 whole solve's smoothed (``which`` = 0) or filtered (1)
    values against the uncontracted reference's f32 solve, lanes that miss
    judged by its f64 solve of the widened inputs (the module docstring)."""
    judge.assert_as_accurate_as_reference(
        values, _uncontracted()[which], _jax_solve("f32", widened=True)[which], 2e-4,
        atol=1e-6, lane_axis=0, what=("smoothed values", "filtered values")[which])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_solve_save_at_batched_matches_jax_pallas_loop(dtype):
    _, tols = _ensemble(8, NP[dtype])
    u_j, uf_j, n_j = _jax_solve(dtype) if dtype == "f64" else _uncontracted()
    u_t, uf_t, n_t = _torch_solve(dtype)
    assert u_t.shape == (8, 5, 3) and uf_t.shape == (8, 5, 3) and n_t.shape == (8, 5)
    assert u_t.dtype == TORCH[dtype] and bool(torch.all(torch.isfinite(u_t)))
    if dtype == "f64":
        np.testing.assert_array_equal(n_t.numpy(), n_j)
        np.testing.assert_allclose(u_t.numpy(), u_j, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(uf_t.numpy(), uf_j, rtol=1e-9, atol=1e-12)
    else:
        n_t, n_j = n_t.numpy()[:, -1], n_j[:, -1]
        loose = tols == np.float32(1e-4)
        np.testing.assert_allclose(n_t[loose], n_j[loose], rtol=0.02)
        np.testing.assert_allclose(n_t[~loose], n_j[~loose], rtol=0.05)
        _judge_solve(uf_t.numpy(), 1)
        _judge_solve(u_t.numpy(), 0)


@pytest.mark.parametrize("fault", ["shifted_lane", "off_by_one"])
def test_solve_f64_judge_catches_seeded_faults(fault):
    """A fault seeded into the f32 solve's filtered checkpoint values fails
    the judge of ``test_solve_save_at_batched_matches_jax_pallas_loop``: a
    lane whose reference value is within 2e-4 of f64 moved by 1e-3 of the
    largest value, or lanes off by one."""
    uf_t = _torch_solve("f32")[1].numpy()
    _judge_solve(uf_t, 1)
    if fault == "shifted_lane":
        lane = judge.well_conditioned_lane(_uncontracted()[1],
                                           _jax_solve("f32", widened=True)[1], 0, bound=2e-4)
        bad = judge.shifted_lane(uf_t, lane, 0, by=1e-3)
    else:
        bad = judge.off_by_one(uf_t, 0)
    with pytest.raises(AssertionError):
        _judge_solve(bad, 1)


def test_rmse_absolute_matches_jax():
    rng = np.random.default_rng(4)
    truth, got = rng.standard_normal((2, 16, 5, 3))
    want = float(jh.rmse_absolute(jnp.asarray(truth))(jnp.asarray(got)))
    assert float(th.rmse_absolute(truth)(got)) == pytest.approx(want, rel=1e-12)
    assert th.device_sync(got) is got


def test_hbm_guard_estimate_is_monotone_and_guard_raises():
    kw = dict(num_derivatives=4, num_save_at=200, dtype=torch.float64)
    e1 = tb.estimate_solve_bytes(256, 64, **kw)
    e2 = tb.estimate_solve_bytes(1024, 64, **kw)
    e3 = tb.estimate_solve_bytes(1024, 128, **kw)
    assert e1 < e2 < e3
    assert e2 == jb.estimate_solve_bytes(1024, 64, num_derivatives=4, num_save_at=200,
                                         dtype=jnp.float64)
    with pytest.raises(MemoryError, match="Reduce the batch"):
        tb.check_hbm_budget(1024, 64, budget=e2 - 1, **kw)
    tb.check_hbm_budget(1024, 64, budget=e2 + 1, **kw)
    tb.check_hbm_budget(1024, 64, budget=None, **kw)
    u0s, tols = _ensemble(8, np.float32)
    vf, _, _, params = tp.rigid_body()
    with pytest.raises(MemoryError):
        tb.solve_save_at_batched(
            vf, torch.tensor(u0s), params, save_at=np.linspace(0, 10, 5), dt0=0.1,
            tols=torch.tensor(tols), hbm_budget=1024,
        )


@pytest.mark.parametrize("option", [
    # the filter strategy, ode_order 2, TS1 at d = 1 and the residual unit
    # run on this engine (test_torch_second_order.py)
    dict(strategy="smoother"), dict(calibration="none"), dict(ode_order=3),
    # TS1 with d > 1 and the dense backend run on the dense engine
    # (test_torch_dense.py); its own unported options raise there
    dict(correction="ts1", calibration="none"),
    dict(error_unit="residual", implementation="dense"),
    dict(implementation="dense", strategy="filter"),
    # the blockdiag backend runs on the blockdiag engine (test_torch_blockdiag.py);
    # its own unported options raise there
    dict(implementation="blockdiag", strategy="filter"), dict(num_derivatives=5),
])
def test_unported_options_name_their_roadmap_item(option):
    u0s, tols = _ensemble(8, np.float32)
    vf, _, _, params = tp.rigid_body()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tb.solve_save_at_batched(
            vf, torch.tensor(u0s), params, save_at=np.linspace(0, 10, 5), dt0=0.1,
            tols=torch.tensor(tols), **option,
        )


def test_engines_other_than_the_ports_are_refused():
    u0s, tols = _ensemble(8, np.float32)
    vf, _, _, params = tp.rigid_body()
    with pytest.raises(ValueError, match="cuda-loop"):
        tb.solve_save_at_batched(
            vf, torch.tensor(u0s), params, save_at=np.linspace(0, 10, 5), dt0=0.1,
            tols=torch.tensor(tols), engine="pallas",
        )


def test_port_never_imports_jax():
    code = (
        "import sys, pkgutil, importlib, odecheckpts_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules), "
        "sorted(k for k in sys.modules if k.startswith('jax'))\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=False, timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
