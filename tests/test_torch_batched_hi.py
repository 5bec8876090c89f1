"""Port differential tests: the df32 engine (``odecheckpts_torch.batched_hi``:
the twin of K2 and K4, its building blocks, the drivers) against the JAX
reference ``odecheckpts_tpu.batched_hi``, plus the per-attempt engines, the
bucketing and the routed driver.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances and why:

* Building blocks: ``rigid_body_df`` and ``_taylor_extrap_df`` are pure pair
  arithmetic, equal bit for bit.  ``_qr_r_cols_partial`` sums its columns in
  row order where JAX's reduction may not: rtol 1e-13 (f64) / 1e-5 (f32)
  of each column's scale.  The f64 Taylor init (nested ``torch.func.jvp``
  against JAX's jet) within 1e-14 of each lane's scale.
* One attempt, op by op (``jax.disable_jit``): every array within rtol
  1e-5 (f32 pairs) / 1e-12 (f64 pairs) of its largest entry, pairs as
  hi + lo in f64, and equal accept masks.  The reference's column sums and
  its exp / log differ from the twin's by an ulp at most.  The f32 gain
  corrects the high-derivative rows of the mean by an O(1) share, so there
  an ulp of the gain is an ulp of the pair; and a hi word rounded the other
  way moves its lo word by as much, so lo halves count only in their pair.
* One interval and whole solves in f64 pairs, against the jitted reference:
  identical step counts, values within 1e-12 (solves: observed identical).
* Whole solves in f32 pairs against the jitted interpret-mode Pallas
  reference: values within 20 rtol (the reference's own bound between its
  f32-pair engine and its oracle, ``tests/test_batched_hi.py:97``); per-lane
  step counts within 1%.  The jitted reference is FMA-contracted on the CPU
  (``ROADMAP.md`` section 3), the twin is not.  Measured over seeds 0-7 at
  rtol 1e-6 and 1e-8 (128 lanes, tspan (0, 5)): no lane's step count
  differed and the values stayed within 0.094 rtol; 1% leaves room for one
  knife-edge accept.  At nu = 6 (seeds 0-7, 32 lanes each) 0-4 lanes a
  seed took other step counts, by up to 2.2% at rtol 1e-6 and 0.57% at
  1e-8, the values within 0.16 rtol; the case here (seed 1, 8 lanes, rtol
  1e-8) is the nu = 4 cases' input.
* Accuracy against LSODA(1e-12): RMSE < 10 rtol at rtol 1e-9 (the
  reference's gate, ``tests/test_batched_hi.py:63``); routed lanes within
  10 max(rtol, 3e-7) each (``tests/test_batched_hi.py:178``).
* Engines, bucketing: bit for bit (the same arithmetic, lanes independent).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.integrate
import torch

from odecheckpts_tpu import batched as jb
from odecheckpts_tpu import batched_hi as jh
from odecheckpts_tpu import problems as jp
from odecheckpts_torch import batched as tb
from odecheckpts_torch import batched_hi as th
from odecheckpts_torch import interop, kernels
from odecheckpts_torch import problems as tp

NP = {"f64": np.float64, "f32": np.float32}
TORCH = {"f64": torch.float64, "f32": torch.float32}
PARAMS = (-2.0, 1.25, -0.5)
INPUT_NAMES = ("atol", "rtol", "dt_max", "dt_floor", "tiny_scale")


def _u0s(batch, seed=0):
    rng = np.random.default_rng(seed)
    return np.array([1.0, 0.0, 0.9]) * (1.0 + 0.05 * rng.standard_normal((batch, 3)))


def _truth(u0_rows, save_at):
    def f(_t, y):
        return [PARAMS[0] * y[1] * y[2], PARAMS[1] * y[0] * y[2], PARAMS[2] * y[0] * y[1]]

    return np.stack([
        scipy.integrate.solve_ivp(
            f, y0=r, t_span=(save_at[0], save_at[-1]), t_eval=save_at,
            rtol=1e-12, atol=1e-12, method="LSODA",
        ).y.T
        for r in u0_rows
    ])


def _normwise_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


def _combined(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _states_close(got, want, rtol):
    """12-array df32 states normwise close: plain arrays and pairs, a pair
    as hi + lo in f64 (a hi word rounded the other way moves its lo word
    by as much)."""
    pairs = (0, 2, 7)  # t, mean, msp
    for i, (g, w) in enumerate(zip(got, want)):
        if i in pairs:
            _normwise_close(_combined(g, got[i + 1]), _combined(w, want[i + 1]), rtol)
        elif i - 1 not in pairs:
            _normwise_close(g, w, rtol)


def _start(nu, dtype, *, batch=16, warm_steps=25, kappa=5.0):
    """A df32 state as numpy arrays, from ``batched_hi.initial_state`` and
    ``warm_steps`` attempts of the twin toward t = 2.5, and the kernel
    inputs; tolerances cycle through rtol 1e-5..1e-9."""
    tols = np.tile(np.array([1e-5, 1e-7, 1e-9, 1e-6]), batch // 4).astype(NP[dtype])
    save_at = np.linspace(0.0, 10.0, 5).astype(NP[dtype])
    vf = tp.rigid_body()[0]
    state, inputs = th.initial_state(vf, torch.tensor(_u0s(batch)), PARAMS, save_at=save_at,
                                     dt0=0.1, tols=torch.tensor(tols), num_derivatives=nu,
                                     dtype=TORCH[dtype])
    t_next = torch.full((1, batch), float(save_at[1]), dtype=TORCH[dtype])
    step = th.make_step_hi(tp.rigid_body_df(), nu=nu, d=3, error_calibration=kappa,
                           dtype=TORCH[dtype])
    for _ in range(warm_steps):
        state = kernels.attempt_plain(step, state, t_next, **inputs)
    extra = (t_next,) + tuple(inputs[k] for k in INPUT_NAMES)
    return interop.state_to_numpy(state), interop.to_numpy(extra)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_rigid_body_df_and_taylor_extrap_match_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(7)
    hi = rng.standard_normal((7, 3, 64)).astype(NP[dtype])
    lo = (hi * np.finfo(NP[dtype]).eps * rng.uniform(-0.5, 0.5, hi.shape)).astype(NP[dtype])
    dt = (10.0 ** rng.uniform(-6, 0, (1, 64))).astype(NP[dtype])
    want = jp.rigid_body_df(PARAMS)(((jnp.asarray(hi[0]), jnp.asarray(lo[0])),), None)
    got = tp.rigid_body_df(PARAMS)(((torch.tensor(hi[0]), torch.tensor(lo[0])),), None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for nu in (4, 5, 6):
        want = jh._taylor_extrap_df((jnp.asarray(hi[: nu + 1]), jnp.asarray(lo[: nu + 1])),
                                    jnp.asarray(dt), nu)
        got = th._taylor_extrap_df((torch.tensor(hi[: nu + 1]), torch.tensor(lo[: nu + 1])),
                                   torch.tensor(dt), nu)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_qr_r_cols_partial_matches_jax(dtype):
    n = 5
    cols = np.random.default_rng(8).standard_normal((2 * n, 2 * n, 32)).astype(NP[dtype])
    want = jh._qr_r_cols_partial([jnp.asarray(c) for c in cols], 2 * n, n)
    got = th._qr_r_cols_partial(torch.tensor(cols), 2 * n, n)
    for g, w in zip(got, want):
        _normwise_close(g.numpy(), w, 1e-13 if dtype == "f64" else 1e-5)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_taylor_init_f64_matches_jax(dtype):
    vf = tp.rigid_body()[0]
    u0s = _u0s(16, seed=2).astype(np.float32)
    for nu in (5, 6):
        want = jh._taylor_init_f64(jp.rigid_body()[0], (u0s,), PARAMS, 0.0, nu=nu, ode_order=1,
                                   split_dtype=NP[dtype])
        got = th._taylor_init_f64(vf, torch.tensor(u0s), PARAMS, 0.0, nu=nu,
                                  split_dtype=TORCH[dtype])
        assert got[0].shape == (16, nu + 1, 3) and got[0].dtype == TORCH[dtype]
        want64, got64 = _combined(*want), _combined(got[0].numpy(), got[1].numpy())
        scale = np.max(np.abs(want64), axis=(1, 2), keepdims=True)
        assert np.all(np.abs(got64 - want64) <= 1e-14 * scale)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("label", ["init", "mid"])
@pytest.mark.parametrize("nu", [4, 5, 6])
def test_one_attempt_matches_jax_make_step_hi(nu, label, dtype):
    state, extra = _start(nu, dtype, warm_steps=0 if label == "init" else 25)
    with jax.disable_jit():
        want = jh.make_step_hi(jp.rigid_body_df(PARAMS), nu=nu, d=3, error_calibration=5.0)(
            tuple(jnp.asarray(x) for x in state), *(jnp.asarray(x) for x in extra))
    want = tuple(np.asarray(x) for x in want)
    step = th.make_step_hi(tp.rigid_body_df(PARAMS), nu=nu, d=3, error_calibration=5.0,
                           dtype=TORCH[dtype])
    got = interop.state_to_numpy(step(interop.state_to_torch(state), *interop.to_torch(extra)))
    accepted = got[0] != state[0]
    np.testing.assert_array_equal(accepted, want[0] != state[0])
    if label == "mid":
        assert 0 < int(np.sum(accepted)) and int(np.sum(got[9] != state[9])) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == NP[dtype]
    _states_close(got, want, 1e-12 if dtype == "f64" else 1e-5)


def _active_hi(s, t_next):
    return (s[0] < t_next) | ((s[0] == t_next) & (s[1] < 0))


def test_one_interval_matches_jax_pallas_interval():
    nu, batch = 4, 16
    state, extra = _start(nu, "f64", batch=batch, warm_steps=0)
    step_j = jh.make_step_hi(jp.rigid_body_df(PARAMS), nu=nu, d=3, error_calibration=5.0)
    jcall = jb._pallas_interval(step_j, interpret=True, lanes=batch,
                                num_state=th.NUM_STATE_HI, active_fn=_active_hi)
    want = jcall(tuple(jnp.asarray(x) for x in state), *(jnp.asarray(x) for x in extra))
    step = th.make_step_hi(tp.rigid_body_df(PARAMS), nu=nu, d=3, error_calibration=5.0,
                           dtype=torch.float64)
    t_next, *rest = interop.to_torch(extra)
    got = kernels.step_hi_interval(step, interop.state_to_torch(state), t_next,
                                   max_attempts=100_000, **dict(zip(INPUT_NAMES, rest)))
    got = interop.state_to_numpy(got)
    np.testing.assert_array_equal(got[0], extra[0])  # every lane snapped onto t_next
    np.testing.assert_array_equal(got[11], np.asarray(want[11]))
    assert np.min(got[11]) > 20
    _states_close(got, tuple(np.asarray(x) for x in want), 1e-12)


def _solvers(*, pair_vf=True, **kw):
    """(JAX vf, JAX kwargs, port vf, port kwargs) of ``make_hi_solver`` over
    (0, 5) with 3 checkpoints; ``pair_vf=False`` leaves ``vf_df`` unset."""
    kw = dict(save_at=np.linspace(0.0, 5.0, 3), dt0=0.1, **kw)
    jkw = dict(kw, vf_df=jp.rigid_body_df(PARAMS) if pair_vf else None)
    tkw = dict(kw, vf_df=tp.rigid_body_df(PARAMS) if pair_vf else None)
    return jp.rigid_body()[0], jkw, tp.rigid_body()[0], tkw


@pytest.mark.parametrize(("rtol", "nu", "pair_vf"), [(1e-6, 4, True), (1e-9, 5, True),
                                                     (1e-7, 4, False), (1e-8, 6, True)])
def test_solve_in_f64_pairs_matches_jax_xla(rtol, nu, pair_vf):
    jvf, jkw, tvf, tkw = _solvers(num_derivatives=nu, pair_vf=pair_vf)
    u0s = _u0s(8).astype(np.float32)
    tols = np.full((8,), rtol)
    (us_j, uf_j, n_j) = jh.make_hi_solver(jvf, PARAMS, engine="xla", lanes=8,
                                          dtype=jnp.float64, **jkw)(jnp.asarray(u0s), tols)
    (us_t, uf_t, n_t) = th.make_hi_solver(tvf, PARAMS, engine="torch", dtype=torch.float64,
                                          **tkw)(torch.tensor(u0s), torch.tensor(tols))
    assert us_t[0].shape == (8, 3, 3) and n_t.dtype == torch.int32
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    for g, w in zip(us_t + uf_t, us_j + uf_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize(("rtol", "nu"), [pytest.param(1e-6, 4, id="1e-06"),
                                         pytest.param(1e-8, 4, id="1e-08"),
                                         pytest.param(1e-8, 6, id="1e-08-nu6")])
def test_solve_in_f32_pairs_matches_jax_pallas_loop(rtol, nu):
    jvf, jkw, tvf, tkw = _solvers(num_derivatives=nu)
    u0s = _u0s(8, seed=1).astype(np.float32)
    tols = np.full((8,), rtol, np.float32)
    (us_j, _, n_j) = jh.make_hi_solver(jvf, PARAMS, engine="pallas-loop", interpret=True,
                                       lanes=8, **jkw)(jnp.asarray(u0s), tols)
    (us_t, _, n_t) = th.make_hi_solver(tvf, PARAMS, engine="cuda-loop", **tkw)(
        torch.tensor(u0s), torch.tensor(tols))
    assert us_t[0].dtype == torch.float32
    u_t, u_j = th.combine64(us_t).numpy(), jh.combine64(us_j)
    assert np.max(np.abs(u_t - u_j)) < 20 * rtol
    n_t, n_j = n_t.numpy()[:, -1], np.asarray(n_j)[:, -1]
    np.testing.assert_allclose(n_t, n_j, rtol=0.01)


def test_f32_pairs_meet_the_accuracy_gate_at_rtol_1e9():
    rtol, save_at = 1e-9, np.linspace(0.0, 10.0, 3)
    u0s = _u0s(8, seed=4).astype(np.float32)
    solve = th.make_hi_solver(tp.rigid_body()[0], PARAMS, save_at=save_at, dt0=0.1,
                              vf_df=tp.rigid_body_df(PARAMS), num_derivatives=5,
                              error_calibration=5.0)
    us, uf, nsteps = solve(torch.tensor(u0s), np.full((8,), rtol, np.float32))
    u = th.combine64(us).numpy()
    truth = _truth(u0s.astype(np.float64), save_at)
    assert float(np.sqrt(np.mean((u - truth) ** 2))) < 10 * rtol
    # plain f32 cannot get near: the steps are many, the smoother moved the interior
    assert np.all(nsteps.numpy()[:, -1] > 100)
    assert float(np.max(np.abs(u[:, 1] - th.combine64(uf).numpy()[:, 1]))) > 0


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_per_attempt_engine_equals_interval_engine_on_cpu(kernel):
    vf, _, _, params = tp.rigid_body()
    u0s = torch.tensor(_u0s(8, seed=5).astype(np.float32))
    save_at = np.linspace(0.0, 5.0, 3)
    if kernel == "K3":
        tols = torch.full((8,), 1e-3)
        outs = [tb.solve_save_at_batched(vf, u0s, params, save_at=save_at, dt0=0.1, tols=tols,
                                         engine=e) for e in ("cuda-loop", "cuda")]
    else:
        tols = torch.full((8,), 1e-7)
        outs = []
        for e in ("cuda-loop", "cuda"):
            us, uf, n = th.make_hi_solver(vf, params, save_at=save_at, dt0=0.1,
                                          vf_df=tp.rigid_body_df(), engine=e)(u0s, tols)
            outs.append((*us, *uf, n))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bucketed_results_equal_unbucketed_per_lane():
    vf, _, _, params = tp.rigid_body()
    u0s = torch.tensor(_u0s(9, seed=6).astype(np.float32))
    tols = torch.tensor(np.array([1e-1, 1e-4, 1e-2, 1e-3] * 2 + [1e-3], np.float32))
    kw = dict(save_at=np.linspace(0.0, 5.0, 3), dt0=0.1)
    (u_s, u_f, n), bucket_max = tb.make_bucketed_solver(vf, params, num_buckets=4, **kw)(
        u0s, tols)
    want = tb.solve_save_at_batched(vf, u0s, params, tols=tols, **kw)
    for g, w in zip((u_s, u_f, n), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # loosest first: each bucket's largest step count is that of the lanes a
    # loosest-first split puts in it (lanes of one tolerance may straddle two
    # buckets, so the maxima need not increase)
    chunks = np.array_split(np.argsort(tols.numpy(), kind="stable")[::-1], 4)
    assert all(float(tols[a.copy()].min()) >= float(tols[b.copy()].max())
               for a, b in zip(chunks, chunks[1:]))
    assert bucket_max == [int(torch.max(want[2][c.copy(), -1])) for c in chunks]
    assert bucket_max[-1] == int(torch.max(want[2][:, -1]))


def test_routed_solver_meets_the_per_lane_gate_across_nine_decades():
    vf, _, _, params = tp.rigid_body()
    save_at = np.linspace(0.0, 5.0, 3)
    rtols = np.asarray([1e-1, 1e-3, 1e-5, 1e-6, 1e-7, 1e-8, 1e-9, 1e-2], np.float32)
    u0s = _u0s(8, seed=3).astype(np.float32)
    solve = th.make_routed_solver(vf, params, save_at=save_at, dt0=0.1,
                                  vf_df=tp.rigid_body_df(params), num_buckets_f32=2)
    u64, nsteps = solve(torch.tensor(u0s), rtols)
    assert u64.dtype == torch.float64 and u64.shape == (8, 3, 3)
    err = np.sqrt(np.mean((u64.numpy() - _truth(u0s.astype(np.float64), save_at)) ** 2,
                          axis=(1, 2)))
    gate = 10.0 * np.maximum(rtols.astype(np.float64), 3e-7)
    assert np.all(err < gate), list(zip(rtols, err))
    assert int(nsteps[6, -1]) > 5 * int(nsteps[0, -1])
    # rtol 1e-5 is at the split and goes to the f32 engine, as in the reference
    loose = rtols >= np.float32(1e-5)
    f32_only = tb.solve_save_at_batched(vf, torch.tensor(u0s[loose]), params, save_at=save_at,
                                        dt0=0.1, tols=torch.tensor(rtols[loose]))
    torch.testing.assert_close(nsteps[torch.tensor(loose)], f32_only[2].long(), rtol=0, atol=0)


@pytest.mark.parametrize("option", [
    # the filter strategy, ode_order 2, TS1 at d = 1 and the residual unit
    # are ported (test_torch_second_order.py); TS1 at d = 3 raises when the
    # solve meets the ensemble's d
    dict(strategy="smoother"), dict(calibration="none"), dict(ode_order=3),
    dict(correction="ts1"), dict(calibration="mle"), dict(num_derivatives=3),
])
def test_unported_hi_options_name_their_roadmap_item(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve = th.make_hi_solver(tp.rigid_body()[0], PARAMS, save_at=np.linspace(0, 5, 3),
                                  dt0=0.1, vf_df=tp.rigid_body_df(), **option)
        solve(torch.tensor(_u0s(4)), torch.full((4,), 1e-6))


@pytest.mark.parametrize("guard", ["num_derivatives", "shard_mesh"])
def test_hi_guards_name_their_current_roadmap_items(guard):
    """Other nu: queue 1 item 2 (options the fused engines left out).
    shard_mesh is ported (item 8, ``tests/test_torch_parallel.py``): what is
    not a 1-D ``DeviceMesh`` with the named axis is refused when the solver
    is built."""
    if guard == "num_derivatives":
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2$"):
            th.StepHi(tp.rigid_body_df(), nu=3, d=3, error_calibration=1.0)
    else:
        with pytest.raises(ValueError, match="1-D torch.distributed DeviceMesh with the axis 'x'"):
            th.make_hi_solver(tp.rigid_body()[0], PARAMS, save_at=np.linspace(0, 5, 3), dt0=0.1,
                              vf_df=tp.rigid_body_df(), shard_mesh=object(), shard_axis="x")


def test_hi_solver_guards_memory_and_the_kernels_refuse_other_devices():
    solve = th.make_hi_solver(tp.rigid_body()[0], PARAMS, save_at=np.linspace(0, 5, 3),
                              dt0=0.1, vf_df=tp.rigid_body_df(), hbm_budget=1024)
    with pytest.raises(MemoryError, match="Reduce the batch"):
        solve(torch.tensor(_u0s(8).astype(np.float32)), np.full(8, 1e-6, np.float32))
    state, extra = _start(4, "f32", batch=4, warm_steps=0)
    step = th.make_step_hi(tp.rigid_body_df(), nu=4, d=3, error_calibration=5.0)
    meta = tuple(torch.tensor(x).to("meta") for x in state)
    t_next, *rest = (torch.tensor(x).to("meta") for x in extra)
    for fn, kw in ((kernels.step_hi_interval, dict(max_attempts=1)),
                   (kernels.step_hi_attempt, {})):
        with pytest.raises(ValueError, match="CUDA"):
            fn(step, meta, t_next, **dict(zip(INPUT_NAMES, rest)), **kw)
