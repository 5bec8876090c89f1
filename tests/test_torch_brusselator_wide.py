"""Port differential tests: experiment 4's batched Brusselator ensembles on
the df32 engine (``problems.brusselator`` at any N, its hi-channel functor
``"brusselator_hi"``, the wide forms of K2 and K4 and their plain versions,
``experiments/4_brusselator/batched_torch.py``) against the JAX reference.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances and why:

* The vector field: the same operations in the same order on the same
  inputs, op by op in both packages: bit for bit in f32 and f64.
* Whole solves in f64 pairs (N = 4, 8 lanes, 3 checkpoints over (0, 0.1),
  dt0 1e-5, tol 1e-6) against the jitted reference: identical per-lane step
  counts, values (hi + lo) within 1e-10 of each array's largest entry.
* The same in f32 pairs against the reference jitted without XLA's
  rewrites of its arithmetic (``tests/torch_uncontracted.py``'s flags, in a
  subprocess): values within 20 tol (``tests/test_torch_batched_hi.py``'s
  bound between the two engines).  Step counts are held per lane within 10%
  and in sum within 5%, not exactly: the vector field runs on the hi words
  in f32, so the error estimate carries f32 evaluation noise (the hi
  channel's floor, about rtol 1e-7), and where an attempt's error norm is
  that close to 1 the reference's own exp and log (XLA's, the twin takes
  them correctly rounded) decide it the other way.  Measured here: per lane
  at most 2 steps of 44-51 apart (4.5%), 376 against 365 in sum (3.0%); the
  jitted, contracted reference differed by up to 23% on one lane.
* The plain versions of K2 wide and K4 wide are the twin's loop and its
  attempt: equal bit for bit.

The card-only cases are in ``tests/test_torch_kernels.py`` (``-m cuda -k
hi_wide``), which imports no JAX.
"""

import importlib.util
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_uncontracted as uncontracted

from odecheckpts_tpu import batched_hi as jh
from odecheckpts_tpu import problems as jp
from odecheckpts_torch import batched_hi as th
from odecheckpts_torch import kernels
from odecheckpts_torch import problems as tp

NP = {"f64": np.float64, "f32": np.float32}
TORCH = {"f64": torch.float64, "f32": torch.float32}
INPUT_NAMES = ("atol", "rtol", "dt_max", "dt_floor", "tiny_scale")
SAVE_AT = np.linspace(0.0, 0.1, 3)
DT0 = 1e-5
TOL = 1e-6
RUNNER = Path(__file__).resolve().parents[1] / "experiments" / "4_brusselator" / "batched_torch.py"


def _u0s(N, batch, seed=0):
    x0 = np.linspace(0.0, 1.0, N)
    y0 = np.concatenate([np.sin(2.0 * np.pi * x0) + 1.0, np.full(N, 3.0)])
    rng = np.random.default_rng(seed)
    return (y0[None] * (1.0 + 0.01 * rng.standard_normal((batch, 2 * N)))).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("N", [4, 32, 64])
def test_brusselator_vector_field_matches_jax_bit_for_bit(N, dtype):
    y = _u0s(N, 8, seed=N).T.astype(NP[dtype])  # (2N, 8): a lanes-last ensemble
    y = y * (1.0 + 0.1 * np.random.default_rng(1).standard_normal(y.shape)).astype(NP[dtype])
    want = np.asarray(jp.brusselator(N, laplacian="slices")[0](jnp.asarray(y)))
    vf = tp.brusselator(N)[0]
    got = vf(torch.tensor(y)).numpy()
    assert got.dtype == want.dtype == NP[dtype] and got.shape == (2 * N, 8)
    np.testing.assert_array_equal(got, want)
    assert vf.device_functor == "brusselator" and vf.device_params == ((N + 1) ** 2 / 50.0,)


# the reference's f32-pair solve under uncontracted.FLAGS (a fresh process:
# the flags take effect only before JAX's backend starts)
_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from odecheckpts_tpu import batched_hi as jh, problems as jp
d = np.load(sys.argv[1])
vf = jp.brusselator(int(d["N"]), laplacian="slices")[0]
us, _, n = jh.make_hi_solver(vf, (), save_at=d["save_at"], dt0=float(d["dt0"]), engine="xla",
                             lanes=int(d["lanes"]))(jnp.asarray(d["u0s"]), d["tols"])
np.savez(sys.argv[2], u=np.asarray(jh.combine64(us)), n=np.asarray(n))
"""


def _reference_f32_uncontracted(N, u0s, tols):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} {uncontracted.FLAGS}".strip()
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(uncontracted.ROOT),
                                                      env.get("PYTHONPATH")]))
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.npz", Path(tmp) / "out.npz"
        np.savez(src, N=N, save_at=SAVE_AT, dt0=DT0, lanes=len(u0s), u0s=u0s, tols=tols)
        proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(src), str(dst)], env=env,
                              cwd=uncontracted.ROOT, capture_output=True, text=True,
                              timeout=600, check=False)
        assert proc.returncode == 0, proc.stderr[-4000:]
        out = np.load(dst)
        return out["u"], out["n"]


def _solve_both(dtype, batch=8):
    N = 4
    u0s = _u0s(N, batch, seed=3)
    tols = np.full((batch,), TOL, NP[dtype])
    tvf = tp.brusselator(N)[0]
    if dtype == "f64":
        want = jh.make_hi_solver(jp.brusselator(N, laplacian="slices")[0], (), save_at=SAVE_AT,
                                 dt0=DT0, engine="xla", lanes=batch,
                                 dtype=jnp.float64)(jnp.asarray(u0s), tols)
    else:
        want = _reference_f32_uncontracted(N, u0s, tols)
    # f32 pairs through the wide wrappers (their plain versions on the CPU)
    engine = "torch" if dtype == "f64" else "cuda-loop"
    got = th.make_hi_solver(tvf, (), save_at=SAVE_AT, dt0=DT0, engine=engine,
                            dtype=TORCH[dtype])(torch.tensor(u0s), torch.tensor(tols))
    return got, want


def test_solve_in_f64_pairs_matches_jax_xla():
    (us_t, uf_t, n_t), (us_j, uf_j, n_j) = _solve_both("f64")
    assert us_t[0].shape == (8, 3, 8) and us_t[0].dtype == torch.float64
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert int(n_t[:, -1].min()) > 10
    for g, w in ((us_t, us_j), (uf_t, uf_j)):  # pairs as hi + lo
        w = jh.combine64(w)
        np.testing.assert_allclose(th.combine64(g).numpy(), w, rtol=0,
                                   atol=1e-10 * np.max(np.abs(w)))


def test_solve_in_f32_pairs_matches_jax_uncontracted():
    (us_t, _uf, n_t), (u_j, n_j) = _solve_both("f32")
    assert us_t[0].dtype == torch.float32
    assert np.max(np.abs(th.combine64(us_t).numpy() - u_j)) < 20 * TOL
    n_t, n_j = n_t.numpy()[:, -1], n_j[:, -1]
    assert np.min(n_j) > 40
    np.testing.assert_allclose(n_t, n_j, rtol=0.10)
    assert abs(int(n_t.sum()) - int(n_j.sum())) <= 0.05 * int(n_j.sum())


def _start(N=4, batch=8, nu=4, **step_kw):
    """The runner's kind of ensemble after the f64 Taylor init, tolerances
    1e-5..1e-8, and the df32 twin on the Brusselator's hi channel."""
    vf = tp.brusselator(N)[0]
    tols = torch.tensor(np.geomspace(1e-5, 1e-8, batch), dtype=torch.float32)
    state, inputs = th.initial_state(vf, torch.tensor(_u0s(N, batch)), (),
                                     save_at=np.float32(SAVE_AT * 25), dt0=DT0, tols=tols,
                                     num_derivatives=nu)
    step = th.make_step_hi(th.wrap_vf_plain(vf, ()), nu=nu, d=2 * N, **step_kw)
    t_next = torch.full((1, batch), float(SAVE_AT[1] * 25))
    return step, state, t_next, inputs


@pytest.mark.parametrize("kernel", ["step_hi_wide_interval-1", "step_hi_wide_interval-40",
                                    "step_hi_wide_attempt"])
def test_wide_wrappers_run_the_twin_on_cpu(kernel):
    """On CPU tensors the wide wrappers run their plain versions, which are
    the twin's interval loop (while any lane is short of the checkpoint, at
    most ``max_attempts`` attempts) and its single attempt; no kernel runs."""
    step, state, t_next, inputs = _start(nu=5)
    assert step.device_functor == "brusselator_hi" and kernels.hi_wide(step.device_functor)
    name, _, cap = kernel.partition("-")
    attempts = int(cap) if cap else 1
    want = state
    for _ in range(attempts):
        if cap and not bool(torch.any(kernels.active_hi(want, t_next))):
            break
        want = step(want, t_next, *(inputs[k] for k in INPUT_NAMES))
    before = dict(kernels.LAUNCHES)
    kw = dict(max_attempts=attempts) if cap else {}
    for fn in (getattr(kernels, name), getattr(kernels, name + "_plain")):
        got = fn(step, state, t_next, **inputs, **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kernels.LAUNCHES == before
    assert 0 < float((want[11] - state[11]).max()) <= attempts


def test_the_df32_driver_routes_a_row_functor_to_the_wide_forms(monkeypatch):
    """``make_hi_solver`` on ``problems.brusselator`` (``vf_df=None``) runs
    the wide wrappers: once an interval on ``"cuda-loop"``, once an attempt
    on ``"cuda"``; the rigid body keeps K2 and K4."""
    calls = {}

    def counting(name):
        wrapper = getattr(kernels, name)

        def run(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return wrapper(*args, **kw)

        monkeypatch.setattr(kernels, name, run)

    for name in ("step_hi_wide_interval", "step_hi_wide_attempt", "step_hi_interval"):
        counting(name)
    vf = tp.brusselator(4)[0]
    u0s, tols = torch.tensor(_u0s(4, 2)), torch.full((2,), 1e-4)
    out = [th.make_hi_solver(vf, (), save_at=SAVE_AT, dt0=DT0, engine=e)(u0s, tols)
           for e in ("cuda-loop", "cuda")]
    assert calls["step_hi_wide_interval"] == len(SAVE_AT) - 1
    assert calls["step_hi_wide_attempt"] >= int(out[1][2][:, -1].max())
    assert "step_hi_interval" not in calls
    for a, b in zip(out[0][0] + out[0][1] + (out[0][2],), out[1][0] + out[1][1] + (out[1][2],)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kernels.hi_channel_functor("brusselator") == "brusselator_hi"
    assert not kernels.hi_wide(kernels.hi_channel_functor("three_body_restricted"))


@pytest.mark.parametrize("option", ["filter", "ode_order=2", "nu=3", "ts1"])
def test_wide_forms_refuse_what_they_are_not_built_for(option):
    """Only nu = 4, 5, fixedpoint, TS0 and order 1 are built on the wide
    forms; the rest raises ``NotImplementedError`` naming ROADMAP queue 1
    item 2, before any launch (nu = 3 and TS1 at d > 1 in the twin
    already; nu = 3 by the fused engines' shared check, whose text still
    names item 5; nu = 6: ``tests/test_torch_order_sweep.py``)."""
    vf_df = th.wrap_vf_plain(tp.brusselator(4)[0], ())
    item = "5" if option == "nu=3" else "2"
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 item {item}"):
        if option == "nu=3":
            th.make_step_hi(vf_df, nu=3, d=8)
        elif option == "ts1":
            th.make_step_hi(vf_df, nu=4, d=8, correction="ts1")
        else:
            kw = dict(strategy="filter") if option == "filter" else dict(ode_order=2)
            step = th.make_step_hi(vf_df, nu=4, d=8, **kw)
            kernels._variant_flags("step_hi_wide_interval", "brusselator_hi", step)
    step = th.make_step_hi(vf_df, nu=5, d=8)
    assert kernels._variant_flags("step_hi_wide_attempt", "brusselator_hi", step) == ()


def test_wide_wrappers_refuse_other_devices_and_odd_or_wide_dimensions():
    """Before a launch: tensors not on a CUDA device, and a step whose d is
    odd or above 1,024 (the wide entries take any even d up to a block of
    1,024 threads; the other entries their functor's own d)."""
    step, state, t_next, inputs = _start(batch=4)
    meta = tuple(x.to("meta") for x in state)
    for fn, kw in ((kernels.step_hi_wide_interval, dict(max_attempts=1)),
                   (kernels.step_hi_wide_attempt, {})):
        with pytest.raises(ValueError, match="CUDA"):
            fn(step, meta, t_next.to("meta"), **{k: v.to("meta") for k, v in inputs.items()},
               **kw)
    for d in (2, 64, 1024):
        wide_step = th.make_step_hi(step.vf_df, nu=4, d=d)
        assert kernels._functor_entry("step_hi_wide_attempt", wide_step) == (
            "odeckpt_step_hi_wide_attempt_brusselator_hi", kernels.HI_WIDE_D)
    for d in (7, 1026):
        with pytest.raises(ValueError, match="even d <= 1024"):
            kernels._functor_entry("step_hi_wide_interval", th.make_step_hi(step.vf_df, nu=4, d=d))
    rigid = th.make_step_hi(tp.rigid_body_df(), nu=4, d=4)
    with pytest.raises(ValueError, match="has d=3"):
        kernels._functor_entry("step_hi_interval", rigid)


@pytest.mark.parametrize(("d", "threads", "smem", "bound"), [
    (64, 64, 2220, 128), (128, 128, 2988, 128), (48, 64, 2028, 128), (130, 160, 3012, 1024),
    (1024, 1024, 13740, 1024)])
def test_hi_wide_geometry_is_a_block_per_lane(d, threads, smem, bound):
    """K2 wide's and K4 wide's launch geometry: one block per lane, a thread
    per component in whole warps, and the lane's 363 floats (scalars,
    decisions, chol and G_acc twice each, the gain, g_corr, the constants A
    and Lq, warp 0's scratch, the next attempt's step scalars) and three
    rows of d floats in shared memory;
    d at most 1,024; blocks of up to 128 threads on the instantiation
    bounded at 128 threads, wider ones on the one bounded at 1,024."""
    for nu in (4, 5):
        assert kernels.hi_wide_geometry(nu, d) == {
            "threads_per_lane": d, "lanes_per_block": 1, "threads_per_block": threads,
            "smem_bytes": smem, "max_threads": bound}
    assert smem == 4 * (363 + 3 * d)


def test_hi_wide_geometry_refuses_what_is_not_built():
    with pytest.raises(ValueError, match="d <= 1024"):
        kernels.hi_wide_geometry(4, 1025)
    with pytest.raises(ValueError, match="nu = 4 and 5"):
        kernels.hi_wide_geometry(6, 64)
    with pytest.raises(ValueError, match="not a wide form"):
        kernels.step_hi_wide_geometry("step_hi_interval")


def test_runner_row_passes_its_gate_on_cpu():
    spec = importlib.util.spec_from_file_location("batched_torch", RUNNER)
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    row = runner.run_row(N=4, batch=4, tol=1e-4, engine="torch", device="cpu")
    assert row["finite"] and row["gate_ok"] and row["capped_lanes"] == 0
    assert np.isfinite(row["rmse_vs_lsoda"]) and row["rmse_vs_lsoda"] < 1e3 * 1e-4
    assert row["state_dim"] == 8 and row["mean_steps"] > 10 and row["launches"] == {}
    vf, save_at, y0s = runner.workload(4, 3)
    assert y0s.dtype == np.float32 and y0s.shape == (3, 8) and list(save_at) == [
        0.0, 2.5, 5.0, 7.5, 10.0]


def test_runner_and_chip_smoke_import_no_jax():
    """The torch runner (its solver built) and ``chip_smoke.py`` load
    neither JAX nor the JAX package."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('batched_torch', {str(RUNNER)!r})\n"
        "runner = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(runner)\n"
        "runner.make_solver(4, 'torch')\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'odecheckpts_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=False, timeout=120, cwd=RUNNER.parents[2])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
