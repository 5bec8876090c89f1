"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
device, ``nvcc`` (CUDA_HOME or /usr/local/cuda) and scipy, and exits non-zero
if any phase fails.  The workload is the bench's (32,768 rigid-body IVPs,
u0 (1 + 0.05 N(0, 1)) from numpy seed 0, tspan (0, 50), 5 checkpoints,
dt0 0.1, atol 1e-3 rtol), gated against LSODA(1e-12) truth on 256 lanes:
RMSE < 3 rtol, worst lane < 6 rtol, no lane at the attempt cap.  Phases:

1. device: versions and the card's name and power limit; full-f32 matmuls.
2. build: compiles K1-K4 (odecheckpts_torch/csrc/, one nvcc per source, in
   parallel) and reports the build time and ptxas registers and spills per
   kernel and nu.
3. one attempt, kernel against twin, 4,096 lanes, from the Taylor-initialized
   and a mid-solve state: K1 and K3 at nu = 2, 3, 4 (17 arrays), K2 and K4
   at nu = 4, 5 (12 arrays).
4. f32 main path (K1): ``batched.solve_save_at_batched(engine="cuda-loop")``
   at rtol 1e-1..1e-4, parity and tuned (nu, kappa) schedules; exactly 4
   launches per solve; the median of 3 timed solves after one warm-up.
5. f32 twin on the card: the rtol 1e-3 parity row through ``engine="torch"``
   and one interval of K1 against its plain version, timed.
6. df32 main path (K2): ``batched_hi.make_hi_solver(engine="cuda-loop")`` at
   rtol 1e-5..1e-9, the 7 distinct parity and tuned rows; exactly 4 launches
   per solve; median of 3 timed solves after one warm-up; the f64 Taylor
   init timed on its own.
7. df32 twin on the card: the rtol 1e-5 parity row through
   ``engine="torch"`` and one interval of K2 against its plain version.
8. per-attempt engines: K3 (``engine="cuda"``, rtol 1e-3 parity) and K4
   (rtol 1e-7 parity) give the step counts and outputs of K1 and K2; one
   launch of each against its plain version, timed.
9. routed: ``batched_hi.make_routed_solver(engine="cuda-loop")`` on 32,768
   lanes whose rtol cycles through 1e-1..1e-9, split as the bench splits
   them (rtol >= 1e-4 to f32); every truth lane within 10 max(rtol, 3e-7);
   K1 and K2 both launch.
10. the kernel table line and the result line.

Each path of phases 4, 6, 8 and 9 runs with the launch counts set to 0 just
before it and read just after; a kernel of the path that did not launch
fails the run.  Kernel-against-plain comparisons run outside those windows.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

RTOLS = (1e-1, 1e-2, 1e-3, 1e-4)
# (nu, kappa) per rtol: the bench's parity and tuned schedules (bench.py:82-143)
SCHEDULES = {
    "parity": {1e-1: (4, 1.0), 1e-2: (4, 1.0), 1e-3: (4, 3.0), 1e-4: (4, 10.0)},
    "tuned": {1e-1: (2, 10.0), 1e-2: (2, 10.0), 1e-3: (3, 20.0), 1e-4: (4, 10.0)},
}
RTOLS_HI = (1e-5, 1e-6, 1e-7, 1e-8, 1e-9)
SCHEDULES_HI = {
    "parity": {1e-5: (4, 5.0), 1e-6: (4, 3.0), 1e-7: (4, 2.0), 1e-8: (4, 2.0), 1e-9: (4, 2.0)},
    "tuned": {1e-8: (5, 5.0), 1e-9: (5, 5.0)},  # the rows where tuned differs
}
BATCH = 32_768
SAMPLE = 256
ATTEMPT_LANES = 4_096
ATTEMPT_RTOL = 1e-3
ATTEMPT_RTOL_HI = 1e-7
MID_ATTEMPTS = 50
ATTEMPT_RTOL_TOL = 1e-5
RMSE_FACTOR = 3.0
LANE_FACTOR = 6.0
ROUTED_FACTOR = 10.0  # per lane, of max(rtol, ROUTED_FLOOR): tests/test_batched_hi.py:178
ROUTED_FLOOR = 3e-7
# the bench's partition (bench.py:61-62): rtol 1e-1..1e-4 in f32, 1e-5..1e-9 in
# df32.  The reference's default split 1e-5 sends rtol 1e-5 to the f32 engine,
# whose accuracy floor (~2e-5 on this problem, bench.py:57-59) misses the
# 10x gate on some of those lanes (ROADMAP section 3).
ROUTED_SPLIT = 1e-4
MAX_ATTEMPTS = 100_000
MAX_STEP_MISMATCH = 0.01
REPEATS = 3  # timed solves per row; the median is reported
TSPAN = (0.0, 50.0)
NUM_SAVE = 5
DT0 = 0.1
SEED = 0
STATE_NAMES = (
    "t", "mean", "chol", "bwdG", "bwd_m", "bwd_L", "scale", "t_prev", "mean_prev",
    "chol_prev", "bwdG_prev", "bwd_m_prev", "bwd_L_prev", "dt", "errn_prev",
    "nsteps", "mle",
)
STATE_NAMES_HI = (
    "t_hi", "t_lo", "mean_hi", "mean_lo", "chol", "scale", "G_acc", "msp_hi", "msp_lo",
    "dt", "errn_prev", "nsteps",
)
KERNELS = {  # wrapper -> (id, source, the TPU kernel it replaces)
    "step_ll_interval": ("K1", "odecheckpts_torch/csrc/step_ll.cu",
                         "odecheckpts_tpu/batched.py:544"),
    "step_hi_interval": ("K2", "odecheckpts_torch/csrc/step_hi.cu",
                         "odecheckpts_tpu/batched_hi.py:539"),
    "step_ll_attempt": ("K3", "odecheckpts_torch/csrc/step_ll_attempt.cu",
                        "odecheckpts_tpu/batched.py:897"),
    "step_hi_attempt": ("K4", "odecheckpts_torch/csrc/step_hi_attempt.cu",
                        "odecheckpts_tpu/batched_hi.py:547"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; nothing was run")
    emit({"phase": "device", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0), smi


def phase_build():
    from odecheckpts_torch import kernels

    lib = kernels.library()
    ptxas = kernels.parse_ptxas(lib.log)
    emit({"phase": "build", "seconds": lib.seconds, "ptxas": ptxas})
    want = {"step_ll_interval": (2, 3, 4), "step_ll_attempt": (2, 3, 4),
            "step_hi_interval": (4, 5), "step_hi_attempt": (4, 5)}
    missing = [(k, nu) for k, nus in want.items() for nu in nus
               if "registers" not in ptxas.get(k, {}).get(nu, {})]
    if missing:
        raise RuntimeError(f"ptxas reported no kernel for {missing}:\n{lib.log}")
    return ptxas


def _ensemble(batch, torch, device):
    rng = np.random.default_rng(SEED)
    u0 = np.array([1.0, 0.0, 0.9])
    rows = (u0[None] * (1.0 + 0.05 * rng.standard_normal((batch, 3)))).astype(np.float32)
    return torch.tensor(rows, device=device)


def _save_at():
    return np.linspace(TSPAN[0], TSPAN[1], NUM_SAVE).astype(np.float32)


def _deviations(names, got, want, torch, pairs=()):
    """Max abs / rel deviation per array; the names of arrays beyond
    ATTEMPT_RTOL_TOL (lo halves of ``pairs`` are judged with their hi half)."""
    devs, bad, worst = {}, [], 0.0
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        err = torch.abs(g - w)
        scale = torch.clamp(torch.abs(w), min=float(torch.amax(torch.abs(w))) * 1e-3)
        rel = float(torch.amax(err / torch.clamp(scale, min=1e-30)))
        devs[name] = [float(torch.amax(err)), rel]
        worst = max(worst, float(torch.amax(err)))
        if i - 1 in pairs:
            pair_err = torch.abs((got[i - 1].double() + g.double()) - (want[i - 1].double() + w.double()))
            rel = float(torch.amax(pair_err)) / max(float(torch.amax(torch.abs(want[i - 1]))), 1e-30)
        if not bool(torch.all(torch.isfinite(g) == torch.isfinite(w))) or rel > ATTEMPT_RTOL_TOL:
            bad.append(name)
    return devs, bad, worst


def phase_attempt(device):
    """One attempt of K1 (max_attempts=1) and of K3 against one step of the
    twin; returns the largest deviation of each."""
    import torch

    from odecheckpts_torch import batched, kernels, problems

    vf, _, _, params = problems.rigid_body(time_span=TSPAN)
    u0s = _ensemble(ATTEMPT_LANES, torch, device)
    tols = torch.full((ATTEMPT_LANES,), ATTEMPT_RTOL, dtype=torch.float32, device=device)
    save_at = _save_at()
    worst = {"step_ll_interval": 0.0, "step_ll_attempt": 0.0}
    for nu in (2, 3, 4):
        state, _, inputs = batched.initial_state(
            vf, u0s, params, save_at=save_at, dt0=DT0, tols=tols, num_derivatives=nu
        )
        step = batched.make_step_ll(vf, params, nu=nu, d=3, error_calibration=3.0)
        t_next = torch.full((1, ATTEMPT_LANES), float(save_at[1]), device=device)
        mid = state
        for _ in range(MID_ATTEMPTS):
            mid = kernels.attempt_plain(step, mid, t_next, **inputs)
        for label, start in (("init", state), ("mid", mid)):
            want = kernels.attempt_plain(step, start, t_next, **inputs)
            for name, got in (
                ("step_ll_interval", kernels.step_ll_interval(step, start, t_next, max_attempts=1,
                                                              **inputs)),
                ("step_ll_attempt", kernels.step_ll_attempt(step, start, t_next, **inputs)),
            ):
                torch.cuda.synchronize()
                devs, bad, w = _deviations(STATE_NAMES, got, want, torch)
                worst[name] = max(worst[name], w)
                emit({"phase": "attempt", "kernel": KERNELS[name][0], "nu": nu, "state": label,
                      "max_abs_and_rel_dev": devs})
                if bad:
                    raise AssertionError(
                        f"{KERNELS[name][0]} and its twin disagree beyond rel "
                        f"{ATTEMPT_RTOL_TOL} at nu={nu} ({label}) in {bad}"
                    )
    return worst


def _hi_state(u0s, tols, nu, torch):
    """The df32 solver's initial state and inputs, and t_next = save_at[1]."""
    from odecheckpts_torch import batched_hi, problems

    vf, _, _, params = problems.rigid_body(time_span=TSPAN)
    save_at = _save_at()
    state, inputs = batched_hi.initial_state(vf, u0s, params, save_at=save_at, dt0=DT0,
                                             tols=tols, num_derivatives=nu)
    return state, inputs, torch.full((1, u0s.shape[0]), float(save_at[1]), device=u0s.device)


def phase_attempt_hi(device):
    """One attempt of K2 (max_attempts=1) and of K4 against one step of the
    df32 twin; returns the largest deviation of each."""
    import torch

    from odecheckpts_torch import batched_hi, kernels, problems

    u0s = _ensemble(ATTEMPT_LANES, torch, device)
    tols = torch.full((ATTEMPT_LANES,), ATTEMPT_RTOL_HI, dtype=torch.float32, device=device)
    worst = {"step_hi_interval": 0.0, "step_hi_attempt": 0.0}
    for nu in (4, 5):
        state, inputs, t_next = _hi_state(u0s, tols, nu, torch)
        step = batched_hi.make_step_hi(problems.rigid_body_df(), nu=nu, d=3, error_calibration=2.0)
        mid = state
        for _ in range(MID_ATTEMPTS):
            mid = kernels.attempt_plain(step, mid, t_next, **inputs)
        for label, start in (("init", state), ("mid", mid)):
            want = kernels.attempt_plain(step, start, t_next, **inputs)
            for name, got in (
                ("step_hi_interval", kernels.step_hi_interval(step, start, t_next, max_attempts=1,
                                                              **inputs)),
                ("step_hi_attempt", kernels.step_hi_attempt(step, start, t_next, **inputs)),
            ):
                torch.cuda.synchronize()
                devs, bad, w = _deviations(STATE_NAMES_HI, got, want, torch, pairs=(0, 2, 7))
                worst[name] = max(worst[name], w)
                emit({"phase": "attempt_hi", "kernel": KERNELS[name][0], "nu": nu,
                      "state": label, "max_abs_and_rel_dev": devs})
                if bad:
                    raise AssertionError(
                        f"{KERNELS[name][0]} and its twin disagree beyond rel "
                        f"{ATTEMPT_RTOL_TOL} at nu={nu} ({label}) in {bad}"
                    )
    return worst


def _truth(u0_rows, save_at):
    """Per-lane scipy LSODA(1e-12) reference at the checkpoints."""
    import scipy.integrate

    p1, p2, p3 = -2.0, 1.25, -0.5

    def vf_np(_t, y):
        return [p1 * y[1] * y[2], p2 * y[0] * y[2], p3 * y[0] * y[1]]

    out = []
    for row in u0_rows:
        sol = scipy.integrate.solve_ivp(
            vf_np, y0=row, t_span=(float(save_at[0]), float(save_at[-1])),
            t_eval=save_at, rtol=1e-12, atol=1e-12, method="LSODA",
        )
        out.append(sol.y.T)
    return np.stack(out)


def _lane_errors(u_s, truth):
    u = u_s[:SAMPLE].double().cpu().numpy()
    return np.sqrt(np.mean((u - truth) ** 2, axis=(1, 2)))


def _gates(u_s, nsteps, truth, rtol):
    from odecheckpts_torch import harness

    u = u_s[:SAMPLE].double().cpu().numpy()
    rmse = float(harness.rmse_absolute(truth)(u))
    worst = float(np.max(_lane_errors(u_s, truth)))
    inc = np.diff(nsteps.cpu().numpy().astype(np.int64), axis=1)
    capped = int(np.sum(np.any(inc >= MAX_ATTEMPTS, axis=1)))
    ok = np.isfinite(rmse) and rmse < RMSE_FACTOR * rtol and worst < LANE_FACTOR * rtol and capped == 0
    return ok, rmse, worst, capped


def _timed(fn):
    from odecheckpts_torch import harness

    harness.device_sync(None)
    t0 = time.perf_counter()
    out = harness.device_sync(fn())
    return time.perf_counter() - t0, out


def _path(names, fn):
    """Run one path of the port with every launch count set to 0 just before
    it; fail unless each kernel in ``names`` launched.  Returns (fn's result,
    the counts read just after)."""
    from odecheckpts_torch import kernels

    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    out = fn()
    counts = dict(kernels.LAUNCHES)
    missing = [KERNELS[n][0] for n in names if counts[n] == 0]
    if missing:
        raise AssertionError(f"the path launched {missing} no time: {counts}")
    return out, counts


def _row(phase, schedule, rtol, nu, kappa, solve, truth, kernel, combine=None):
    """Warm-up plus REPEATS timed solves of one row; gates and launches."""
    import torch

    from odecheckpts_torch import kernels

    solve()  # warm-up
    times, launches = [], set()
    for _ in range(REPEATS):
        before = kernels.LAUNCHES[kernel]
        secs, (u_s, u_f, nsteps) = _timed(solve)
        launches.add(kernels.LAUNCHES[kernel] - before)
        times.append(secs)
    if combine is not None:
        u_s, u_f = combine(u_s), combine(u_f)
    seconds = float(np.median(times))
    launches = launches.pop() if len(launches) == 1 else sorted(launches)
    finite = bool(torch.all(torch.isfinite(u_s))) and bool(torch.all(torch.isfinite(u_f)))
    shapes = (tuple(u_s.shape), tuple(u_f.shape), tuple(nsteps.shape))
    ok, rmse, worst, capped = _gates(u_s, nsteps, truth, rtol)
    row = {
        "phase": phase, "schedule": schedule, "rtol": rtol, "nu": nu, "kappa": kappa,
        "batch": BATCH, "seconds": seconds, "seconds_all": times,
        "solves_per_sec": BATCH / seconds,
        "mean_steps": float(nsteps[:, -1].double().mean()),
        "rmse_over_rtol": rmse / rtol, "worst_lane_over_rtol": worst / rtol,
        "capped_lanes": capped, "launches": launches,
    }
    emit(row)
    want_shapes = ((BATCH, NUM_SAVE, 3), (BATCH, NUM_SAVE, 3), (BATCH, NUM_SAVE))
    failed = not (ok and finite and launches == NUM_SAVE - 1 and shapes == want_shapes)
    return row, (u_s, nsteps), (failed, schedule, rtol, ok, finite, launches, shapes)


def phase_main(device, truth, u0s):
    import torch

    from odecheckpts_torch import batched, problems

    vf, _, _, params = problems.rigid_body(time_span=TSPAN)
    save_at = _save_at()
    failed, kernel_out = [], {}
    for schedule, table in SCHEDULES.items():
        for rtol in RTOLS:
            nu, kappa = table[rtol]
            tols = torch.full((BATCH,), rtol, dtype=torch.float32, device=device)

            def solve(nu=nu, kappa=kappa, tols=tols):
                return batched.solve_save_at_batched(
                    vf, u0s, params, save_at=save_at, dt0=DT0, tols=tols,
                    num_derivatives=nu, error_calibration=kappa, engine="cuda-loop",
                    max_attempts=MAX_ATTEMPTS,
                )

            row, out, check = _row("main", schedule, rtol, nu, kappa, solve, truth,
                                   "step_ll_interval")
            if schedule == "parity" and rtol == 1e-3:
                kernel_out = {"seconds": row["seconds"], "u_s": out[0], "nsteps": out[1]}
            if check[0]:
                failed.append(check[1:])
    if failed:
        raise AssertionError(f"main-path rows failed (gates, finite, launches, shapes): {failed}")
    return kernel_out


def _time_pair(fns):
    """CUDA-event times of ``fns`` (name -> thunk) in the order given."""
    import torch

    times = {}
    for name, fn in fns:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times[name] = (start.elapsed_time(end), out)
    return times


def phase_twin(device, truth, u0s, kernel_out):
    import torch

    from odecheckpts_torch import batched, kernels, problems

    vf, _, _, params = problems.rigid_body(time_span=TSPAN)
    save_at = _save_at()
    rtol = 1e-3
    nu, kappa = SCHEDULES["parity"][rtol]
    tols = torch.full((BATCH,), rtol, dtype=torch.float32, device=device)

    def solve():
        return batched.solve_save_at_batched(
            vf, u0s, params, save_at=save_at, dt0=DT0, tols=tols, num_derivatives=nu,
            error_calibration=kappa, engine="torch", max_attempts=MAX_ATTEMPTS,
        )

    solve()  # warm-up
    seconds, (u_s, _u_f, nsteps) = _timed(solve)
    ok, rmse, worst, capped = _gates(u_s, nsteps, truth, rtol)
    mismatch = int(torch.sum(torch.any(nsteps != kernel_out["nsteps"], dim=1)))
    emit({"phase": "twin", "rtol": rtol, "nu": nu, "kappa": kappa, "batch": BATCH,
          "seconds": seconds, "kernel_seconds": kernel_out["seconds"],
          "rmse_over_rtol": rmse / rtol, "worst_lane_over_rtol": worst / rtol,
          "capped_lanes": capped, "lanes_with_other_step_counts": mismatch})
    if not ok:
        raise AssertionError(f"twin row failed its gates: rmse={rmse}, worst={worst}, capped={capped}")
    if mismatch > MAX_STEP_MISMATCH * BATCH:
        raise AssertionError(f"{mismatch} of {BATCH} lanes differ in step counts")

    # one interval, K1 against its plain version, timed with CUDA events
    state, _, inputs = batched.initial_state(
        vf, u0s, params, save_at=save_at, dt0=DT0, tols=tols, num_derivatives=nu
    )
    step = batched.make_step_ll(vf, params, nu=nu, d=3, error_calibration=kappa)
    t_next = torch.full((1, BATCH), float(save_at[1]), device=device)

    def run(fn):
        return lambda: fn(step, state, t_next, max_attempts=MAX_ATTEMPTS, **inputs)

    times = _time_pair((("plain", run(kernels.step_ll_interval_plain)),
                        ("kernel", run(kernels.step_ll_interval)),
                        ("kernel2", run(kernels.step_ll_interval)),
                        ("plain2", run(kernels.step_ll_interval_plain))))
    k_nsteps, p_nsteps = times["kernel"][1][15], times["plain"][1][15]
    interval = {"kernel_ms": [times["kernel"][0], times["kernel2"][0]],
                "plain_ms": [times["plain"][0], times["plain2"][0]],
                "lanes_with_other_step_counts": int(torch.sum(k_nsteps != p_nsteps))}
    emit({"phase": "interval", "kernel": "K1", "rtol": rtol, "nu": nu, "batch": BATCH,
          **interval})
    if interval["lanes_with_other_step_counts"]:
        raise AssertionError("K1 and its plain version differ in step counts over an interval")
    return min(interval["kernel_ms"]), min(interval["plain_ms"])


def _hi_solver(nu, kappa, engine):
    from odecheckpts_torch import batched_hi, problems

    vf, _, _, params = problems.rigid_body(time_span=TSPAN)
    return batched_hi.make_hi_solver(
        vf, params, save_at=_save_at(), dt0=DT0, vf_df=problems.rigid_body_df(params),
        num_derivatives=nu, error_calibration=kappa, engine=engine, max_attempts=MAX_ATTEMPTS,
    )


def _hi_rows():
    rows = [("parity", rtol) + SCHEDULES_HI["parity"][rtol] for rtol in RTOLS_HI]
    rows += [("tuned", rtol) + nk for rtol, nk in SCHEDULES_HI["tuned"].items()]
    return rows


def phase_main_hi(device, truth, u0s):
    import torch

    from odecheckpts_torch import batched_hi, problems

    vf, _, _, params = problems.rigid_body(time_span=TSPAN)
    for nu in (4, 5):  # the f64 Taylor init on its own
        secs, _ = _timed(lambda nu=nu: batched_hi._taylor_init_f64(vf, u0s, params, TSPAN[0], nu=nu))
        emit({"phase": "taylor_init_f64", "nu": nu, "batch": BATCH, "seconds": secs})
    failed, outs = [], {}
    for schedule, rtol, nu, kappa in _hi_rows():
        tols = torch.full((BATCH,), rtol, dtype=torch.float32, device=device)
        solver = _hi_solver(nu, kappa, "cuda-loop")
        row, out, check = _row("main_hi", schedule, rtol, nu, kappa,
                               lambda solver=solver, tols=tols: solver(u0s, tols), truth,
                               "step_hi_interval", combine=batched_hi.combine64)
        outs[(schedule, rtol)] = {"seconds": row["seconds"], "u_s": out[0], "nsteps": out[1]}
        if check[0]:
            failed.append(check[1:])
    if failed:
        raise AssertionError(f"df32 rows failed (gates, finite, launches, shapes): {failed}")
    return outs


def phase_twin_hi(device, truth, u0s, kernel_out):
    import torch

    from odecheckpts_torch import batched_hi, kernels, problems

    rtol = 1e-5
    nu, kappa = SCHEDULES_HI["parity"][rtol]
    tols = torch.full((BATCH,), rtol, dtype=torch.float32, device=device)
    solver = _hi_solver(nu, kappa, "torch")
    seconds, (us, _uf, nsteps) = _timed(lambda: solver(u0s, tols))
    ok, rmse, worst, capped = _gates(batched_hi.combine64(us), nsteps, truth, rtol)
    mismatch = int(torch.sum(torch.any(nsteps != kernel_out["nsteps"], dim=1)))
    emit({"phase": "twin_hi", "rtol": rtol, "nu": nu, "kappa": kappa, "batch": BATCH,
          "seconds": seconds, "kernel_seconds": kernel_out["seconds"],
          "rmse_over_rtol": rmse / rtol, "worst_lane_over_rtol": worst / rtol,
          "capped_lanes": capped, "lanes_with_other_step_counts": mismatch})
    if not ok:
        raise AssertionError(f"df32 twin row failed its gates: rmse={rmse}, worst={worst}, capped={capped}")
    if mismatch > MAX_STEP_MISMATCH * BATCH:
        raise AssertionError(f"{mismatch} of {BATCH} lanes differ in step counts")

    state, inputs, t_next = _hi_state(u0s, tols, nu, torch)
    step = batched_hi.make_step_hi(problems.rigid_body_df(), nu=nu, d=3, error_calibration=kappa)

    def run(fn):
        return lambda: fn(step, state, t_next, max_attempts=MAX_ATTEMPTS, **inputs)

    times = _time_pair((("plain", run(kernels.step_hi_interval_plain)),
                        ("kernel", run(kernels.step_hi_interval)),
                        ("kernel2", run(kernels.step_hi_interval)),
                        ("plain2", run(kernels.step_hi_interval_plain))))
    k_out, p_out = times["kernel"][1], times["plain"][1]
    interval = {"kernel_ms": [times["kernel"][0], times["kernel2"][0]],
                "plain_ms": [times["plain"][0], times["plain2"][0]],
                "lanes_with_other_step_counts": int(torch.sum(k_out[11] != p_out[11])),
                "max_abs_dev_mean_hi": float(torch.max(torch.abs(k_out[2] - p_out[2])))}
    emit({"phase": "interval", "kernel": "K2", "rtol": rtol, "nu": nu, "batch": BATCH,
          **interval})
    if interval["lanes_with_other_step_counts"]:
        raise AssertionError("K2 and its plain version differ in step counts over an interval")
    return min(interval["kernel_ms"]), min(interval["plain_ms"])


def phase_attempt_engines(device, truth, u0s, loop_ll, loop_hi):
    """K3 and K4 under their host loops against the loop engines' rows, then
    one launch of each against its plain version."""
    import torch

    from odecheckpts_torch import batched, batched_hi, kernels, problems

    vf, _, _, params = problems.rigid_body(time_span=TSPAN)
    save_at = _save_at()
    rtol_ll, rtol_hi = 1e-3, 1e-7
    nu_ll, kappa_ll = SCHEDULES["parity"][rtol_ll]
    nu_hi, kappa_hi = SCHEDULES_HI["parity"][rtol_hi]
    tols_ll = torch.full((BATCH,), rtol_ll, dtype=torch.float32, device=device)
    tols_hi = torch.full((BATCH,), rtol_hi, dtype=torch.float32, device=device)
    solver_hi = _hi_solver(nu_hi, kappa_hi, "cuda")
    solver_hi(u0s, tols_hi)  # the f64 Taylor init, outside the timed and counted run

    def run_ll():
        return _timed(lambda: batched.solve_save_at_batched(
            vf, u0s, params, save_at=save_at, dt0=DT0, tols=tols_ll, num_derivatives=nu_ll,
            error_calibration=kappa_ll, engine="cuda", max_attempts=MAX_ATTEMPTS,
        ))

    def run_hi():
        secs, (us, uf, n) = _timed(lambda: solver_hi(u0s, tols_hi))
        return secs, (batched_hi.combine64(us), batched_hi.combine64(uf), n)

    results, counts = {}, {}
    for name, run, rtol, loop in (("step_ll_attempt", run_ll, rtol_ll, loop_ll),
                                  ("step_hi_attempt", run_hi, rtol_hi, loop_hi)):
        (secs, (u_s, _u_f, nsteps)), counts[name] = _path([name], run)
        ok, rmse, worst, capped = _gates(u_s, nsteps, truth, rtol)
        other_steps = int(torch.sum(torch.any(nsteps != loop["nsteps"], dim=1)))
        same_out = bool(torch.equal(u_s, loop["u_s"]))
        emit({"phase": "attempt_engine", "kernel": KERNELS[name][0], "rtol": rtol,
              "batch": BATCH, "seconds": secs, "loop_engine_seconds": loop["seconds"],
              "launches": counts[name][name], "rmse_over_rtol": rmse / rtol,
              "worst_lane_over_rtol": worst / rtol, "capped_lanes": capped,
              "lanes_with_other_step_counts": other_steps, "outputs_equal_loop_engine": same_out})
        if not (ok and other_steps == 0 and same_out):
            raise AssertionError(f"{KERNELS[name][0]} engine: gates {ok}, {other_steps} lanes "
                                 f"with other step counts, outputs equal {same_out}")

    # one launch of each against its plain version, from the rows' initial states
    state, _, inputs = batched.initial_state(
        vf, u0s, params, save_at=save_at, dt0=DT0, tols=tols_ll, num_derivatives=nu_ll)
    step = batched.make_step_ll(vf, params, nu=nu_ll, d=3, error_calibration=kappa_ll)
    t_next = torch.full((1, BATCH), float(save_at[1]), device=device)
    state_hi, inputs_hi, _ = _hi_state(u0s, tols_hi, nu_hi, torch)
    step_hi = batched_hi.make_step_hi(problems.rigid_body_df(), nu=nu_hi, d=3,
                                      error_calibration=kappa_hi)
    one = {}
    for name, st, s, inp in (("step_ll_attempt", step, state, inputs),
                             ("step_hi_attempt", step_hi, state_hi, inputs_hi)):
        kernel, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
        times = _time_pair((
            ("plain", lambda: plain(st, s, t_next, **inp)),
            ("kernel", lambda: kernel(st, s, t_next, **inp)),
            ("kernel2", lambda: kernel(st, s, t_next, **inp)),
            ("plain2", lambda: plain(st, s, t_next, **inp)),
        ))
        dev = max(float(torch.max(torch.abs(a - b)))
                  for a, b in zip(times["kernel"][1], times["plain"][1]))
        one[name] = (min(times["kernel"][0], times["kernel2"][0]),
                     min(times["plain"][0], times["plain2"][0]))
        emit({"phase": "one_launch", "kernel": KERNELS[name][0], "batch": BATCH,
              "kernel_ms": [times["kernel"][0], times["kernel2"][0]],
              "plain_ms": [times["plain"][0], times["plain2"][0]], "max_abs_dev": dev})
    return counts, one


def phase_routed(device, truth, u0s):
    import torch

    from odecheckpts_torch import batched_hi, problems

    vf, _, _, params = problems.rigid_body(time_span=TSPAN)
    decades = np.array([10.0 ** -k for k in range(1, 10)], dtype=np.float32)
    rtols = np.resize(decades, BATCH)
    solve = batched_hi.make_routed_solver(
        vf, params, save_at=_save_at(), dt0=DT0, vf_df=problems.rigid_body_df(params),
        rtol_split=ROUTED_SPLIT, engine="cuda-loop", max_attempts=MAX_ATTEMPTS,
    )
    solve(u0s, rtols)  # warm-up (and the f64 Taylor init of the df32 lanes)
    (secs, (u64, nsteps)), counts = _path(
        ["step_ll_interval", "step_hi_interval"], lambda: _timed(lambda: solve(u0s, rtols)))
    err = _lane_errors(u64, truth)
    gate = ROUTED_FACTOR * np.maximum(rtols[:SAMPLE].astype(np.float64), ROUTED_FLOOR)
    over = [(float(r), float(e)) for r, e, g in zip(rtols[:SAMPLE], err, gate) if not e < g]
    worst_ratio = {f"{r:.0e}": float(np.max((err / gate)[rtols[:SAMPLE] == r])) for r in decades}
    emit({"phase": "routed", "batch": BATCH, "seconds": secs, "solves_per_sec": BATCH / secs,
          "mean_steps": float(nsteps[:, -1].double().mean()), "launches": counts,
          "worst_lane_error_over_gate_by_rtol": worst_ratio, "lanes_over_gate": len(over)})
    if over or not bool(torch.all(torch.isfinite(u64))):
        raise AssertionError(f"routed lanes over 10 max(rtol, 3e-7): {over[:10]}")


def main():
    device, _smi = phase_device()
    import torch

    phase_build()
    worst = phase_attempt(device)
    worst.update(phase_attempt_hi(device))

    save_at = _save_at()
    u0s = _ensemble(BATCH, torch, device)
    t0 = time.perf_counter()
    truth = _truth(u0s[:SAMPLE].double().cpu().numpy(), save_at.astype(np.float64))
    emit({"phase": "truth", "lanes": SAMPLE, "seconds": time.perf_counter() - t0})

    loop_ll, counts_ll = _path(["step_ll_interval"], lambda: phase_main(device, truth, u0s))
    timing = {"step_ll_interval": phase_twin(device, truth, u0s, loop_ll)}
    outs_hi, counts_hi = _path(["step_hi_interval"], lambda: phase_main_hi(device, truth, u0s))
    timing["step_hi_interval"] = phase_twin_hi(device, truth, u0s, outs_hi[("parity", 1e-5)])
    counts_attempt, one = phase_attempt_engines(device, truth, u0s, loop_ll,
                                                outs_hi[("parity", 1e-7)])
    timing.update(one)
    phase_routed(device, truth, u0s)

    launches = {"step_ll_interval": counts_ll["step_ll_interval"],
                "step_hi_interval": counts_hi["step_hi_interval"],
                "step_ll_attempt": counts_attempt["step_ll_attempt"]["step_ll_attempt"],
                "step_hi_attempt": counts_attempt["step_hi_attempt"]["step_hi_attempt"]}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": worst[name], "ms": timing[name][0],
         "plain_ms": timing[name][1]}
        for name, (_kid, source, replaces) in KERNELS.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
