"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
device, ``nvcc`` (CUDA_HOME or /usr/local/cuda) and scipy, and exits non-zero
if any phase fails.  Phases:

1. device: versions and the card's name and power limit; full-f32 matmuls.
2. build: compiles the K1 kernel (odecheckpts_torch/csrc/step_ll.cu) and
   reports its build time and ptxas registers and spills per nu.
3. one attempt, kernel against twin: from the Taylor-initialized and a
   mid-solve state of 4,096 lanes, for nu = 2, 3, 4, all 17 state arrays.
4. main path: ``batched.solve_save_at_batched(engine="cuda-loop")`` on the
   f32 work-precision workload (32,768 rigid-body IVPs over (0, 50),
   5 checkpoints, rtol 1e-1..1e-4, parity and tuned (nu, kappa) schedules),
   gated against LSODA(1e-12) truth on 256 lanes: RMSE < 3 rtol, worst lane
   < 6 rtol, no lane at the attempt cap; exactly 4 kernel launches per solve;
   the median of 3 timed solves after one warm-up.
5. twin on the card: the rtol 1e-3 parity row through ``engine="torch"``,
   the same gates, its time beside the kernel's, per-lane step-count
   agreement; one interval of K1 against its plain version, timed.
6. the kernel table line and the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

RTOLS = (1e-1, 1e-2, 1e-3, 1e-4)
# (nu, kappa) per rtol: the bench's parity and tuned schedules
SCHEDULES = {
    "parity": {1e-1: (4, 1.0), 1e-2: (4, 1.0), 1e-3: (4, 3.0), 1e-4: (4, 10.0)},
    "tuned": {1e-1: (2, 10.0), 1e-2: (2, 10.0), 1e-3: (3, 20.0), 1e-4: (4, 10.0)},
}
BATCH = 32_768
SAMPLE = 256
ATTEMPT_LANES = 4_096
ATTEMPT_RTOL = 1e-3
MID_ATTEMPTS = 50
ATTEMPT_RTOL_TOL = 1e-5
RMSE_FACTOR = 3.0
LANE_FACTOR = 6.0
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
    emit({"phase": "build", "seconds": lib.seconds, "ptxas_by_nu": ptxas})
    missing = [nu for nu in (2, 3, 4) if "registers" not in ptxas.get(nu, {})]
    if missing:
        raise RuntimeError(f"ptxas reported no kernel for nu={missing}:\n{lib.log}")
    return ptxas


def _ensemble(batch, torch, device):
    rng = np.random.default_rng(SEED)
    u0 = np.array([1.0, 0.0, 0.9])
    rows = (u0[None] * (1.0 + 0.05 * rng.standard_normal((batch, 3)))).astype(np.float32)
    return torch.tensor(rows, device=device)


def _save_at():
    return np.linspace(TSPAN[0], TSPAN[1], NUM_SAVE).astype(np.float32)


def phase_attempt(device):
    """One attempt of K1 (max_attempts=1) against one step of the twin."""
    import torch

    from odecheckpts_torch import batched, kernels, problems

    vf, _, _, params = problems.rigid_body(time_span=TSPAN)
    u0s = _ensemble(ATTEMPT_LANES, torch, device)
    tols = torch.full((ATTEMPT_LANES,), ATTEMPT_RTOL, dtype=torch.float32, device=device)
    save_at = _save_at()
    worst = 0.0
    for nu in (2, 3, 4):
        state, _, inputs = batched.initial_state(
            vf, u0s, params, save_at=save_at, dt0=DT0, tols=tols, num_derivatives=nu
        )
        step = batched.make_step_ll(vf, params, nu=nu, d=3, error_calibration=3.0)
        t_next = torch.full((1, ATTEMPT_LANES), float(save_at[1]), device=device)
        args = (t_next, inputs["atol"], inputs["rtol"], inputs["dt_max"],
                inputs["dt_floor"], inputs["tiny_scale"])
        mid = state
        for _ in range(MID_ATTEMPTS):
            mid = step(mid, *args)
        for label, start in (("init", state), ("mid", mid)):
            got = kernels.step_ll_interval(step, start, t_next, max_attempts=1, **inputs)
            want = step(start, *args)
            torch.cuda.synchronize()
            devs, bad = {}, []
            for name, g, w in zip(STATE_NAMES, got, want):
                err = torch.abs(g - w)
                scale = torch.clamp(torch.abs(w), min=float(torch.amax(torch.abs(w))) * 1e-3)
                rel = float(torch.amax(err / torch.clamp(scale, min=1e-30)))
                devs[name] = [float(torch.amax(err)), rel]
                worst = max(worst, float(torch.amax(err)))
                if not bool(torch.all(torch.isfinite(g) == torch.isfinite(w))) or rel > ATTEMPT_RTOL_TOL:
                    bad.append(name)
            emit({"phase": "attempt", "nu": nu, "state": label,
                  "max_abs_and_rel_dev": devs})
            if bad:
                raise AssertionError(
                    f"K1 and its twin disagree beyond rel {ATTEMPT_RTOL_TOL} at nu={nu} "
                    f"({label}) in {bad}"
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


def _gates(u_s, nsteps, truth, rtol):
    from odecheckpts_torch import harness

    u = u_s[:SAMPLE].double().cpu().numpy()
    err = u - truth
    rmse = float(harness.rmse_absolute(truth)(u))
    worst = float(np.max(np.sqrt(np.mean(err * err, axis=(1, 2)))))
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


def phase_main(device, truth, u0s):
    import torch

    from odecheckpts_torch import batched, kernels, problems

    vf, _, _, params = problems.rigid_body(time_span=TSPAN)
    save_at = _save_at()
    rows, failed, kernel_out = [], [], {}
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

            solve()  # warm-up
            times, launches = [], set()
            for _ in range(REPEATS):
                before = kernels.LAUNCHES["step_ll_interval"]
                secs, (u_s, u_f, nsteps) = _timed(solve)
                launches.add(kernels.LAUNCHES["step_ll_interval"] - before)
                times.append(secs)
            seconds = float(np.median(times))
            launches = launches.pop() if len(launches) == 1 else sorted(launches)
            finite = bool(torch.all(torch.isfinite(u_s))) and bool(torch.all(torch.isfinite(u_f)))
            shapes = (tuple(u_s.shape), tuple(u_f.shape), tuple(nsteps.shape))
            ok, rmse, worst, capped = _gates(u_s, nsteps, truth, rtol)
            row = {
                "phase": "main", "schedule": schedule, "rtol": rtol, "nu": nu,
                "kappa": kappa, "batch": BATCH, "seconds": seconds, "seconds_all": times,
                "solves_per_sec": BATCH / seconds,
                "mean_steps": float(nsteps[:, -1].double().mean()),
                "rmse_over_rtol": rmse / rtol, "worst_lane_over_rtol": worst / rtol,
                "capped_lanes": capped, "launches": launches,
            }
            emit(row)
            rows.append(row)
            if schedule == "parity" and rtol == 1e-3:
                kernel_out = {"seconds": seconds, "nsteps": nsteps}
            want_shapes = ((BATCH, NUM_SAVE, 3), (BATCH, NUM_SAVE, 3), (BATCH, NUM_SAVE))
            if not (ok and finite and launches == NUM_SAVE - 1 and shapes == want_shapes):
                failed.append((schedule, rtol, ok, finite, launches, shapes))
    if failed:
        raise AssertionError(f"main-path rows failed (gates, finite, launches, shapes): {failed}")
    return rows, kernel_out


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
    times = {}
    for name, fn in (("plain", kernels.step_ll_interval_plain), ("kernel", kernels.step_ll_interval),
                     ("kernel2", kernels.step_ll_interval), ("plain2", kernels.step_ll_interval_plain)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn(step, state, t_next, max_attempts=MAX_ATTEMPTS, **inputs)
        end.record()
        torch.cuda.synchronize()
        times[name] = (start.elapsed_time(end), out)
    k_nsteps, p_nsteps = times["kernel"][1][15], times["plain"][1][15]
    interval = {"kernel_ms": [times["kernel"][0], times["kernel2"][0]],
                "plain_ms": [times["plain"][0], times["plain2"][0]],
                "lanes_with_other_step_counts": int(torch.sum(k_nsteps != p_nsteps))}
    emit({"phase": "interval", "rtol": rtol, "nu": nu, "batch": BATCH, **interval})
    return min(interval["kernel_ms"]), min(interval["plain_ms"])


def main():
    device, _smi = phase_device()
    import torch

    from odecheckpts_torch import kernels

    phase_build()
    max_abs_err = phase_attempt(device)

    save_at = _save_at()
    u0s = _ensemble(BATCH, torch, device)
    t0 = time.perf_counter()
    truth = _truth(u0s[:SAMPLE].double().cpu().numpy(), save_at.astype(np.float64))
    emit({"phase": "truth", "lanes": SAMPLE, "seconds": time.perf_counter() - t0})

    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    _rows, kernel_out = phase_main(device, truth, u0s)
    launches = kernels.LAUNCHES["step_ll_interval"]
    if launches == 0:
        raise AssertionError("the main path launched K1 no time")

    ms, plain_ms = phase_twin(device, truth, u0s, kernel_out)
    emit({"kernels": [{
        "name": "step_ll_interval", "route": "cuda",
        "source": "odecheckpts_torch/csrc/step_ll.cu",
        "replaces": "odecheckpts_tpu/batched.py:544",
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
