"""Prior-order sweep on the port's fused engines: the PyTorch runner of
``order_sweep.py``'s workload.

The bench workload (``problems.rigid_body`` over (0, 50), 5 checkpoints,
dt0 0.1, the default error calibration, atol 1e-3 rtol) runs at every order
``nu`` and tolerance of two bands: the f32 band (``--orders-f32`` x
``--rtols-f32``) through ``odecheckpts_torch.batched.solve_save_at_batched``
and the df32 band (``--orders`` x ``--rtols``) through
``odecheckpts_torch.batched_hi.make_hi_solver`` with the rigid body's pair
vector field.  On the card ``--engine cuda-loop`` launches K1 / K2 once per
checkpoint interval (``odecheckpts_torch/csrc/step_ll.cu``,
``step_hi.cu``), ``--engine cuda`` K3 / K4 once per attempt;
``--engine torch`` runs the twins (any device).

On the card each row is a warm-up solve (the kernels' build, the df32
solver's f64 Taylor init, which it memoizes, so the timed df32 solve runs
without it, as in the TPU runner) and one timed solve; on the CPU, where
nothing is built and a df32 solve of the twin takes about a minute, only
the timed solve runs (its seconds hold the df32 init).  Each is gated
against per-lane scipy LSODA(1e-12) truth on the first
``--sample`` lanes: RMSE < 3 rtol, worst lane < 6 rtol (``order_sweep.py``'s
gates), every value finite and no lane at the attempt cap.

The ensemble differs from the TPU runner's: its noise, 0.05 N(0, 1)
relative, comes from ``numpy.random.default_rng(0)`` (JAX's PRNG is not
available to the port), and the perturbed rows are rounded to float32 once,
the rows that both the solver and the LSODA truth start from.  They are the
lanes of ``chip_smoke.py``'s bench rows.

Usage (from the repository root):

    python experiments/6_tpu_batched_sweep/order_sweep_torch.py
    python experiments/6_tpu_batched_sweep/order_sweep_torch.py --device cpu \\
        --engine torch --batch 16 --sample 8 --orders 6 --rtols 1e-6 \\
        --orders-f32 2 --rtols-f32 1e-1

Rows have ``order_sweep.py``'s keys and ``device`` (the card's name and
power limit as ``nvidia-smi`` gives them, or the device's name), ``finite``,
``capped_lanes`` and ``launches`` (each kernel's launches in the timed
solve).  A card run merges its rows into ``data_order_sweep_torch.json``
beside this script; a CPU run only prints them.  With ``--device cuda`` and
no card it raises: it never runs on the CPU instead.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TSPAN = (0.0, 50.0)
NUM_SAVE = 5
DT0 = 0.1
NOISE = 0.05
SEED = 0
RMSE_BOUND_FACTOR = 3.0
LANE_BOUND_FACTOR = 6.0
MAX_ATTEMPTS = 100_000
OUT = pathlib.Path(__file__).resolve().parent / "data_order_sweep_torch.json"


def workload(batch, seed=SEED):
    """``(vf, params, save_at, u0_rows)``: the rigid body, its 5 checkpoints
    (float32, exact) and the (batch, 3) float32 initial rows."""
    from odecheckpts_torch import problems

    vf, (u0,), tspan, params = problems.rigid_body(time_span=TSPAN)
    save_at = np.linspace(tspan[0], tspan[1], num=NUM_SAVE).astype(np.float32)
    noise = NOISE * np.random.default_rng(seed).standard_normal((batch, 3))
    u0_rows = (u0.numpy()[None] * (1.0 + noise)).astype(np.float32)
    return vf, params, save_at, u0_rows


def truth_rows(u0_rows, save_at):
    """Per-lane scipy LSODA(rtol = atol = 1e-12) at the checkpoints."""
    import scipy.integrate

    p1, p2, p3 = -2.0, 1.25, -0.5

    def vf_np(_t, y):
        return [p1 * y[1] * y[2], p2 * y[0] * y[2], p3 * y[0] * y[1]]

    return np.stack([
        scipy.integrate.solve_ivp(
            vf_np, (float(save_at[0]), float(save_at[-1])), row, t_eval=save_at,
            rtol=1e-12, atol=1e-12, method="LSODA",
        ).y.T
        for row in np.asarray(u0_rows, np.float64)
    ])


def make_solve(band, nu, engine):
    """``solve(u0s, tols) -> (u_s, nsteps)`` of one band on the workload:
    "float32" on ``batched.solve_save_at_batched``, "df32" on
    ``make_hi_solver`` (its smoothed pairs combined in float64)."""
    from odecheckpts_torch import batched, batched_hi, problems

    vf, params, save_at, _ = workload(0)

    if band == "float32":
        def solve(u0s, tols):
            u_s, _u_f, n = batched.solve_save_at_batched(
                vf, u0s, params, save_at=save_at, dt0=DT0, tols=tols, num_derivatives=nu,
                engine=engine, max_attempts=MAX_ATTEMPTS)
            return u_s, n

        return solve
    solve_hi = batched_hi.make_hi_solver(
        vf, params, save_at=save_at, dt0=DT0, vf_df=problems.rigid_body_df(params),
        num_derivatives=nu, engine=engine, max_attempts=MAX_ATTEMPTS)

    def solve(u0s, tols):
        us, _uf, n = solve_hi(u0s, tols)
        return batched_hi.combine64(us), n

    return solve


def run_row(band, nu, rtol, *, u0s, truth, engine, solve):
    """One row of ``solve`` (``make_solve``'s for band, nu and engine; a
    df32 solver shares its memoized init across tolerances): a warm-up solve
    on the card, one timed solve, the gates against ``truth`` (the first
    ``len(truth)`` lanes).  ``u0s`` is the (B, 3) float32 ensemble on the
    solve's device.  Returns the row and the solve's outputs."""
    import torch

    from odecheckpts_torch import harness, kernels

    batch = u0s.shape[0]
    tols = torch.full((batch,), rtol, dtype=torch.float32, device=u0s.device)
    if u0s.device.type == "cuda":  # warm-up: the build, the f64 Taylor init
        harness.device_sync(solve(u0s, tols))
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    u_s, nsteps = harness.device_sync(solve(u0s, tols))
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    u = u_s.double().cpu().numpy()
    n = nsteps.cpu().numpy().astype(np.int64)
    err = u[: len(truth)] - truth
    rmse = float(np.sqrt(np.mean(err * err)))
    rmse_lane = np.sqrt(np.mean(err * err, axis=(1, 2)))
    finite = bool(np.all(np.isfinite(u)))
    capped = int(np.sum(np.any(np.diff(n, axis=1) >= MAX_ATTEMPTS, axis=1)))
    row = {
        "nu": nu, "rtol": rtol, "dtype": band, "engine": engine, "batch": batch,
        "seconds": seconds, "solves_per_sec": batch / seconds, "rmse": rmse,
        "rmse_max_lane": float(np.max(rmse_lane)), "mean_steps": float(np.mean(n[:, -1])),
        "gate_ok": bool(finite and np.isfinite(rmse) and rmse < RMSE_BOUND_FACTOR * rtol
                        and np.max(rmse_lane) < LANE_BOUND_FACTOR * rtol and capped == 0),
        "finite": finite, "capped_lanes": capped, "launches": launches,
        "device": card() if u0s.device.type == "cuda" else str(u0s.device),
    }
    return row, (u_s, nsteps)


def sweep(*, batch, sample, orders, rtols, orders_f32, rtols_f32, engine, device):
    """Every row of both bands, in ``order_sweep.py``'s order (the f32 band,
    then the df32 band), each printed as a JSON line as it finishes.
    Returns the rows."""
    import torch

    _, _, save_at, u0_rows = workload(batch)
    truth = truth_rows(u0_rows[:sample], save_at.astype(np.float64))
    u0s = torch.tensor(u0_rows, device=device)
    rows = []
    for band, band_orders, band_rtols in (("float32", orders_f32, rtols_f32),
                                          ("df32", orders, rtols)):
        for nu in band_orders:
            solve = make_solve(band, nu, engine)
            for rtol in band_rtols:
                row, _ = run_row(band, nu, rtol, u0s=u0s, truth=truth, engine=engine,
                                 solve=solve)
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--sample", type=int, default=256)
    ap.add_argument("--orders", type=int, nargs="*", default=[4, 5, 6],
                    help="df32-band orders")
    ap.add_argument("--rtols", type=float, nargs="*", default=[1e-6, 1e-7, 1e-8, 1e-9])
    ap.add_argument("--orders-f32", type=int, nargs="*", default=[2, 3, 4],
                    help="f32-band orders")
    ap.add_argument("--rtols-f32", type=float, nargs="*", default=[1e-1, 1e-2, 1e-3, 1e-4])
    ap.add_argument("--engine", default="cuda-loop", choices=["cuda-loop", "cuda", "torch"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("order_sweep_torch: --device cuda, but torch.cuda.is_available() "
                           "is false; pass --device cpu to run the twins on the CPU")
    rows = sweep(batch=args.batch, sample=args.sample, orders=args.orders, rtols=args.rtols,
                 orders_f32=args.orders_f32, rtols_f32=args.rtols_f32, engine=args.engine,
                 device=device)
    failed = [(r["dtype"], r["nu"], r["rtol"]) for r in rows if not r["gate_ok"]]
    if device.type == "cuda":
        # one row per (dtype, nu, rtol, engine, batch) configuration
        try:
            old = json.loads(OUT.read_text()).get("results", [])
        except (OSError, ValueError):
            old = []
        keyf = lambda r: (r["dtype"], r["nu"], r["rtol"], r["engine"], r["batch"])  # noqa: E731
        new = {keyf(r) for r in rows}
        merged = sorted([r for r in old if keyf(r) not in new] + rows,
                        key=lambda r: (r["dtype"] != "float32", r["nu"], -r["rtol"],
                                       r["engine"], r["batch"]))
        OUT.write_text(json.dumps({"platform": "gpu", "device": card(),
                                   "torch": torch.__version__, "results": merged}, indent=1))
        print(f"wrote {os.path.relpath(OUT)}", flush=True)
    if failed:
        raise SystemExit(f"rows failed their gates: {failed}")
    return rows


if __name__ == "__main__":
    main()
