"""Stiff Brusselator PDE ensembles on the port's fused df32 engine: the
PyTorch runner of ``batched_tpu.py``'s workload.

A batch of perturbed initial profiles of ``problems.brusselator(N)`` (method
of lines, d = 2N components, the slice-form Laplacian) runs through
``odecheckpts_torch.batched_hi.make_hi_solver`` (isotropic TS0(4),
fixedpoint, 5 checkpoints over (0, 10), dt0 1e-5, ``vf_df=None``: the vector
field on the hi word of each pair).  On the card ``engine="cuda-loop"``
launches the wide form of K2 (one block per IVP, one thread per component,
``odecheckpts_torch/csrc/step_hi_wide.cu``) once per checkpoint interval,
``engine="cuda"`` the wide form of K4 once per attempt; ``engine="torch"``
runs the twin (any device).

The ensemble differs from the TPU runner's: its noise, 0.01 N(0, 1)
relative, comes from ``numpy.random.default_rng(0)`` (JAX's PRNG is not
available to the port), and the perturbed rows are rounded to float32
once, the rows that both the solver and the LSODA truth start from.  The
gate is the TPU runner's: RMSE against LSODA(1e-10) on ``--sample`` lanes
< 1e3 tol, every lane finite.

Usage (from the repository root):

    python experiments/4_brusselator/batched_torch.py --N 32 --batch 256 \\
        --tol 1e-7 --engine cuda-loop --sample 2
    python experiments/4_brusselator/batched_torch.py --N 4 --batch 4 \\
        --tol 1e-4 --engine torch --device cpu

On the card it adds its row to ``data_batched_torch.json`` beside this
script, with the card's name and power limit; a CPU run only prints its row.
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

NUM_SAVE = 5
DT0 = 1e-5
NOISE = 0.01
SEED = 0
GATE = 1e3  # rmse < GATE tol: batched_tpu.py's accuracy gate
MAX_ATTEMPTS = 100_000
OUT = pathlib.Path(__file__).resolve().parent / "data_batched_torch.json"


def _truth_rows(rows, N, save_at):
    """Per-lane scipy LSODA reference at the checkpoints (numpy vf)."""
    import scipy.integrate

    alpha = 1.0 / 50.0
    c = alpha * (N + 1) ** 2

    def vf_np(_t, y):
        u, v = y[:N], y[N:]
        u_ = np.concatenate([[1.0], u, [1.0]])
        v_ = np.concatenate([[3.0], v, [3.0]])
        cu = u_[:-2] - 2.0 * u_[1:-1] + u_[2:]
        cv = v_[:-2] - 2.0 * v_[1:-1] + v_[2:]
        return np.concatenate(
            [1.0 + u**2 * v - 4.0 * u + c * cu, 3.0 * u - u**2 * v + c * cv]
        )

    outs = []
    for row in rows:
        sol = scipy.integrate.solve_ivp(
            vf_np, (float(save_at[0]), float(save_at[-1])), row,
            t_eval=save_at, rtol=1e-10, atol=1e-10, method="LSODA",
        )
        outs.append(sol.y.T)
    return np.stack(outs)


def workload(N, batch, seed=SEED):
    """``(vf, save_at, y0s)``: the vector field, the 5 checkpoints (exact in
    float32) and the (batch, 2N) float32 initial rows."""
    from odecheckpts_torch import problems

    vf, (y0,), tspan, _ = problems.brusselator(N)
    save_at = np.linspace(tspan[0], tspan[1], num=NUM_SAVE)
    noise = NOISE * np.random.default_rng(seed).standard_normal((batch, 2 * N))
    y0s = (y0.numpy()[None] * (1.0 + noise)).astype(np.float32)
    return vf, save_at, y0s


def make_solver(N, engine, **kwargs):
    """The runner's solver: ``make_hi_solver`` on ``problems.brusselator(N)``
    with the workload's checkpoints and dt0 (``kwargs`` go to it)."""
    from odecheckpts_torch import batched_hi

    vf, save_at, _ = workload(N, 0)
    return batched_hi.make_hi_solver(vf, (), save_at=save_at, dt0=DT0, engine=engine,
                                     max_attempts=MAX_ATTEMPTS, **kwargs)


def run_row(N=32, batch=256, tol=1e-7, engine="cuda-loop", device="cuda", sample=2):
    """One configuration: a warm-up solve (the f64 Taylor init, memoized,
    and the kernels' build), one timed solve, the gate against LSODA on the
    first ``sample`` lanes.  Returns the row: the TPU runner's keys, and
    ``finite``, ``capped_lanes`` (lanes whose accepted steps in an interval
    reached the attempt cap), ``launches`` (each kernel's launches in the
    timed solve), ``gate_ok`` and ``device``."""
    import torch

    from odecheckpts_torch import batched_hi, harness, kernels

    _, save_at, y0s_np = workload(N, batch)
    y0s = torch.tensor(y0s_np, device=device)
    tols = torch.full((batch,), tol, dtype=torch.float32, device=device)
    solve = make_solver(N, engine)
    harness.device_sync(solve(y0s, tols))  # warm-up
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    us, _uf, n = harness.device_sync(solve(y0s, tols))
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    u64 = batched_hi.combine64(us).cpu().numpy()
    n = n.cpu().numpy().astype(np.int64)
    truth = _truth_rows(y0s_np[:sample].astype(np.float64), N, save_at)
    rmse = float(np.sqrt(np.mean((u64[:sample] - truth) ** 2)))
    finite = bool(np.all(np.isfinite(u64)))
    capped = int(np.sum(np.any(np.diff(n, axis=1) >= MAX_ATTEMPTS, axis=1)))
    return {
        "N": N, "state_dim": 2 * N, "tol": tol, "engine": engine, "batch": batch,
        "seconds": seconds, "solves_per_sec": batch / seconds, "rmse_vs_lsoda": rmse,
        "mean_steps": float(np.mean(n[:, -1])), "max_steps": int(np.max(n)),
        "finite": finite, "capped_lanes": capped, "launches": launches,
        "gate_ok": finite and rmse < GATE * tol, "device": str(torch.device(device)),
    }


def _card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--engine", default="cuda-loop", choices=["cuda-loop", "cuda", "torch"])
    ap.add_argument("--sample", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    row = run_row(args.N, args.batch, args.tol, args.engine, args.device, args.sample)
    assert row["finite"], "non-finite lanes"
    assert row["gate_ok"], f"accuracy gate failed: rmse={row['rmse_vs_lsoda']:.2e}"
    if row["device"].startswith("cuda"):
        row["card"] = _card()
    print(json.dumps(row), flush=True)
    if not row["device"].startswith("cuda"):
        return
    # one row per (N, tol, engine, batch) configuration
    try:
        with open(OUT) as f:
            rows = json.load(f).get("rows", [])
    except (OSError, ValueError):
        rows = []
    keyf = lambda r: (r["N"], r["tol"], r["engine"], r["batch"])  # noqa: E731
    rows = [r for r in rows if keyf(r) != keyf(row)] + [row]
    rows.sort(key=keyf)
    with open(OUT, "w") as f:
        json.dump({"rows": rows}, f, indent=1)
    print(f"wrote {os.path.relpath(OUT)}")


if __name__ == "__main__":
    main()
