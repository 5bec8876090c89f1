"""Measure designs of K1, K3, K7 and K8 against each other on one NVIDIA GPU.

Run from the repository root on a machine with one CUDA device and nvcc:

    python3 k1_trial.py first=<dir> A=<dir> B=<dir> --order first,A,B,first

Each ``name=<dir>`` is a checkout of the repository (``git archive`` of a
commit, unpacked) whose ``odecheckpts_torch`` holds one design of the
kernels; ``.`` is this checkout.  The turns run in the given
order, each in a process of its own that builds its checkout's kernel
library (``odecheckpts_torch/_build/`` inside it) and times, on the bench's
ensemble (32,768 rigid-body lanes, u0 (1 + 0.05 N(0, 1)) from numpy seed 0,
tspan (0, 50), 5 checkpoints, dt0 0.1, atol 1e-3 rtol), from the Taylor
init to the first checkpoint:

* one K1 interval of each row in ``ROWS`` (the tuned rows nu = 2, 3, 4 and
  the parity row of the kernel table, rtol 1e-3, nu = 4);
* one K3 launch of the parity row (rtol 1e-3, nu = 4);
* one K7 launch (nu = 4, smoother and filter) on the save-every-step row's
  ensemble (``chip_smoke.phase_main_everystep``: the same 32,768 lanes,
  tspan (0, 10), dt0 0.1, tol 1e-4), from the initial state and from the
  state after ``K7_MID`` launches of the checkout's own K7;
* one K8 launch on the element pairs of the last level of the fixed-grid
  row's second window (m = 4, c = 3, 1,024 pairs,
  ``chip_smoke._capture_second_window``), float32 and float64.

Times are device-only, taken by ``chip_smoke._device_time`` (a long
``torch.cuda._sleep`` holds the stream while the host enqueues the
launches, so the events see them back to back; the host clock around the
enqueue gives the wrapper's own ``host_ms``) on ``chip_smoke._ensemble``.
Each turn prints one JSON line with its times, the ptxas counts and, where
the checkout has them, the geometry entries of K1 and K3, and a digest of
every output; the last line says whether all designs gave the same outputs
bit for bit (they must) and the median device time of each design and row.
``--only k7,k8`` times only the named groups (k1, k3, k7, k8).
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROWS = {  # name -> (rtol, nu, kappa)
    "tuned_nu2": (1e-1, 2, 10.0),
    "tuned_nu3": (1e-3, 3, 20.0),
    "tuned_nu4": (1e-4, 4, 10.0),
    "parity_nu4": (1e-3, 4, 3.0),
}
K3_ROW = "parity_nu4"
K7_MID = 50
GROUPS = ("k1", "k3", "k7", "k8")
HERE = Path(__file__).resolve().parent


def _digest(torch, outs):
    h = hashlib.sha256()
    for x in outs:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(tree, name, turn, groups=GROUPS):
    """One turn: build the checkout's kernels, time them, print one line."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from odecheckpts_torch import batched, kernels, problems

    sys.path.insert(1, str(HERE))
    import chip_smoke as cs

    device = torch.device("cuda", 0)
    lib = kernels.library()
    ptxas = kernels.parse_ptxas(lib.log)
    vf, _, _, params = problems.rigid_body(time_span=cs.TSPAN)
    u0s = cs._ensemble(cs.BATCH, torch, device)
    save_at = cs._save_at()
    t_next = torch.full((1, cs.BATCH), float(save_at[1]), device=device)
    out = {"tree": name, "turn": turn, "build_seconds": lib.seconds,
           "device": torch.cuda.get_device_name(0), "interval": {}, "digests": {},
           "device_ms": {},
           "ptxas": {k: ptxas.get(k) for k in ("step_ll_interval", "step_ll_attempt",
                                               "step_everystep_attempt", "pit_combine")}}
    for row, (rtol, nu, kappa) in ROWS.items():
        if "k1" not in groups and not ("k3" in groups and row == K3_ROW):
            continue
        tols = torch.full((cs.BATCH,), rtol, dtype=torch.float32, device=device)
        state, _, inputs = batched.initial_state(vf, u0s, params, save_at=save_at, dt0=0.1,
                                                 tols=tols, num_derivatives=nu)
        step = batched.make_step_ll(vf, params, nu=nu, d=3, error_calibration=kappa)

        def interval(step=step, state=state, inputs=inputs):
            return kernels.step_ll_interval(step, state, t_next, max_attempts=cs.MAX_ATTEMPTS,
                                            **inputs)

        if "k1" in groups:
            got = interval()
            out["interval"][row] = {"rtol": rtol, "nu": nu, "kappa": kappa,
                                    **cs._device_time("step_ll", interval),
                                    "accepted": float(torch.sum(got[15] - state[15]))}
            out["digests"][f"K1/{row}"] = _digest(torch, got)
            out["device_ms"][f"K1/{row}"] = out["interval"][row]["device_ms"]
        if row == K3_ROW and "k3" in groups:
            def attempt(step=step, state=state, inputs=inputs):
                return kernels.step_ll_attempt(step, state, t_next, **inputs)

            out["k3"] = {"row": row, **cs._device_time("step_ll", attempt)}
            out["digests"][f"K3/{row}"] = _digest(torch, attempt())
            out["device_ms"][f"K3/{row}"] = out["k3"]["device_ms"]
    if "k7" in groups:
        out["k7"] = _measure_k7(torch, batched, kernels, problems, cs, device, out)
    if "k8" in groups:
        out["k8"] = _measure_k8(torch, kernels, cs, device, out)
    if hasattr(kernels, "step_ll_geometry"):
        out["geometry"] = {k: kernels.step_ll_geometry(k, 4)
                           for k in ("step_ll_interval", "step_ll_attempt")}
        out["geometry"].update({f"step_everystep_attempt/{s}": kernels.step_everystep_geometry(4, s)
                                for s in ("smoother", "filter")})
    if hasattr(kernels, "step_pit_combine_geometry"):
        out["geometry"].update({f"pit_combine/{t}": kernels.step_pit_combine_geometry(4, 3, dt)
                                for t, dt in (("f32", torch.float32), ("f64", torch.float64))})
    print(json.dumps(out), flush=True)


def _measure_k7(torch, batched, kernels, problems, cs, device, out):
    """K7 at nu = 4 on the save-every-step row's lanes, both strategies,
    from the initial state and after K7_MID launches."""
    vf, _, _, params = problems.rigid_body(time_span=cs.ES_TSPAN)
    u0s = cs._ensemble(cs.BATCH, torch, device)
    tols = torch.full((cs.BATCH,), cs.ES_TOL, dtype=torch.float32, device=device)
    t1 = torch.full((1, cs.BATCH), cs.ES_TSPAN[1], device=device)
    rows = {}
    for strategy in ("smoother", "filter"):
        state, _, inputs = batched.initial_state(
            vf, u0s, params, save_at=np.array(cs.ES_TSPAN, np.float32), dt0=cs.DT0, tols=tols,
            strategy=strategy)
        step = batched.make_step_ll(vf, params, nu=4, d=3, strategy=strategy)
        state = tuple(x.contiguous() for x in state)
        mid = state
        for _ in range(K7_MID):
            mid = kernels.step_everystep_attempt(step, mid, t1, **inputs)
        for label, start in (("init", state), ("mid", mid)):
            def launch(step=step, start=start, inputs=inputs):
                return kernels.step_everystep_attempt(step, start, t1, **inputs)

            row = f"K7/{strategy}/{label}"
            got = launch()
            rows[row] = {**cs._device_time("step_everystep_attempt", launch),
                         "accepted": int(torch.sum(got[15] != start[15]))}
            out["digests"][row] = _digest(torch, got)
            out["device_ms"][row] = rows[row]["device_ms"]
    return rows


def _measure_k8(torch, kernels, cs, device, out):
    """K8 on the last level of the fixed-grid row's second window, float32
    and float64."""
    captured = {**cs._capture_second_window(device, torch.float32),
                **cs._capture_second_window(device, torch.float64, "f64/")}
    rows = {}
    for key, label in (("last_level", "f32"), ("f64/last_level", "f64")):
        e_i, e_j = captured[key]

        def launch(e_i=e_i, e_j=e_j):
            return kernels.pit_combine(e_i, e_j)

        row = f"K8/{label}"
        rows[row] = cs._device_time("pit_combine", launch)
        out["digests"][row] = _digest(torch, launch())
        out["device_ms"][row] = rows[row]["device_ms"]
    return rows


def main(argv):
    if argv[:1] == ["--measure"]:
        measure(argv[1], argv[2], int(argv[3]), tuple(argv[4].split(",")))
        return
    trees = dict(a.split("=", 1) for a in argv if "=" in a and not a.startswith("--"))
    order = argv[argv.index("--order") + 1].split(",") if "--order" in argv else list(trees)
    groups = argv[argv.index("--only") + 1] if "--only" in argv else ",".join(GROUPS)
    results = []
    for turn, name in enumerate(order):
        proc = subprocess.run([sys.executable, __file__, "--measure", trees[name], name, str(turn),
                               groups], capture_output=True, text=True, check=False)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"turn {turn} ({name}) failed with code {proc.returncode}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    same = all(r["digests"] == results[0]["digests"] for r in results)
    medians = {}
    for name in dict.fromkeys(order):
        mine = [r for r in results if r["tree"] == name]
        medians[name] = {row: float(np.median([r["device_ms"][row] for r in mine]))
                         for row in mine[0]["device_ms"]}
    print(json.dumps({"outputs_equal_across_designs": same, "median_device_ms": medians}),
          flush=True)
    if not same:
        raise SystemExit("the designs' outputs differ")


if __name__ == "__main__":
    main(sys.argv[1:])
