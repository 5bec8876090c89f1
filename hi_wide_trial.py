"""Measure designs of K2 wide and K4 wide against each other on one NVIDIA
GPU, and split one attempt's time between its parts.

Run from the repository root on a machine with one CUDA device and nvcc:

    python3 hi_wide_trial.py first=<dir> A=. --order first,A,A,first [--split]

Each ``name=<dir>`` is a checkout of the repository (``git archive`` of a
commit, unpacked into a gitignored directory such as ``_scratch/``) whose
``odecheckpts_torch`` holds one design of the wide df32 body
(``csrc/step_hi_wide.cuh``); ``.`` is this checkout.  The turns run in the
given order, each in a process of its own that builds its checkout's kernel
library and measures, on experiment 4's batched ensembles
(``experiments/4_brusselator/batched_torch.py``: ``problems.brusselator(N)``,
256 lanes, u0 (1 + 0.01 N(0, 1)) from numpy seed 0, TS0(4), 5 checkpoints
on (0, 10), dt0 1e-5):

* the device time of one K2 wide launch of 40 attempts a lane and of one K4
  wide attempt from the Taylor init toward the first checkpoint, at (N,
  tol) = (32, 1e-7) and (64, 1e-7) (d = 64, 128), by
  ``chip_smoke._device_time``; no lane reaches the checkpoint in 40
  attempts, so a K2 wide launch over 40 is the time of one attempt;
* the three rows of ``chip_smoke.WIDE_ROWS`` through the runner's solver
  (``engine="cuda-loop"``): one warm-up solve, then the host clock around
  one solve ending in ``torch.cuda.synchronize``; mean accepted steps.

Each turn prints one JSON line (times, ptxas counts of the wide kernels,
the card's name and power limit, a digest of every output); the last line
says whether all designs gave the same outputs bit for bit (they must) and
the median of each design's times.

``--split`` first measures, for each design, where one attempt's time goes:
a copy of the checkout (``_scratch/split_<name>/``) whose body gets
``clock64()`` stamps taken by the block's thread 0 (and by the controller's
thread where it is another) at the attempt's start, before and after its
first two barriers, after the error sums, after the decisions, after the
(n, n) work, after the third barrier and after the column update; a K2 wide
launch of 40 attempts on the (32, 1e-7) row's 256 lanes adds each block's
spans into device counters, apart for attempts that ran the covariance
update and the rest.  Printed: cycles an attempt in each span and the SM
clock (``nvidia-smi``); in a body with warp 0's covariance work
(``cov_warp``) also that work's parts.  The stamps are added to the copy
only; the checkouts' sources are measured as they are.  ``--split-only``
measures the split and no turns.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BATCH = 256
CAP = 40
LAUNCH_ROWS = ((32, 1e-7), (64, 1e-7))
SPANS = ("phase1", "barrier1", "phase2", "barrier2", "sums", "control", "nn", "barrier3",
         "phase4")

# --split: the stamps.  Slot k of a block's row holds the clock at stamp k of
# the current attempt (0 where the attempt took no such stamp); span k is
# slot k + 1 minus slot k, a missing slot taking the next one's value.
_SPLIT_DEVICE = r"""
__device__ long long split_stamp[4096][14];
// [covariance ran?][span]: [.][9] attempts, [.][10..14] warp 0's covariance work in parts
__device__ unsigned long long split_cycles[2][15];
#define SPLIT_STAMP(k) split_stamp[blockIdx.x][k] = clock64()
#define SPLIT_STAMP0(k) if (threadIdx.x == 0) SPLIT_STAMP(k)
__device__ __forceinline__ void split_start() {
  if (threadIdx.x != 0) return;
  for (int k = 1; k < 14; ++k) split_stamp[blockIdx.x][k] = 0;
  SPLIT_STAMP(0);
}
__device__ __forceinline__ void split_account(bool full_accept) {
  if (threadIdx.x != 0) return;
  long long* st = split_stamp[blockIdx.x];
  st[9] = clock64();
  for (int k = 8; k >= 1; --k)
    if (st[k] == 0) st[k] = st[k + 1];
  const int cls = full_accept ? 0 : 1;
  for (int k = 0; k < 9; ++k)
    atomicAdd(&split_cycles[cls][k], static_cast<unsigned long long>(st[k + 1] - st[k]));
  atomicAdd(&split_cycles[cls][9], 1ull);
  if (st[10] == 0) return;  // no stamps inside the covariance work
  const long long sub[6] = {st[5], st[10], st[11], st[12], st[13], st[7]};
  for (int k = 0; k < 5; ++k)
    atomicAdd(&split_cycles[cls][10 + k], static_cast<unsigned long long>(sub[k + 1] - sub[k]));
}
"""
_SPLIT_ENTRIES = r"""
extern "C" int odeckpt_hi_wide_split(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long zero[30] = {};
    return static_cast<int>(cudaMemcpyToSymbol(split_cycles, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, split_cycles, sizeof(split_cycles)));
}
"""
# (anchor, text before it, text after it) in step_hi_wide.cuh; each anchor
# must occur exactly once (an anchor of alternatives: the one found)
_COMMON = (
    (("  // remainder to the checkpoint on the compensated time axis, every thread",
      "  // the step scalars, formed by the previous attempt's controller or at the"),
     "  split_start();\n", ""),
    ("    row[q] = m_pred[0].hi;\n  }\n  __syncthreads();\n",
     "", "  SPLIT_STAMP0(2);\n"),
    ("    qinv[q] = 1.0f / (qq * qq);\n  }\n  __syncthreads();\n",
     "", "  SPLIT_STAMP0(4);\n"),
    ("  L.accept = accept;\n", "  SPLIT_STAMP(6);\n", ""),
)
_BEFORE_BARRIERS = (("    row[q] = m_pred[0].hi;\n  }\n", 1),
                    ("    qinv[q] = 1.0f / (qq * qq);\n  }\n", 3))
_DESIGN = {
    "lane_work_wide": (  # thread 0 alone does the sums, the controller and the (n, n) work
        ("  const float sigma = sqrtf(zz) / (s_unit * c.sqrt_d);\n", "  SPLIT_STAMP0(5);\n", ""),
        ("  L.scale = new_scale;\n  L.nsteps = L.nsteps + 1.0f;\n}\n", "",
         None),
        ("                       L.g_acc[cur], L.g_acc[cur ^ 1]);\n  __syncthreads();\n", "",
         "  SPLIT_STAMP0(8);\n"),
    ),
    "cov_warp": (  # warp 0 and the controller's lane side by side
        ("    const float tol_acc = __shfl_sync(WIDE_FULL_MASK, acc, 1);\n", "",
         "    SPLIT_STAMP0(5);\n"),
        ("    if (warp == 0 && !(frozen || tiny)) cov_warp<NU>(L, c, p, new_scale, in.tiny_scale, "
         "cur, w);\n", "", "    SPLIT_STAMP0(7);\n"),
        ("  // -- the column's update, on the controller's decisions", "  SPLIT_STAMP0(8);\n",
         ""),
        ("  const float lq_s = new_scale * inv_mag;\n  __syncwarp();\n", "",
         "  SPLIT_STAMP0(10);\n"),
        ("  // the first n reflections (lanes.cuh's qr_r_cols<M, M, N>): every lane",
         "  SPLIT_STAMP0(11);\n", ""),
        ("  // R[r][c] = column c's row r (r < n) to work[c * n + r]; row w of l_pred",
         "  SPLIT_STAMP0(12);\n", ""),
        ("  // -- fixedpoint accumulation: G_acc gain, an output a lane, into the next",
         "  SPLIT_STAMP0(13);\n", ""),
    ),
}
COV_PARTS = ("l_bar_mag", "columns", "qr", "tri_solve_correction", "g_acc_gain")


def _insert(text, anchor, before, after):
    if isinstance(anchor, tuple):
        anchor = next((a for a in anchor if a in text), anchor[0])
    assert text.count(anchor) == 1, f"anchor not found once: {anchor!r}"
    return text.replace(anchor, before + anchor + (after or ""))


def instrument(tree, name):
    """A copy of ``tree``'s ``odecheckpts_torch`` with the split's stamps in
    its wide body; returns the copy's root."""
    out = HERE / "_scratch" / f"split_{name}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(Path(tree) / "odecheckpts_torch", out / "odecheckpts_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = out / "odecheckpts_torch" / "csrc"
    body = (csrc / "step_hi_wide.cuh").read_text()
    design = next(k for k in _DESIGN if k in body)
    body = body.replace("namespace {\n", "namespace {\n" + _SPLIT_DEVICE, 1)
    for anchor, before, after in _COMMON:
        body = _insert(body, anchor, before, after)
    for anchor, k in _BEFORE_BARRIERS:
        body = _insert(body, anchor, "", f"  SPLIT_STAMP0({k});\n")
    for anchor, before, after in _DESIGN[design]:
        if after is None:  # the end of the (n, n) work: before the closing brace
            assert body.count(anchor) == 1, anchor
            body = body.replace(anchor, anchor[:-2] + "  SPLIT_STAMP0(7);\n}\n")
        else:
            body = _insert(body, anchor, before, after)
    (csrc / "step_hi_wide.cuh").write_text(body)
    k2 = (csrc / "step_hi_wide.cu").read_text()
    call = "    attempt_wide<NU, VF>(L, rows, s, c, vf, in, d, cur);\n"
    k2 = _insert(k2, call, "", "")
    k2 = k2.replace(call, "  {\n" + call + "    split_account(L.accept && !L.tiny);\n  }\n")
    (csrc / "step_hi_wide.cu").write_text(k2 + _SPLIT_ENTRIES)
    return out, design


def _digest(outs):
    h = hashlib.sha256()
    for x in outs:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _setup(tree):
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from odecheckpts_torch import kernels

    sys.path.insert(1, str(HERE))
    import chip_smoke as cs

    return torch, kernels, cs, cs._wide_runner()


def measure(tree, name, turn):
    """One turn: build the checkout's kernels, time them, print one line."""
    torch, kernels, cs, runner = _setup(tree)
    device = torch.device("cuda", 0)
    lib = kernels.library()
    ptxas = kernels.parse_ptxas(lib.log)
    out = {"tree": name, "turn": turn, "build_seconds": lib.seconds,
           "device": torch.cuda.get_device_name(0), "card": _card(), "launch": {},
           "rows": {}, "digests": {}, "times": {},
           "ptxas": {k: ptxas.get(k) for k in ("step_hi_wide_interval", "step_hi_wide_attempt")}}
    for N, tol in LAUNCH_ROWS:
        step, state, t_next, inputs = cs._wide_start(runner, N, BATCH, tol, device)
        for form, kw in (("step_hi_wide_interval", dict(max_attempts=CAP)),
                         ("step_hi_wide_attempt", {})):
            def launch(form=form, kw=kw, step=step, state=state, inputs=inputs):
                return getattr(kernels, form)(step, state, t_next, **inputs, **kw)

            got = launch()
            key = f"{form}/d{2 * N}"
            dev = cs._device_time(form, launch)
            out["launch"][key] = {**dev, "accepted": float(torch.sum(got[11] - state[11]))}
            if form == "step_hi_wide_interval":
                out["launch"][key]["us_per_attempt"] = dev["device_ms"] * 1e3 / CAP
            out["digests"][key] = _digest(got)
            out["times"][key] = dev["device_ms"]
    for N, tol in cs.WIDE_ROWS:
        _, _, y0s = runner.workload(N, BATCH)
        u0s = torch.tensor(y0s, device=device)
        tols = torch.full((BATCH,), tol, dtype=torch.float32, device=device)
        solve = runner.make_solver(N, "cuda-loop")
        solve(u0s, tols)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(u0s, tols)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        us, uf, n = res
        key = f"row/{N}/{tol:g}"
        out["rows"][key] = {"seconds": seconds, "mean_steps": float(n[:, -1].double().mean())}
        out["digests"][key] = _digest((*us, *uf, n))
        out["times"][key] = seconds
    print(json.dumps(out), flush=True)


def measure_split(tree, name, design):
    """The split of one attempt on the instrumented copy ``tree``."""
    import ctypes

    torch, kernels, cs, runner = _setup(tree)
    device = torch.device("cuda", 0)
    lib = kernels.library()
    entry = lib.lib.odeckpt_hi_wide_split
    entry.argtypes = [ctypes.c_void_p, ctypes.c_int]
    N, tol = LAUNCH_ROWS[0]
    step, state, t_next, inputs = cs._wide_start(runner, N, BATCH, tol, device)
    kernels.step_hi_wide_interval(step, state, t_next, max_attempts=CAP, **inputs)  # warm-up
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 30)()
    assert entry(None, 1) == 0
    got = kernels.step_hi_wide_interval(step, state, t_next, max_attempts=CAP, **inputs)
    torch.cuda.synchronize()
    card = _card()
    assert entry(ctypes.addressof(buf), 0) == 0
    # spans are added modulo 2^64 (the controller's lane may end after the
    # covariance work: a negative span): read them as signed
    counts = np.array(buf, dtype=np.uint64).view(np.int64).astype(np.float64).reshape(2, 15)
    out = {"tree": name, "design": design, "split": True, "device": torch.cuda.get_device_name(0),
           "card": card, "N": N, "tol": tol, "lanes": BATCH, "max_attempts": CAP,
           "accepted": float(torch.sum(got[11] - state[11]))}
    for cls, label in ((0, "covariance_update"), (1, "other")):
        attempts = counts[cls, 9]
        spans = {s: (counts[cls, k] / attempts if attempts else None)
                 for k, s in enumerate(SPANS)}
        if design == "cov_warp" and attempts:  # warp 0's covariance work began with "control"
            spans["cov"] = spans["control"] + spans["nn"]
            spans.update({part: counts[cls, 10 + k] / attempts
                          for k, part in enumerate(COV_PARTS)})
        out[label] = {"attempts": attempts, "cycles_per_attempt": spans,
                      "total_cycles_per_attempt": (float(counts[cls, :9].sum() / attempts)
                                                   if attempts else None)}
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--measure"]:
        measure(argv[1], argv[2], int(argv[3]))
        return
    if argv[:1] == ["--measure-split"]:
        measure_split(argv[1], argv[2], argv[3])
        return
    trees = dict(a.split("=", 1) for a in argv if "=" in a and not a.startswith("--"))
    order = argv[argv.index("--order") + 1].split(",") if "--order" in argv else list(trees)

    def run(args):
        proc = subprocess.run([sys.executable, __file__, *args], capture_output=True, text=True,
                              check=False)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"{args} failed with code {proc.returncode}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        return json.loads(line)

    if "--split" in argv or "--split-only" in argv:
        for name in dict.fromkeys(order):
            copy, design = instrument(trees[name], name)
            run(["--measure-split", str(copy), name, design])
        if "--split-only" in argv:
            return
    results = [run(["--measure", trees[name], name, str(turn)])
               for turn, name in enumerate(order)]
    same = all(r["digests"] == results[0]["digests"] for r in results)
    medians = {}
    for name in dict.fromkeys(order):
        mine = [r for r in results if r["tree"] == name]
        medians[name] = {k: float(np.median([r["times"][k] for r in mine]))
                         for k in mine[0]["times"]}
    print(json.dumps({"outputs_equal_across_designs": same, "median": medians}), flush=True)
    if not same:
        raise SystemExit("the designs' outputs differ")


if __name__ == "__main__":
    main(sys.argv[1:])
