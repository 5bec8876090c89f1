"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
device, ``nvcc`` (CUDA_HOME or /usr/local/cuda) and scipy, and exits non-zero
if any phase fails.  The workload is the bench's (32,768 rigid-body IVPs,
u0 (1 + 0.05 N(0, 1)) from numpy seed 0, tspan (0, 50), 5 checkpoints,
dt0 0.1, atol 1e-3 rtol), gated against LSODA(1e-12) truth on 256 lanes:
RMSE < 3 rtol, worst lane < 6 rtol, no lane at the attempt cap.  Phases:

1. device: versions and the card's name and power limit; full-f32 matmuls.
2. build: compiles K1-K11 (odecheckpts_torch/csrc/, one nvcc per source, in
   parallel) and reports the build time and ptxas registers and spills per
   kernel and nu; for every K5 entry also its launch geometry as the C
   launch function reports it (lanes per block, threads, dynamic shared
   memory per block, resident blocks per SM from the occupancy API), which
   must equal ``kernels.dense_geometry``'s, with no spills on the main path
   (Brusselator) and at most DENSE_MAX_STACK bytes of stack or spills in any;
   for every K6 entry (both forms, both functors, nu = 2, 3, 4) its
   registers, spills, stack, static shared memory, machine instructions
   (``cuobjdump -sass``) and launch geometry (threads per lane, lanes per
   block, static and dynamic shared memory per block, blocks per SM), which
   must equal ``kernels.bd_geometry``'s, with no spills and at most
   BD_MAX_STACK bytes of stack; for every K2 and K4 entry (nu = 4, 5) the
   same report against ``kernels.hi_geometry`` (a thread per lane: their
   spills are reported, not gated); for every K1 and K3 entry (nu = 2, 3, 4)
   the same report against ``kernels.ll_geometry`` and for every K7 entry
   (both strategies) against ``kernels.everystep_geometry``, K7 with no
   spills; for every K8 entry (float32 and float64, every built m and c)
   the same report against ``kernels.pit_combine_geometry`` (a team of 8
   threads a pair, 8 pairs a block of two warps), with no spills at the
   fixed-grid path's m = 4, c = 3.
3. one attempt, kernel against twin, 4,096 lanes, from the Taylor-initialized
   and a mid-solve state: K1 and K3 at nu = 2, 3, 4 (17 arrays), K2 and K4
   at nu = 4, 5 (12 arrays): every array equal, and two launches on one
   input equal to each other.
4. f32 main path (K1): ``batched.solve_save_at_batched(engine="cuda-loop")``
   at rtol 1e-1..1e-4, parity and tuned (nu, kappa) schedules; exactly 4
   launches per solve; the median of 3 timed solves after one warm-up.
5. f32 twin on the card: the rtol 1e-3 parity row through ``engine="torch"``
   and one interval of K1 against its plain version (plain, kernel, kernel,
   plain): every array equal, and the two kernel runs equal to each other.
6. df32 main path (K2): ``batched_hi.make_hi_solver(engine="cuda-loop")`` at
   rtol 1e-5..1e-9, the 7 distinct parity and tuned rows; exactly 4 launches
   per solve; median of 3 timed solves after one warm-up; the f64 Taylor
   init timed on its own.
7. df32 twin on the card: the rtol 1e-5 parity row through
   ``engine="torch"`` and one interval of K2 against its plain version
   (plain, kernel, kernel, plain): every array equal, and the two kernel
   runs equal to each other; the first interval of the rtol 1e-9 tuned row
   (nu = 5) on K2, twice, timed, the two runs equal.
8. per-attempt engines: K3 (``engine="cuda"``, rtol 1e-3 parity) and K4
   (rtol 1e-7 parity) give the step counts and outputs of K1 and K2; one
   launch of each against its plain version (every array equal, two
   launches equal); K1 from K3's state at LL_CAPS attempts and K2 from K4's
   at HI_CAPS, device time: what a launch costs besides its attempts
   (``launch_cost_ll``, ``launch_cost_hi``).
9. routed: ``batched_hi.make_routed_solver(engine="cuda-loop")`` on 32,768
   lanes whose rtol cycles through 1e-1..1e-9, split as the bench splits
   them (rtol >= 1e-4 to f32); every truth lane within 10 max(rtol, 3e-7);
   K1 and K2 both launch.
10. attempt_dense: one attempt of K5 (interval form with max_attempts=1,
    and attempt form) against the dense twin, 4,096 lanes, initial and
    mid-interval state (with random backward conditionals), Brusselator
    (d = 4) and rigid body (d = 3), TS1 and TS0: every one of the 17 arrays
    equal (maximum deviation 0.0).
11. main_dense (K5): the stiff ensemble of
    ``experiments/4_brusselator/dense_ts1_tpu.py``:
    ``batched.solve_save_at_batched(correction="ts1", implementation="dense",
    engine="cuda-loop")`` on ``problems.brusselator(2)``, 32,768 lanes,
    u0 (1 + 0.02 N(0, 1)) from numpy seed 0, tspan (0, 10), 5 checkpoints,
    dt0 0.01, rtol 1e-5, atol 1e-3 rtol, nu 4, kappa 20; gated against
    LSODA(rtol = atol = 1e-10) on 256 lanes: filtered values RMSE < 10 rtol,
    worst lane < 20 rtol, no lane at the cap; exactly 4 launches per solve;
    the median of 3 timed solves after one warm-up; the peak device memory;
    K5's time per interval (CUDA events) in one more solve.  The smoothed
    values are reported: in f32 they miss the lane gate on some lanes, in
    the reference as in the port (``tests/test_torch_dense_smoother.py``);
    those lanes are solved again by the twin in f64 on the card, whose
    smoothed values must be within 20 rtol.
12. interval_dense: the row's second interval on K5 against its plain
    version (plain, kernel, kernel, plain), CUDA events, 32,768 lanes: every
    array equal, and the two kernel runs equal to each other (lanes of one
    block end at different attempts: a race would show here); the same
    interval at a second tile of DENSE_ALT_LANES lanes a block (two runs),
    also equal: both geometries' times are reported.
13. attempt_engine_dense: ``engine="cuda"`` (K5's attempt form) gives the
    cuda-loop row's per-lane step counts and outputs exactly; one launch
    against its plain version, timed, and the two kernel runs equal.
14. attempt_bd: one attempt of K6 (interval form with max_attempts=1, and
    attempt form) against the blockdiag twin, 4,096 lanes, initial and
    mid-interval state (with random backward conditionals), anisotropic and
    plain rigid body, nu = 2, 3, 4: all 17 arrays equal.
15. main_bd (K6): the anisotropic ensemble of
    ``experiments/6_tpu_batched_sweep/blockdiag_tpu.py``:
    ``batched.solve_save_at_batched(implementation="blockdiag",
    engine="cuda-loop")`` on ``problems.rigid_body_anisotropic`` (third
    component x 1e4), 32,768 lanes, u0 (1 + 0.05 N(0, 1)) from numpy seed 0,
    tspan (0, 50), 5 checkpoints, dt0 0.01, tol 1e-5, atol 1e-3 tol, nu 4,
    kappa 10; gated against LSODA(rtol 1e-12, atol 1e-10) on 256 lanes, errors
    divided by the scale: smoothed values RMSE < 10 tol, worst lane < 20 tol,
    no lane at the cap; exactly 4 launches per solve; median of 3 timed solves
    after one warm-up; peak device memory; K6's time per interval.
16. foil_bd (reported, one solve, no accuracy gate): the same ensemble on the
    isotropic engine (K1 with the anisotropic functor), for the step-count
    ratio that is the reason the blockdiag engine exists.
17. interval_bd: the row's second interval on K6 against its plain version
    (plain, kernel, kernel, plain), CUDA events, 32,768 lanes: every array
    equal, and the two kernel runs equal to each other (lanes of one block
    end at different attempts: a race would show here).
18. attempt_engine_bd: ``engine="cuda"`` (K6's attempt form) gives the
    cuda-loop row's per-lane step counts and outputs exactly; one launch
    against its plain version, timed, the two kernel runs equal; the
    interval form from the same state at BD_CAPS attempts, timed: what a
    launch costs besides its attempts.
19. attempt_everystep: one attempt of K7 against ``StepLL(strategy=...)``,
    smoother and filter, 4,096 lanes, nu = 2, 3, 4, initial and mid-solve
    state: all 17 arrays equal.
20. main_everystep (K7): the ensemble of
    ``experiments/6_tpu_batched_sweep/everystep_tpu.py``:
    ``batched_everystep.solve_every_step_batched(strategy="smoother",
    engine="cuda")`` on 32,768 rigid-body lanes, tspan (0, 10), dt0 0.1,
    tol 1e-4, max_steps 256, nu 4.  Gates: exactly 256 launches of K7;
    ``engine="torch"`` on the card gives every output exactly; every smoothed
    value at a valid slot finite; no lane short of t1; ``u_t1`` on 256 lanes
    against LSODA(1e-12) RMSE < 3 tol, worst lane < 6 tol; the smoothed means
    at those lanes' valid slots against LSODA at the slots' times RMSE
    < 10 tol; per-lane ``num_steps`` equal to the save_at driver's on K1 over
    the same span.  Reported: median of 3 solves, the attempts with emission
    and the backward sweep apart (CUDA events), mean valid slots, peak
    memory; one K7 launch against its plain version, timed.
21. combine_pit: K8 (``kernels.pit_combine``) against its plain version
    ``pit_fused.combine_sqrt_ll`` on random elements from numpy seed 0, f32
    and f64, every built (m, c) in {3, 4, 5} x {1, 2, 3}, P = 1024 and a
    ragged P = 1000, and on the element pairs of two levels of the main row's
    second window (captured from a solve of the row's first two windows, in
    float32 and in float64): all five outputs equal (maximum deviation 0.0).
22. main_pit (K8): the crossover workload of
    ``experiments/6_tpu_batched_sweep/pit_crossover.py`` at full width: rigid
    body, tspan (0, 10), nu = 3, TS0, filter, dynamic calibration, float32,
    uniform grid T = 16385, one IVP.  Rows: the sequential
    ``ivpsolve.solve_fixed_grid`` (once, after a warm-up on 257 grid points);
    ``parallel=True, form="sqrt", iterations=2, warmstart="rk:16"`` with
    ``combine_engine="cuda"`` at window 1024 over the whole grid, on the
    grid's first 2,049 points with "ll" and None at window 1024, and on its
    first 4,097 points with "cuda" at window 512 (most f32 windows fall back
    to the sequential filter, 4-6 s each in eager PyTorch, so the rows beside
    the kernel's are cut in depth; warm start and filter are causal, so the
    sequential row's first points are their reference).  Each row is one solve after a warm-up on
    its first two windows with the gate off.  Gates:
    every output finite; the sequential row within 1e-2 (max abs) of
    LSODA(1e-12) at the grid points (a CPU f32 run of the port measured
    2.31e-3); each parallel row within 1e-2 of the sequential ``u`` relative
    to its maximum; "cuda" equal to "ll" in every output on four windows
    solved with the gate off (``fallback_rtol=None``: every answer the
    prefix' own; the "cuda" row's first 2,049 points against the "ll" row are
    reported beside it); no "cuda" row in which every window fell back to the
    sequential filter.  Reported per
    row: ``window_diverged`` (count), ``window_delta`` (max),
    ``speedup_vs_seq``, K8 launches, and where a "cuda" solve's time goes
    (the warm start alone; two windows of sweeps with the gate off).  One f64
    pair on the first 2 windows (T = 2049, the same dt): window 1024 with
    "cuda" within 1e-6 of the f64 sequential row.
23. launch_pit: one K8 launch on the element pairs of the last level of the
    main row's second window (m = 4, c = 3, P = 1024) against its plain
    version (plain, kernel, kernel, plain), CUDA events and device time, in
    float32 (the kernel table's row) and in float64 (the row's ``f64``
    entry, its bound at the card's float64 rate, PEAK_F64_FLOPS).
24. batched_qr: K9 (``batched_qr.batched_qr_r``) against its plain version
    (equal) and against ``batched_qr_r_reference`` (atol 2e-5, Grams 2e-4) at
    (130, 10, 5), (128, 6, 6), (64, 4, 2) and (32768, 10, 5); at the last the
    times of K9, of the plain version and of ``torch.linalg.qr(mode="r")`` with
    the diagonal's sign fixed (the library call; the port never uses it).
25. qr_packing: K10 and K11 (``qr_packing.bench_kernel``) against their plain
    versions at iters 1 and 3 and m = n in {10, 8, 6} (equal), against each
    other on the upper triangle (rtol 2e-4, atol 2e-5), then timed at
    m = n = 10, iters 200, B = 8192 (the reference's size), 32,768 and
    262,144: millions of QRs per second and ``packed_over_cols``.
26. the kernel table line and the result line.

Every kernel's ``ms`` is its device time (``_device_time``: DEVICE_LAUNCHES
launches back to back behind a sleep of the stream, so the wrapper's host
time overlaps the card's busy wait), with the wrapper's host time per call
(``host_ms``), the CUDA-event time around one wrapper call (``event_ms``,
which holds the wrapper's host time) and torch.profiler's device time in a
``device_time`` line each.

Each path of phases 4, 6, 8, 9, 11, 13, 15, 18, 20 and 22 runs with the launch
counts set to 0 just before it and read just after; a kernel of the path
that did not launch fails the run.  Kernel-against-plain comparisons run outside those
windows.  Each kernel's ``bound_ms`` is the larger of its state's bytes
(read once and written once per launch) over 3.35 TB/s and the f32
operations of the accepted attempts of the timed launch over 67 TFLOP/s
(the QRs, triangular solves and products of an attempt, counted from the
shapes in ``_attempt_flops``; rejected attempts are not counted, so the bound
is a lower one).  K8-K11: each input read once and each output written once,
against the operations of the algorithm (``_combine_flops``; ``_qr_flops``
per QR, the same count for K10 and K11); K9-K11 are on no solve path, their
``launches`` are those of their phases.
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
    "step_dense_interval": ("K5", "odecheckpts_torch/csrc/step_dense.cu",
                            "odecheckpts_tpu/batched_dense.py:703"),
    "step_dense_attempt": ("K5", "odecheckpts_torch/csrc/step_dense_attempt.cu",
                           "odecheckpts_tpu/batched_dense.py:710"),
    "step_bd_interval": ("K6", "odecheckpts_torch/csrc/step_bd.cu",
                         "odecheckpts_tpu/batched_blockdiag.py:481"),
    "step_bd_attempt": ("K6", "odecheckpts_torch/csrc/step_bd_attempt.cu",
                        "odecheckpts_tpu/batched_blockdiag.py:488"),
    "step_everystep_attempt": ("K7", "odecheckpts_torch/csrc/step_everystep_attempt.cu",
                               "odecheckpts_tpu/batched_everystep.py:238"),
    "pit_combine": ("K8", "odecheckpts_torch/csrc/pit_combine.cu",
                    "odecheckpts_tpu/pit_fused.py:198"),
    "batched_qr_r": ("K9", "odecheckpts_torch/csrc/batched_qr.cu",
                     "odecheckpts_tpu/pallas_kernels.py:88"),
    "qr_packing_cols": ("K10", "odecheckpts_torch/csrc/qr_packing.cu",
                        "experiments/6_tpu_batched_sweep/qr_packing_bench.py:103"),
    "qr_packing_masked": ("K11", "odecheckpts_torch/csrc/qr_packing.cu",
                          "experiments/6_tpu_batched_sweep/qr_packing_bench.py:131"),
}
STANDALONE = ("batched_qr_r", "qr_packing_cols", "qr_packing_masked")  # on no solve path
# the dense row (experiments/4_brusselator/dense_ts1_tpu.py:76-99)
DENSE_N = 2
DENSE_RTOL = 1e-5
DENSE_TSPAN = (0.0, 10.0)
DENSE_DT0 = 0.01
DENSE_NOISE = 0.02
DENSE_RMSE_FACTOR = 10.0
DENSE_LANE_FACTOR = 20.0
DENSE_TRUTH_TOL = 1e-10
DENSE_MID_ATTEMPTS = 20
# the blockdiag row (experiments/6_tpu_batched_sweep/blockdiag_tpu.py:77-108)
BD_SCALE = (1.0, 1.0, 1e4)
BD_TOL = 1e-5
BD_DT0 = 0.01
BD_RMSE_FACTOR = 10.0
BD_LANE_FACTOR = 20.0
BD_MID_ATTEMPTS = 20
# the save-every-step row (experiments/6_tpu_batched_sweep/everystep_tpu.py:31-47)
ES_TOL = 1e-4
ES_TSPAN = (0.0, 10.0)
ES_MAX_STEPS = 256
ES_SMOOTHED_FACTOR = 10.0
# the fixed-grid row (experiments/6_tpu_batched_sweep/pit_crossover.py:62-73, 111-154)
PIT_NU = 3
PIT_T = 16_385
PIT_TSPAN = (0.0, 10.0)
PIT_KW = dict(parallel=True, form="sqrt", iterations=2, warmstart="rk:16")
# (window, combine_engine, windows solved): the kernel's row at full width; its plain
# twin's and engine None's on the grid's first 2,049 points, window 512 on its
# first 4,097
PIT_ROWS = ((1024, "cuda", None), (1024, "ll", 2), (512, "cuda", 8), (1024, None, 2))
PIT_REL_GATE = 1e-2
PIT_LSODA_BOUND = 1e-2  # max abs; a CPU f32 run of the port measured 2.31e-3
PIT_F64_WINDOWS = 2
PIT_F64_GATE = 1e-6
PIT_SEQ_WARM_T = 257
QR_SHAPES = ((130, 10, 5), (128, 6, 6), (64, 4, 2), (32_768, 10, 5))
PACKING_ITERS = 200
PACKING_BATCHES = (8_192, 32_768, 262_144)
# the H100 SXM's published peaks: f32 outside the tensor cores and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12  # the H100 SXM's float64 rate outside the tensor cores (data sheet)
PEAK_BYTES_PER_S = 3.35e12
# K5: the largest stack frame its entries may have (the lane's arrays live in
# shared memory), and the second tile that phase 12 measures beside the default
DENSE_MAX_STACK = 512
DENSE_ALT_LANES = 12
# K6: the largest stack frame its entries may have (a thread's arrays live in
# registers or shared memory)
BD_MAX_STACK = 64
# the attempt caps at which phase 18 times K6's interval form from one state
BD_CAPS = (1, 2, 4, 8)
# the attempt caps at which phase 8 times K2 from K4's state
HI_CAPS = (1, 2, 4, 8)
# the attempt caps at which phase 8 times K1 from K3's state
LL_CAPS = (1, 2, 4, 8)
# device-only times: launches back to back behind a sleep of the stream
DEVICE_LAUNCHES = 20
SLEEP_CYCLES = 200_000_000
# the substring of each kernel's symbol that torch.profiler shows
SYMBOLS = {"batched_qr_r": "batched_qr"}


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
    dense = tuple(f"4/{c}/{f}" for f in ("Brusselator", "RigidBody") for c in ("ts1", "ts0"))
    bd = tuple(f"{nu}/{f}" for f in ("RigidBodyAniso", "RigidBody") for nu in (2, 3, 4))
    everystep = tuple(f"{nu}/{s}" for s in ("smoother", "filter") for nu in (2, 3, 4))
    want = {"step_ll_interval": (2, 3, 4), "step_ll_attempt": (2, 3, 4),
            "step_hi_interval": (4, 5), "step_hi_attempt": (4, 5),
            "step_dense_interval": dense, "step_dense_attempt": dense,
            "step_bd_interval": bd, "step_bd_attempt": bd,
            "step_everystep_attempt": everystep,
            "pit_combine": tuple(f"{t}/{m}/{c}" for t in ("f32", "f64") for m in kernels.PIT_COMBINE_M
                                 for c in kernels.PIT_COMBINE_C),
            "batched_qr_r": tuple(f"{m}/{n}" for m, n in kernels.BATCHED_QR_SHAPES),
            "qr_packing_cols": tuple(f"{m}/{n}" for m, n in kernels.QR_PACKING_SHAPES),
            "qr_packing_masked": tuple(f"{m}/{n}" for m, n in kernels.QR_PACKING_SHAPES)}
    missing = [(k, nu) for k, nus in want.items() for nu in nus
               if "registers" not in ptxas.get(k, {}).get(nu, {})]
    if missing:
        raise RuntimeError(f"ptxas reported no kernel for {missing}:\n{lib.log}")
    sass = _sass_instructions(lib.path)
    return {**phase_build_dense(ptxas), **phase_build_bd(ptxas, sass),
            **phase_build_hi(ptxas, sass), **phase_build_ll(ptxas, sass),
            **phase_build_pit(ptxas, sass)}


def _sass_instructions(path):
    """Machine instructions of each step kernel of the library at ``path``
    (``cuobjdump -sass``), keyed as ``parse_ptxas`` keys them; empty where
    the toolkit has no cuobjdump."""
    import re
    from pathlib import Path

    from odecheckpts_torch import kernels

    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            key = kernels._ptxas_key(fn.group(1))
            if key:
                counts.setdefault(key[0], {})[key[1]] = 0
        elif key and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[key[0]][key[1]] += 1
    return counts


def phase_build_dense(ptxas):
    """K5's ptxas counts beside the launch geometry its C launch functions
    report; fails if that geometry is not ``kernels.dense_geometry``'s, if
    no block fits on an SM, on spills in a main-path entry (Brusselator) or
    above DENSE_MAX_STACK bytes in any, or on a stack frame above
    DENSE_MAX_STACK.  Returns the geometry of each form's main-path entry
    (Brusselator, TS1)."""
    from odecheckpts_torch import kernels

    main, bad = {}, []
    for name in ("step_dense_interval", "step_dense_attempt"):
        for functor, d in (("Brusselator", 4), ("RigidBody", 3)):
            for corr in ("ts1", "ts0"):
                key = f"4/{corr}/{functor}"
                geometry = kernels.step_dense_geometry(name, d, corr == "ts1", 0)
                info = {**ptxas[name][key], **geometry}
                emit({"phase": "build_dense", "kernel": "K5", "form": name, "entry": key, **info})
                want = kernels.dense_geometry(5 * d, d, kernel=name)
                spills = info.get("spill_stores", 0) + info.get("spill_loads", 0)
                if (any(geometry[k] != v for k, v in want.items()) or geometry["blocks_per_sm"] < 1
                        or (spills and functor == "Brusselator") or spills > DENSE_MAX_STACK
                        or info.get("stack", 0) > DENSE_MAX_STACK):
                    bad.append((name, key, info, want))
                if key == "4/ts1/Brusselator":
                    main[name] = info
    if bad:
        raise AssertionError(f"K5's geometry or ptxas counts are off: {bad}")
    return main


def phase_build_bd(ptxas, sass):
    """K6's ptxas counts and machine instructions beside the launch geometry
    its C launch functions report, for every entry; fails if that geometry
    is not
    ``kernels.bd_geometry``'s, if no block fits on an SM, on any spill or on a
    stack frame above BD_MAX_STACK.  Returns the geometry of each form's
    main-path entry (nu = 4, anisotropic rigid body)."""
    from odecheckpts_torch import kernels

    main, bad = {}, []
    for name in ("step_bd_interval", "step_bd_attempt"):
        for functor, cname in (("rigid_body_anisotropic", "RigidBodyAniso"),
                               ("rigid_body", "RigidBody")):
            for nu in (2, 3, 4):
                key = f"{nu}/{cname}"
                geometry = kernels.step_bd_geometry(name, nu, functor)
                info = {**ptxas[name][key], **geometry,
                        "sass_instructions": sass.get(name, {}).get(key)}
                emit({"phase": "build_bd", "kernel": "K6", "form": name, "entry": key, **info})
                want = kernels.bd_geometry(nu, 3)
                spills = info.get("spill_stores", 0) + info.get("spill_loads", 0)
                if (any(geometry[k] != v for k, v in want.items())
                        or geometry["blocks_per_sm"] < 1 or spills
                        or info.get("stack", 0) > BD_MAX_STACK):
                    bad.append((name, key, info, want))
        main[name] = kernels.step_bd_geometry(name, 4, "rigid_body_anisotropic")
    if bad:
        raise AssertionError(f"K6's geometry or ptxas counts are off: {bad}")
    return main


def phase_build_hi(ptxas, sass):
    """K2's and K4's ptxas counts and machine instructions beside the launch
    geometry their C launch functions report, for nu = 4 and 5; fails if
    that geometry is not ``kernels.hi_geometry``'s or if no block fits on an
    SM.  Returns the geometry of each form at nu = 4 (the rows of phases
    6-8)."""
    from odecheckpts_torch import kernels

    main, bad = {}, []
    for name in ("step_hi_interval", "step_hi_attempt"):
        for nu in (4, 5):
            geometry = kernels.step_hi_geometry(name, nu)
            info = {**ptxas[name][nu], **geometry, "sass_instructions": sass.get(name, {}).get(nu)}
            emit({"phase": "build_hi", "kernel": KERNELS[name][0], "form": name, "nu": nu, **info})
            want = kernels.hi_geometry(nu)
            if any(geometry[k] != v for k, v in want.items()) or geometry["blocks_per_sm"] < 1:
                bad.append((name, nu, info, want))
        main[name] = kernels.step_hi_geometry(name, 4)
    if bad:
        raise AssertionError(f"K2's or K4's geometry is off: {bad}")
    return main


def phase_build_ll(ptxas, sass):
    """K1's, K3's and K7's ptxas counts and machine instructions beside the
    launch geometry their C launch functions report, for nu = 2, 3, 4 (K7:
    both strategies); fails if that geometry is not ``kernels.ll_geometry``'s
    (K7: ``kernels.everystep_geometry``'s) or if no block fits on an SM (a
    thread per lane at up to 255 registers: their spills are reported, not
    gated).
    Returns the geometry of K1 and K3 at nu = 4 (the rows of phases 5
    and 8)."""
    from odecheckpts_torch import kernels

    main, bad = {}, []
    forms = [(name, nu, nu, kernels.step_ll_geometry(name, nu), kernels.ll_geometry(nu))
             for name in ("step_ll_interval", "step_ll_attempt") for nu in (2, 3, 4)]
    forms += [("step_everystep_attempt", nu, f"{nu}/{strategy}",
               kernels.step_everystep_geometry(nu, strategy), kernels.everystep_geometry(nu))
              for strategy in ("smoother", "filter") for nu in (2, 3, 4)]
    for name, nu, key, geometry, want in forms:
        info = {**ptxas[name][key], **geometry, "sass_instructions": sass.get(name, {}).get(key)}
        emit({"phase": "build_ll", "kernel": KERNELS[name][0], "form": name, "entry": key, **info})
        spills = info.get("spill_stores", 0) + info.get("spill_loads", 0)
        if (any(geometry[k] != v for k, v in want.items()) or geometry["blocks_per_sm"] < 1
                or (spills and name == "step_everystep_attempt")):
            bad.append((name, key, info, want))
        if key in (4, "4/smoother"):
            main[name] = geometry
    if bad:
        raise AssertionError(f"K1's, K3's or K7's geometry or ptxas counts are off: {bad}")
    return main


def phase_build_pit(ptxas, sass):
    """K8's ptxas counts and machine instructions beside the launch geometry
    its C geometry entry reports, for every built (type, m, c); fails if
    that geometry is not ``kernels.pit_combine_geometry``'s, if no block
    fits on an SM, or on a spill in the fixed-grid path's instantiations
    (m = 4, c = 3, both types; the others' are reported).  Returns the
    geometry of the main row's instantiation (float32, m = 4, c = 3)."""
    import torch

    from odecheckpts_torch import kernels

    bad = []
    for dtype in (torch.float32, torch.float64):
        for m in kernels.PIT_COMBINE_M:
            for c in kernels.PIT_COMBINE_C:
                key = f"{'f32' if dtype == torch.float32 else 'f64'}/{m}/{c}"
                geometry = kernels.step_pit_combine_geometry(m, c, dtype)
                info = {**ptxas["pit_combine"][key], **geometry,
                        "sass_instructions": sass.get("pit_combine", {}).get(key)}
                emit({"phase": "build_pit", "kernel": "K8", "entry": key, **info})
                want = kernels.pit_combine_geometry(m, c, dtype)
                spills = info.get("spill_stores", 0) + info.get("spill_loads", 0)
                if (any(geometry[k] != v for k, v in want.items())
                        or geometry["blocks_per_sm"] < 1 or (spills and (m, c) == (4, 3))):
                    bad.append((key, info, want))
    if bad:
        raise AssertionError(f"K8's geometry or ptxas counts are off: {bad}")
    return {"pit_combine": kernels.step_pit_combine_geometry(4, 3, torch.float32)}


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
    twin: every array equal, and two launches on one input equal to each
    other; returns the largest deviation of each (0.0)."""
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
            for name, run in (
                ("step_ll_interval", lambda s=start: kernels.step_ll_interval(
                    step, s, t_next, max_attempts=1, **inputs)),
                ("step_ll_attempt", lambda s=start: kernels.step_ll_attempt(
                    step, s, t_next, **inputs)),
            ):
                got, again = run(), run()
                torch.cuda.synchronize()
                devs, _, w = _deviations(STATE_NAMES, got, want, torch)
                worst[name] = max(worst[name], w)
                unequal = [n for n, g, x in zip(STATE_NAMES, got, want)
                           if not _same_bits(g, x, torch)]
                repeat = all(_same_bits(a, b, torch) for a, b in zip(got, again))
                emit({"phase": "attempt", "kernel": KERNELS[name][0], "nu": nu, "state": label,
                      "max_abs_and_rel_dev": devs, "arrays_unequal": unequal,
                      "launches_equal": repeat})
                if unequal or not repeat:
                    raise AssertionError(
                        f"{KERNELS[name][0]} and its twin disagree at nu={nu} ({label}) in "
                        f"{unequal}, or two launches differ ({not repeat})"
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
            for name, run in (
                ("step_hi_interval", lambda s=start: kernels.step_hi_interval(
                    step, s, t_next, max_attempts=1, **inputs)),
                ("step_hi_attempt", lambda s=start: kernels.step_hi_attempt(
                    step, s, t_next, **inputs)),
            ):
                got, again = run(), run()
                torch.cuda.synchronize()
                devs, bad, w = _deviations(STATE_NAMES_HI, got, want, torch, pairs=(0, 2, 7))
                worst[name] = max(worst[name], w)
                unequal = [n for n, g, x in zip(STATE_NAMES_HI, got, want)
                           if not _same_bits(g, x, torch)]
                repeat = all(_same_bits(a, b, torch) for a, b in zip(got, again))
                emit({"phase": "attempt_hi", "kernel": KERNELS[name][0], "nu": nu,
                      "state": label, "max_abs_and_rel_dev": devs, "arrays_unequal": unequal,
                      "launches_equal": repeat})
                if bad or unequal or not repeat:
                    raise AssertionError(
                        f"{KERNELS[name][0]} and its twin disagree at nu={nu} ({label}) in "
                        f"{unequal or bad}, or two launches differ ({not repeat})"
                    )
    return worst


def _same_bits(a, b, torch):
    """Whether two arrays are equal, NaN where the other has NaN."""
    return (bool(torch.equal(torch.isnan(a), torch.isnan(b)))
            and bool(torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))))


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


def _gates(u_s, nsteps, truth, rtol, rmse_factor=RMSE_FACTOR, lane_factor=LANE_FACTOR):
    from odecheckpts_torch import harness

    u = u_s[:SAMPLE].double().cpu().numpy()
    rmse = float(harness.rmse_absolute(truth)(u))
    worst = float(np.max(_lane_errors(u_s, truth)))
    inc = np.diff(nsteps.cpu().numpy().astype(np.int64), axis=1)
    capped = int(np.sum(np.any(inc >= MAX_ATTEMPTS, axis=1)))
    ok = (np.isfinite(rmse) and rmse < rmse_factor * rtol and worst < lane_factor * rtol
          and capped == 0)
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


def _device_time(name, fn, n=DEVICE_LAUNCHES, profile=False):
    """The kernel's own time per launch, apart from its wrapper's host time.

    A long ``torch.cuda._sleep`` keeps the stream busy while the host
    enqueues the start event, ``n`` calls of ``fn`` (the wrapper, the same
    inputs each time) and the end event, so the events see the launches back
    to back: ``device_ms`` is their time over ``n``.  ``host_ms`` is the host
    clock around the ``n`` calls, over ``n``: what the wrapper costs before
    its launch is enqueued.  ``overlapped``: the sleep outlasted the
    enqueue (else it is doubled and the run repeated, twice at most).  With
    ``profile``, ``profiler_ms`` is torch.profiler's device time of the
    kernels whose name holds ``name`` over ``n`` (None where it shows
    none)."""
    import torch

    from odecheckpts_torch import kernels

    counts = dict(kernels.LAUNCHES)  # these launches are measurement, not a path's
    fn()  # warm-up
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = time.perf_counter() - t0
        end.record()
        overlapped = not start.query()
        torch.cuda.synchronize()
        if overlapped:
            break
        cycles *= 2
    out = {"device_ms": start.elapsed_time(end) / n, "host_ms": host * 1e3 / n,
           "overlapped": overlapped, "launches_timed": n}
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for evt in pr.key_averages():
            if name in evt.key:
                us += float(getattr(evt, "device_time_total", 0.0)
                            or getattr(evt, "cuda_time_total", 0.0))
        out["profiler_ms"] = us / 1e3 / n if us > 0 else None
    kernels.LAUNCHES.update(counts)
    return out


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
    k_out, p_out = times["kernel"][1], times["plain"][1]
    interval = {"kernel_ms": [times["kernel"][0], times["kernel2"][0]],
                "plain_ms": [times["plain"][0], times["plain2"][0]],
                "lanes_with_other_step_counts": int(torch.sum(k_out[15] != p_out[15])),
                "arrays_equal": all(_same_bits(a, b, torch) for a, b in zip(k_out, p_out)),
                "kernel_runs_equal": _runs_equal(times, k_out, torch)}
    emit({"phase": "interval", "kernel": "K1", "rtol": rtol, "nu": nu, "batch": BATCH,
          **interval})
    if (interval["lanes_with_other_step_counts"] or not interval["arrays_equal"]
            or not interval["kernel_runs_equal"]):
        raise AssertionError("K1 and its plain version differ over an interval, or two kernel "
                             "runs differ")
    return _timing("step_ll_interval", times, state, 15, nu=nu, d=3,
                   run=run(kernels.step_ll_interval))


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
                "max_abs_dev_mean_hi": float(torch.max(torch.abs(k_out[2] - p_out[2]))),
                "arrays_equal": all(_same_bits(a, b, torch) for a, b in zip(k_out, p_out)),
                "kernel_runs_equal": _runs_equal(times, k_out, torch)}
    emit({"phase": "interval", "kernel": "K2", "rtol": rtol, "nu": nu, "batch": BATCH,
          **interval})
    if (interval["lanes_with_other_step_counts"] or not interval["arrays_equal"]
            or not interval["kernel_runs_equal"]):
        raise AssertionError("K2 and its plain version differ over an interval, or two kernel "
                             "runs differ")
    timing = _timing("step_hi_interval", times, state, 11, nu=nu, d=3,
                     run=run(kernels.step_hi_interval))

    # the first interval of the rtol 1e-9 tuned row (nu = 5) on K2 alone: its
    # plain version would take tens of seconds there
    rtol_t = 1e-9
    nu_t, kappa_t = SCHEDULES_HI["tuned"][rtol_t]
    tols_t = torch.full((BATCH,), rtol_t, dtype=torch.float32, device=device)
    state_t, inputs_t, t_next_t = _hi_state(u0s, tols_t, nu_t, torch)
    step_t = batched_hi.make_step_hi(problems.rigid_body_df(), nu=nu_t, d=3,
                                     error_calibration=kappa_t)

    def tight():
        return kernels.step_hi_interval(step_t, state_t, t_next_t, max_attempts=MAX_ATTEMPTS,
                                        **inputs_t)

    pair = _time_pair((("kernel", tight), ("kernel2", tight)))
    repeat = _runs_equal(pair, pair["kernel"][1], torch)
    accepted = float(torch.sum(pair["kernel"][1][11] - state_t[11]))
    emit({"phase": "interval", "kernel": "K2", "rtol": rtol_t, "nu": nu_t, "kappa": kappa_t,
          "batch": BATCH, "kernel_ms": [pair["kernel"][0], pair["kernel2"][0]],
          "accepted_attempts": accepted, "kernel_runs_equal": repeat})
    if not repeat:
        raise AssertionError("two K2 runs of the rtol 1e-9 tuned interval differ")
    return timing


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
    for name, st, s, inp, nsteps_at, nu in (
            ("step_ll_attempt", step, state, inputs, 15, nu_ll),
            ("step_hi_attempt", step_hi, state_hi, inputs_hi, 11, nu_hi)):
        kernel, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
        times = _time_pair((
            ("plain", lambda: plain(st, s, t_next, **inp)),
            ("kernel", lambda: kernel(st, s, t_next, **inp)),
            ("kernel2", lambda: kernel(st, s, t_next, **inp)),
            ("plain2", lambda: plain(st, s, t_next, **inp)),
        ))
        dev = max(float(torch.max(torch.abs(a - b)))
                  for a, b in zip(times["kernel"][1], times["plain"][1]))
        one[name] = _timing(name, times, s, nsteps_at, nu=nu, d=3,
                            run=lambda: kernel(st, s, t_next, **inp))
        extra = {"arrays_equal": all(_same_bits(a, b, torch)
                                     for a, b in zip(times["kernel"][1], times["plain"][1])),
                 "kernel_runs_equal": _runs_equal(times, times["kernel"][1], torch)}
        emit({"phase": "one_launch", "kernel": KERNELS[name][0], "batch": BATCH,
              "kernel_ms": [times["kernel"][0], times["kernel2"][0]],
              "plain_ms": [times["plain"][0], times["plain2"][0]], "max_abs_dev": dev,
              "device_ms": one[name]["ms"], "host_ms": one[name]["host_ms"], **extra})
        if not all(extra.values()):
            raise AssertionError(f"one launch of {KERNELS[name][0]} differs from its plain "
                                 f"version, or two launches differ: {extra}")

    # K1 from K3's state and K2 from K4's at LL_CAPS / HI_CAPS attempts, device
    # time: a fixed cost per launch and a cost per attempt
    for phase, kernel, caps_at, st, s, inp in (
            ("launch_cost_ll", "step_ll_interval", LL_CAPS, step, state, inputs),
            ("launch_cost_hi", "step_hi_interval", HI_CAPS, step_hi, state_hi, inputs_hi)):
        caps = {cap: _device_time(kernel, lambda cap=cap, st=st, s=s, inp=inp: getattr(
                    kernels, kernel)(st, s, t_next, **inp, max_attempts=cap))["device_ms"]
                for cap in caps_at}
        per_attempt = (caps[caps_at[-1]] - caps[caps_at[0]]) / (caps_at[-1] - caps_at[0])
        emit({"phase": phase, "kernel": KERNELS[kernel][0], "batch": BATCH,
              "nu": st.nu, "interval_ms_by_cap": caps, "per_attempt_ms": per_attempt,
              "fixed_ms": caps[caps_at[0]] - caps_at[0] * per_attempt})
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


def _qr_flops(m, nc, nr):
    """f32 operations that a Householder QR of m rows and nc columns needs for
    min(nr, m - 1) reflections: reflection j takes 2 (m - j) for its norm and
    4 (m - j) for each column after j (a dot product and an update).  The
    kernels' loops run over full-length rows and do more: this counts the
    algorithm's work, not theirs."""
    return sum(2 * (m - j) + 4 * (m - j) * (nc - j - 1) for j in range(min(nr, m - 1)))


def _attempt_flops(kernel, nu, d):
    """f32 operations of one accepted attempt, from the step's shapes: its
    QRs, triangular solves and products (scalar work of O(n) is left out,
    so this is a lower count)."""
    n = nu + 1
    if kernel.startswith("step_ll"):
        return (_qr_flops(2 * n, 2 * n, 2 * n) + _qr_flops(2 * n, n, n) + n**3
                + 6 * n**3 + 6 * n * n * d + 2 * n * n)
    if kernel.startswith("step_bd"):  # d times the isotropic covariance work at d = 1
        return d * _attempt_flops("step_ll", nu, 1)
    if kernel.startswith("step_everystep"):  # the smoother: no accumulation QR or products
        return (_qr_flops(2 * n, 2 * n, 2 * n) + n**3 + 2 * n**3 + 4 * n * n * d + 2 * n * n)
    if kernel.startswith("step_hi"):  # pair multiply-adds counted at 20 operations
        return (_qr_flops(2 * n, 2 * n, n) + n**3 + 4 * n**3 + 4 * n * n * d + 2 * n * n
                + 20 * d * n * (n - 1) // 2)
    nd = n * d
    return (_qr_flops(nd, d, d) + _qr_flops(2 * nd, 2 * nd, 2 * nd) + _qr_flops(nd, d + nd, d + nd)
            + _qr_flops(2 * nd, nd, nd) + nd**3 + d * d * nd + n * (n + 1) * d * nd
            + 4 * nd**3 + 4 * nd * nd + 2 * d * d * nd)


def _timing(kernel, times, state, nsteps_index, *, nu, d, run):
    """The kernel's device time per launch (``_device_time`` of ``run``, the
    kernel's wrapper on the timed inputs), its wrapper's host time, the
    faster of the two kernel and the two plain event times of ``times``
    (from ``_time_pair``), the accepted attempts of the kernel's run, and
    the bytes and operations of its bound."""
    import torch

    out = times["kernel"][1]
    accepted = float(torch.sum(out[nsteps_index] - state[nsteps_index]))
    lanes = state[0].shape[-1]
    nbytes = 2 * sum(x.numel() * x.element_size() for x in state) + 6 * lanes * 4
    return _with_device_time(kernel, run, {
        "event_ms": min(times["kernel"][0], times["kernel2"][0]),
        "plain_ms": min(times["plain"][0], times["plain2"][0]),
        "accepted": accepted, "bytes": nbytes, "flops": accepted * _attempt_flops(kernel, nu, d)})


def _with_device_time(kernel, run, info):
    """``info`` with the kernel's device time as its ``ms``, and one line of
    the device and host times."""
    dev = _device_time(SYMBOLS.get(kernel, kernel), run, profile=True)
    emit({"phase": "device_time", "kernel": KERNELS[kernel][0], "form": kernel,
          "event_ms": info.get("event_ms"), **dev})
    return {**info, "ms": dev["device_ms"], "host_ms": dev["host_ms"],
            "profiler_ms": dev.get("profiler_ms")}


def _bound(info):
    """The least time of the work: state bytes over the memory rate or
    operations over the rate of their type (f32 unless ``info`` names
    another ``peak_flops``), whichever is larger; ms and which."""
    t_bytes = info["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = info["flops"] / info.get("peak_flops", PEAK_F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dense_problem(name):
    from odecheckpts_torch import problems

    if name == "brusselator":
        vf, (y0,), _, params = problems.brusselator(DENSE_N)
        return vf, y0, params, DENSE_DT0
    vf, (y0,), _, params = problems.rigid_body(time_span=DENSE_TSPAN)
    return vf, y0, params, 0.1


def _dense_ensemble(y0, batch, torch, device):
    rng = np.random.default_rng(SEED)
    y0 = y0.numpy()
    rows = (y0[None] * (1.0 + DENSE_NOISE * rng.standard_normal((batch, y0.shape[0]))))
    return torch.tensor(rows.astype(np.float32), device=device)


def _dense_save_at():
    return np.linspace(DENSE_TSPAN[0], DENSE_TSPAN[1], NUM_SAVE).astype(np.float32)


def _random_backward(state, torch, seed=SEED):
    """``state`` with random backward conditionals (``bwdG``, ``bwd_m``,
    ``bwd_L`` and their previous values, from numpy), for any layout (dense
    (nd, nd, B) or blockdiag (n, n, d, B) factors): within the first interval
    they are exactly zero (the Taylor init has zero covariance, so the gains
    are 0), which would leave the fixedpoint accumulation out."""
    rng = np.random.default_rng(seed)
    out = list(state)
    n = out[3].shape[0]
    lead = (n, n) + (1,) * (out[3].dim() - 2)
    for i in (3, 10):
        out[i] = np.eye(n).reshape(lead) + 0.3 * rng.standard_normal(out[i].shape) / np.sqrt(n)
    for i in (4, 11):
        out[i] = rng.standard_normal(out[i].shape)
    for i in (5, 12):
        out[i] = 0.3 * rng.standard_normal(out[i].shape) * np.tril(np.ones((n, n))).reshape(lead)
    for i in (3, 4, 5, 10, 11, 12):
        out[i] = torch.tensor(np.ascontiguousarray(out[i], dtype=np.float32),
                              device=state[0].device)
    return tuple(x.contiguous() for x in out)


def phase_attempt_dense(device):
    """One attempt of K5 in both forms against the dense twin: every array
    equal, for both functors and both corrections; returns the largest
    deviation of each form."""
    import torch

    from odecheckpts_torch import batched, batched_dense, kernels

    worst = {"step_dense_interval": 0.0, "step_dense_attempt": 0.0}
    save_at = _dense_save_at()
    tols = torch.tensor(np.geomspace(1e-3, 1e-6, ATTEMPT_LANES), dtype=torch.float32,
                        device=device)
    t_next = torch.full((1, ATTEMPT_LANES), float(save_at[1]), device=device)
    for problem in ("brusselator", "rigid_body"):
        vf, y0, params, dt0 = _dense_problem(problem)
        u0s = _dense_ensemble(y0, ATTEMPT_LANES, torch, device)
        state, _, inputs = batched.initial_state(vf, u0s, params, save_at=save_at, dt0=dt0,
                                                 tols=tols, implementation="dense")
        for corr in ("ts1", "ts0"):
            step = batched_dense.make_step_dense(vf, params, nu=4, d=u0s.shape[1],
                                                 correction=corr)
            mid = state
            for _ in range(DENSE_MID_ATTEMPTS):
                mid = kernels.attempt_plain(step, mid, t_next, **inputs)
            mid = _random_backward(mid, torch)
            for label, start in (("init", state), ("mid", mid)):
                want = kernels.attempt_plain(step, start, t_next, **inputs)
                for name, got in (
                    ("step_dense_interval", kernels.step_dense_interval(
                        step, start, t_next, max_attempts=1, **inputs)),
                    ("step_dense_attempt", kernels.step_dense_attempt(
                        step, start, t_next, **inputs)),
                ):
                    torch.cuda.synchronize()
                    devs = [float(torch.max(torch.abs(g - w))) for g, w in zip(got, want)]
                    equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
                    worst[name] = max([worst[name], *devs])
                    emit({"phase": "attempt_dense", "kernel": KERNELS[name][0], "form": name,
                          "problem": problem, "correction": corr, "state": label,
                          "accepted": int(torch.sum(want[0] != start[0])),
                          "max_abs_dev": max(devs), "arrays_equal": equal})
                    if not equal:
                        bad = [n for n, g, w in zip(STATE_NAMES, got, want)
                               if not torch.equal(g, w)]
                        raise AssertionError(f"{name} and the dense twin differ ({problem}, "
                                             f"{corr}, {label}) in {bad}")
    return worst


def _truth_brusselator(rows, save_at):
    """Per-lane scipy LSODA reference of the Brusselator at the checkpoints
    (experiments/4_brusselator/dense_ts1_tpu.py:36-59)."""
    import scipy.integrate

    n = DENSE_N
    c = 1.0 / 50.0 * (n + 1) ** 2

    def vf_np(_t, y):
        u, v = y[:n], y[n:]
        u_ = np.concatenate([[1.0], u, [1.0]])
        v_ = np.concatenate([[3.0], v, [3.0]])
        cu = u_[:-2] - 2.0 * u_[1:-1] + u_[2:]
        cv = v_[:-2] - 2.0 * v_[1:-1] + v_[2:]
        return np.concatenate([1.0 + u**2 * v - 4.0 * u + c * cu, 3.0 * u - u**2 * v + c * cv])

    out = []
    for row in rows:
        sol = scipy.integrate.solve_ivp(
            vf_np, (float(save_at[0]), float(save_at[-1])), row, t_eval=save_at,
            rtol=DENSE_TRUTH_TOL, atol=DENSE_TRUTH_TOL, method="LSODA",
        )
        out.append(sol.y.T)
    return np.stack(out)


def _smoothed_check(vf, params, u0s, tols, u_s, nsteps, truth):
    """The smoothed output on the sampled lanes.  In f32 the reference's dense
    fixedpoint smoother misses the row's gate on some lanes by orders of
    magnitude, as the port's does (``tests/test_torch_dense_smoother.py``
    holds both on this row's sample), so the f32 values are reported, and
    the sampled lanes over the lane gate are solved again in f64 by the twin
    on the card: there the smoothed values must meet the lane gate.  Returns
    (the numbers, whether that held)."""
    import torch

    from odecheckpts_torch import batched

    _, rmse, worst, _ = _gates(u_s, nsteps, truth, DENSE_RTOL)
    rows = np.nonzero(_lane_errors(u_s, truth) >= DENSE_LANE_FACTOR * DENSE_RTOL)[0]
    out = {"smoothed_rmse_over_rtol": rmse / DENSE_RTOL,
           "smoothed_worst_lane_over_rtol": worst / DENSE_RTOL,
           "smoothed_rows_over_lane_gate": rows.tolist()}
    if rows.size == 0:
        return out, True
    idx = torch.as_tensor(rows, device=u0s.device)
    u64, _, _ = batched.solve_save_at_batched(
        vf, u0s[idx].double(), params, save_at=_dense_save_at().astype(np.float64),
        dt0=DENSE_DT0, tols=tols[idx].double(), correction="ts1", implementation="dense",
        engine="torch", max_attempts=MAX_ATTEMPTS)
    err = np.sqrt(np.mean((u64.cpu().numpy() - truth[rows]) ** 2, axis=(1, 2)))
    out["f64_twin_smoothed_worst_lane_over_rtol"] = float(np.max(err)) / DENSE_RTOL
    return out, bool(np.all(err < DENSE_LANE_FACTOR * DENSE_RTOL))


def _dense_solver(vf, u0s, params, tols, engine):
    from odecheckpts_torch import batched

    save_at = _dense_save_at()

    def solve():
        return batched.solve_save_at_batched(
            vf, u0s, params, save_at=save_at, dt0=DENSE_DT0, tols=tols, correction="ts1",
            implementation="dense", engine=engine, max_attempts=MAX_ATTEMPTS,
        )

    return solve


def _kernel_share(solve, name):
    """CUDA-event times (ms) of each launch of wrapper ``name`` in one more,
    untimed, call of ``solve``: the kernel's part of a solve."""
    import torch

    from odecheckpts_torch import kernels

    wrapper, times = getattr(kernels, name), []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = wrapper(*args, **kwargs)
        end.record()
        times.append((start, end))
        return out

    setattr(kernels, name, timed)
    try:
        solve()
    finally:
        setattr(kernels, name, wrapper)
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in times]


def phase_main_dense(device):
    """The Brusselator TS1 row on K5's interval form."""
    import torch

    from odecheckpts_torch import batched, kernels

    vf, y0, params, _ = _dense_problem("brusselator")
    u0s = _dense_ensemble(y0, BATCH, torch, device)
    d = u0s.shape[1]
    t0 = time.perf_counter()
    truth = _truth_brusselator(u0s[:SAMPLE].double().cpu().numpy(),
                               _dense_save_at().astype(np.float64))
    emit({"phase": "truth_dense", "lanes": SAMPLE, "seconds": time.perf_counter() - t0})
    tols = torch.full((BATCH,), DENSE_RTOL, dtype=torch.float32, device=device)
    solve = _dense_solver(vf, u0s, params, tols, "cuda-loop")
    solve()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    times, launches = [], set()
    for _ in range(REPEATS):
        before = kernels.LAUNCHES["step_dense_interval"]
        secs, (u_s, u_f, nsteps) = _timed(solve)
        launches.add(kernels.LAUNCHES["step_dense_interval"] - before)
        times.append(secs)
    peak = torch.cuda.max_memory_allocated(device)
    launches = launches.pop() if len(launches) == 1 else sorted(launches)
    seconds = float(np.median(times))
    k5_ms = _kernel_share(solve, "step_dense_interval")
    ok, rmse, worst, capped = _gates(u_f, nsteps, truth, DENSE_RTOL, DENSE_RMSE_FACTOR,
                                     DENSE_LANE_FACTOR)
    smoothed, smoothed_ok = _smoothed_check(vf, params, u0s, tols, u_s, nsteps, truth)
    finite = bool(torch.all(torch.isfinite(u_s))) and bool(torch.all(torch.isfinite(u_f)))
    shapes = (tuple(u_s.shape), tuple(u_f.shape), tuple(nsteps.shape))
    emit({"phase": "main_dense", "problem": f"brusselator N={DENSE_N}", "d": d,
          "correction": "ts1", "rtol": DENSE_RTOL, "nu": 4, "kappa": 20.0, "batch": BATCH,
          "seconds": seconds, "seconds_all": times, "solves_per_sec": BATCH / seconds,
          "mean_steps": float(nsteps[:, -1].double().mean()),
          "gated": "u_filt; u_smooth in f64 on the rows over the lane gate",
          "rmse_over_rtol": rmse / DENSE_RTOL, "worst_lane_over_rtol": worst / DENSE_RTOL,
          "capped_lanes": capped, **smoothed, "launches_per_solve": launches,
          "k5_ms_per_interval": k5_ms, "peak_bytes": peak,
          "check_hbm_budget_estimate_bytes": batched.estimate_solve_bytes(
              BATCH, 5 * d, num_derivatives=4, num_save_at=NUM_SAVE)})
    want_shapes = ((BATCH, NUM_SAVE, d), (BATCH, NUM_SAVE, d), (BATCH, NUM_SAVE))
    if not (ok and smoothed_ok and finite and launches == NUM_SAVE - 1
            and shapes == want_shapes):
        raise AssertionError(f"dense row failed: gates {ok} (rmse {rmse}, worst {worst}, "
                             f"capped {capped}), f64 smoothed {smoothed_ok}, finite {finite}, "
                             f"launches {launches}, {shapes}")
    return {"seconds": seconds, "u_s": u_s, "u_f": u_f, "nsteps": nsteps, "truth": truth,
            "u0s": u0s, "tols": tols}


def _dense_start(loop, interval=0):
    """The row's step, its state at the start of checkpoint interval
    ``interval`` (the driver's own setup and checkpoint loop on K5), that
    interval's end and the inputs."""
    from odecheckpts_torch import batched, batched_dense

    vf, _, params, _ = _dense_problem("brusselator")
    setup = batched_dense.setup_dense(vf, loop["u0s"], params, save_at=_dense_save_at(),
                                      dt0=DENSE_DT0, tols=loop["tols"], correction="ts1")
    state, save_at = setup["state"], setup["save_at"]
    for t in save_at[1 : interval + 1]:
        _, state, _ = batched.advance_checkpoint(
            setup["interval"], setup["step"], state, t, setup["inputs"], strat=setup["strat"],
            max_attempts=MAX_ATTEMPTS)
    t_next = save_at[interval + 1].expand(1, BATCH).contiguous()
    return setup["step"], state, t_next, setup["inputs"]


def phase_interval_dense(device, loop):
    """One interval of K5 against its plain version, plain, kernel, kernel,
    plain: the row's second interval, where the backward conditionals that
    the fixedpoint step accumulates are not zero."""
    import torch

    from odecheckpts_torch import kernels

    step, state, t_next, inputs = _dense_start(loop, interval=1)

    def run(fn):
        return lambda: fn(step, state, t_next, max_attempts=MAX_ATTEMPTS, **inputs)

    times = _time_pair((("plain", run(kernels.step_dense_interval_plain)),
                        ("kernel", run(kernels.step_dense_interval)),
                        ("kernel2", run(kernels.step_dense_interval))))
    alt = kernels.step_dense_geometry("step_dense_interval", 4, True, DENSE_ALT_LANES)
    try:
        alt_times = _time_pair((("alt", run(kernels.step_dense_interval)),
                                ("alt2", run(kernels.step_dense_interval))))
    finally:
        default = kernels.step_dense_geometry("step_dense_interval", 4, True, 0)
    times.update(_time_pair((("plain2", run(kernels.step_dense_interval_plain)),)))
    k_out, p_out = times["kernel"][1], times["plain"][1]
    other = int(torch.sum(k_out[15] != p_out[15]))
    equal = all(bool(torch.equal(a, b)) for a, b in zip(k_out, p_out))
    runs = [times["kernel2"][1], alt_times["alt"][1], alt_times["alt2"][1]]
    repeat = all(bool(torch.equal(a, b)) for out in runs for a, b in zip(out, k_out))
    geometries = [{**g, "kernel_ms": ms} for g, ms in (
        (default, [times["kernel"][0], times["kernel2"][0]]),
        (alt, [alt_times["alt"][0], alt_times["alt2"][0]]))]
    emit({"phase": "interval_dense", "kernel": "K5", "rtol": DENSE_RTOL, "batch": BATCH,
          "kernel_ms": [times["kernel"][0], times["kernel2"][0]],
          "plain_ms": [times["plain"][0], times["plain2"][0]],
          "lanes_with_other_step_counts": other, "arrays_equal": equal,
          "kernel_runs_equal": repeat, "geometries": geometries})
    if other or not equal or not repeat:
        raise AssertionError(f"K5 and its plain version differ over an interval ({other} lanes), "
                             f"or two kernel runs differ ({not repeat})")
    return _timing("step_dense_interval", times, state, 15, nu=4, d=4,
                   run=run(kernels.step_dense_interval))


def phase_attempt_engine_dense(device, loop):
    """``engine="cuda"`` (K5's attempt form under the host loop) against the
    cuda-loop row, then one launch against its plain version."""
    import torch

    from odecheckpts_torch import kernels

    vf, _, params, _ = _dense_problem("brusselator")
    solve = _dense_solver(vf, loop["u0s"], params, loop["tols"], "cuda")
    (secs, (u_s, u_f, nsteps)), counts = _path(["step_dense_attempt"], lambda: _timed(solve))
    ok, rmse, worst, capped = _gates(u_f, nsteps, loop["truth"], DENSE_RTOL, DENSE_RMSE_FACTOR,
                                     DENSE_LANE_FACTOR)
    other = int(torch.sum(torch.any(nsteps != loop["nsteps"], dim=1)))
    same = bool(torch.equal(u_s, loop["u_s"])) and bool(torch.equal(u_f, loop["u_f"]))
    emit({"phase": "attempt_engine_dense", "kernel": "K5", "batch": BATCH, "seconds": secs,
          "loop_engine_seconds": loop["seconds"], "launches": counts["step_dense_attempt"],
          "rmse_over_rtol": rmse / DENSE_RTOL, "worst_lane_over_rtol": worst / DENSE_RTOL,
          "capped_lanes": capped, "lanes_with_other_step_counts": other,
          "outputs_equal_loop_engine": same})
    if not (ok and other == 0 and same):
        raise AssertionError(f"K5 attempt engine: gates {ok}, {other} lanes with other step "
                             f"counts, outputs equal {same}")

    step, state, t_next, inputs = _dense_start(loop)
    times = _time_pair((
        ("plain", lambda: kernels.step_dense_attempt_plain(step, state, t_next, **inputs)),
        ("kernel", lambda: kernels.step_dense_attempt(step, state, t_next, **inputs)),
        ("kernel2", lambda: kernels.step_dense_attempt(step, state, t_next, **inputs)),
        ("plain2", lambda: kernels.step_dense_attempt_plain(step, state, t_next, **inputs)),
    ))
    dev = max(float(torch.max(torch.abs(a - b)))
              for a, b in zip(times["kernel"][1], times["plain"][1]))
    repeat = all(bool(torch.equal(a, b)) for a, b in zip(times["kernel"][1], times["kernel2"][1]))
    emit({"phase": "one_launch", "kernel": "K5", "form": "step_dense_attempt", "batch": BATCH,
          "kernel_ms": [times["kernel"][0], times["kernel2"][0]],
          "plain_ms": [times["plain"][0], times["plain2"][0]], "max_abs_dev": dev,
          "kernel_runs_equal": repeat})
    if dev != 0.0 or not repeat:
        raise AssertionError(
            f"one launch of K5's attempt form differs from its plain version by {dev}, or two "
            f"launches differ ({not repeat})")
    return counts, _timing("step_dense_attempt", times, state, 15, nu=4, d=4,
                           run=lambda: kernels.step_dense_attempt(step, state, t_next, **inputs))


def _bd_problem(name):
    from odecheckpts_torch import problems

    if name == "anisotropic":
        vf, (y0,), _, params = problems.rigid_body_anisotropic(time_span=TSPAN, scale=BD_SCALE)
        return vf, y0, params, BD_DT0
    vf, (y0,), _, params = problems.rigid_body(time_span=TSPAN)
    return vf, y0, params, DT0


def _bd_ensemble(y0, batch, torch, device):
    rng = np.random.default_rng(SEED)
    rows = y0.numpy()[None] * (1.0 + 0.05 * rng.standard_normal((batch, 3)))
    return torch.tensor(rows.astype(np.float32), device=device)


def _equal_arrays(name, got, want, where, torch):
    """Largest deviation over the 17 arrays; fails unless every array is
    equal (NaNs in the same places count as equal)."""
    devs = [float(torch.max(torch.nan_to_num(torch.abs(g - w), nan=0.0)))
            for g, w in zip(got, want)]
    bad = [n for n, g, w in zip(STATE_NAMES, got, want)
           if not torch.equal(torch.nan_to_num(g, nan=0.0), torch.nan_to_num(w, nan=0.0))
           or not torch.equal(torch.isnan(g), torch.isnan(w))]
    if bad:
        raise AssertionError(f"{name} and its twin differ ({where}) in {bad}")
    return max(devs)


def phase_attempt_bd(device):
    """One attempt of K6 in both forms against the blockdiag twin: every
    array equal, both functors, nu = 2, 3, 4; returns the largest deviation
    of each form."""
    import torch

    from odecheckpts_torch import batched_blockdiag, kernels

    worst = {"step_bd_interval": 0.0, "step_bd_attempt": 0.0}
    save_at = _save_at()
    tols = torch.tensor(np.geomspace(1e-2, 1e-6, ATTEMPT_LANES), dtype=torch.float32,
                        device=device)
    t_next = torch.full((1, ATTEMPT_LANES), float(save_at[1]), device=device)
    for problem in ("anisotropic", "rigid_body"):
        vf, y0, params, dt0 = _bd_problem(problem)
        u0s = _bd_ensemble(y0, ATTEMPT_LANES, torch, device)
        for nu in (2, 3, 4):
            state, _, inputs = batched_blockdiag.initial_state(
                vf, u0s, params, save_at=save_at, dt0=dt0, tols=tols, num_derivatives=nu)
            step = batched_blockdiag.make_step_bd(vf, params, nu=nu, d=3)
            mid = state
            for _ in range(BD_MID_ATTEMPTS):
                mid = kernels.attempt_plain(step, mid, t_next, **inputs)
            mid = _random_backward(mid, torch)
            for label, start in (("init", state), ("mid", mid)):
                want = kernels.attempt_plain(step, start, t_next, **inputs)
                for name, got in (
                    ("step_bd_interval", kernels.step_bd_interval(
                        step, start, t_next, max_attempts=1, **inputs)),
                    ("step_bd_attempt", kernels.step_bd_attempt(step, start, t_next, **inputs)),
                ):
                    torch.cuda.synchronize()
                    dev = _equal_arrays(name, got, want, f"{problem}, nu={nu}, {label}", torch)
                    worst[name] = max(worst[name], dev)
                    emit({"phase": "attempt_bd", "kernel": "K6", "form": name,
                          "problem": problem, "nu": nu, "state": label,
                          "accepted": int(torch.sum(want[0] != start[0])),
                          "max_abs_dev": dev, "arrays_equal": True})
    return worst


def _truth_anisotropic(rows, save_at):
    """Per-lane scipy LSODA reference of the rescaled rigid body at the
    checkpoints (experiments/6_tpu_batched_sweep/blockdiag_tpu.py:56-74)."""
    import scipy.integrate

    p1, p2, p3 = -2.0, 1.25, -0.5
    scale = np.array(BD_SCALE)

    def vf_np(_t, z):
        y = z / scale
        return scale * np.array([p1 * y[1] * y[2], p2 * y[0] * y[2], p3 * y[0] * y[1]])

    out = []
    for row in rows:
        sol = scipy.integrate.solve_ivp(
            vf_np, (float(save_at[0]), float(save_at[-1])), row, t_eval=save_at,
            rtol=1e-12, atol=1e-10, method="LSODA",
        )
        out.append(sol.y.T)
    return np.stack(out)


def _bd_solver(vf, u0s, params, tols, engine, implementation="blockdiag"):
    from odecheckpts_torch import batched

    save_at = _save_at()

    def solve():
        return batched.solve_save_at_batched(
            vf, u0s, params, save_at=save_at, dt0=BD_DT0, tols=tols,
            implementation=implementation, engine=engine, max_attempts=MAX_ATTEMPTS,
        )

    return solve


def _bd_gates(u, nsteps, truth, torch):
    """The row's gates on errors relative to each component's scale."""
    scale = torch.tensor(BD_SCALE, dtype=u.dtype, device=u.device)
    return _gates(u / scale, nsteps, truth / np.array(BD_SCALE), BD_TOL, BD_RMSE_FACTOR,
                  BD_LANE_FACTOR)


def phase_main_bd(device):
    """The anisotropic rigid-body row on K6's interval form."""
    import torch

    from odecheckpts_torch import batched, kernels

    vf, y0, params, _ = _bd_problem("anisotropic")
    u0s = _bd_ensemble(y0, BATCH, torch, device)
    t0 = time.perf_counter()
    truth = _truth_anisotropic(u0s[:SAMPLE].double().cpu().numpy(), _save_at().astype(np.float64))
    emit({"phase": "truth_bd", "lanes": SAMPLE, "seconds": time.perf_counter() - t0})
    tols = torch.full((BATCH,), BD_TOL, dtype=torch.float32, device=device)
    solve = _bd_solver(vf, u0s, params, tols, "cuda-loop")
    solve()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    times, launches = [], set()
    for _ in range(REPEATS):
        before = kernels.LAUNCHES["step_bd_interval"]
        secs, (u_s, u_f, nsteps) = _timed(solve)
        launches.add(kernels.LAUNCHES["step_bd_interval"] - before)
        times.append(secs)
    peak = torch.cuda.max_memory_allocated(device)
    launches = launches.pop() if len(launches) == 1 else sorted(launches)
    seconds = float(np.median(times))
    k6_ms = _kernel_share(solve, "step_bd_interval")
    ok, rmse, worst, capped = _bd_gates(u_s, nsteps, truth, torch)
    _, rmse_f, worst_f, _ = _bd_gates(u_f, nsteps, truth, torch)
    finite = bool(torch.all(torch.isfinite(u_s))) and bool(torch.all(torch.isfinite(u_f)))
    shapes = (tuple(u_s.shape), tuple(u_f.shape), tuple(nsteps.shape))
    emit({"phase": "main_bd", "problem": f"rigid body x {BD_SCALE}", "d": 3,
          "implementation": "blockdiag", "tol": BD_TOL, "nu": 4, "kappa": 10.0, "batch": BATCH,
          "seconds": seconds, "seconds_all": times, "solves_per_sec": BATCH / seconds,
          "mean_steps": float(nsteps[:, -1].double().mean()), "gated": "u_smooth / scale",
          "rmse_over_tol": rmse / BD_TOL, "worst_lane_over_tol": worst / BD_TOL,
          "filtered_rmse_over_tol": rmse_f / BD_TOL,
          "filtered_worst_lane_over_tol": worst_f / BD_TOL, "capped_lanes": capped,
          "launches_per_solve": launches, "k6_ms_per_interval": k6_ms, "peak_bytes": peak,
          "check_hbm_budget_estimate_bytes": batched.estimate_solve_bytes(
              BATCH, 5 * 3, num_derivatives=4, num_save_at=NUM_SAVE)})
    want_shapes = ((BATCH, NUM_SAVE, 3), (BATCH, NUM_SAVE, 3), (BATCH, NUM_SAVE))
    if not (ok and finite and launches == NUM_SAVE - 1 and shapes == want_shapes):
        raise AssertionError(f"blockdiag row failed: gates {ok} (rmse {rmse}, worst {worst}, "
                             f"capped {capped}), finite {finite}, launches {launches}, {shapes}")
    return {"seconds": seconds, "u_s": u_s, "u_f": u_f, "nsteps": nsteps, "truth": truth,
            "u0s": u0s, "tols": tols}


def phase_foil_bd(device, loop):
    """The blockdiag row's ensemble on the isotropic engine, once: reported,
    not gated (one shared output scale misfits the third component)."""
    import torch

    vf, _, params, _ = _bd_problem("anisotropic")
    solve = _bd_solver(vf, loop["u0s"], params, loop["tols"], "cuda-loop", "isotropic")
    secs, (u_s, _u_f, nsteps) = _timed(solve)
    _, rmse, worst, capped = _bd_gates(u_s, nsteps, loop["truth"], torch)
    steps = float(nsteps[:, -1].double().mean())
    bd_steps = float(loop["nsteps"][:, -1].double().mean())
    emit({"phase": "foil_bd", "implementation": "isotropic", "kernel": "K1", "batch": BATCH,
          "seconds": secs, "blockdiag_seconds": loop["seconds"], "mean_steps": steps,
          "blockdiag_mean_steps": bd_steps, "step_ratio": steps / bd_steps,
          "rmse_over_tol": rmse / BD_TOL, "worst_lane_over_tol": worst / BD_TOL,
          "capped_lanes": capped})


def _bd_start(loop, interval=0):
    """The row's step, its state at the start of checkpoint interval
    ``interval`` (the driver's own setup and checkpoint loop on K6), that
    interval's end and the inputs."""
    from odecheckpts_torch import batched, batched_blockdiag

    vf, _, params, _ = _bd_problem("anisotropic")
    setup = batched_blockdiag.setup_blockdiag(vf, loop["u0s"], params, save_at=_save_at(),
                                              dt0=BD_DT0, tols=loop["tols"])
    state, save_at = setup["state"], setup["save_at"]
    for t in save_at[1 : interval + 1]:
        _, state, _ = batched.advance_checkpoint(
            setup["interval"], setup["step"], state, t, setup["inputs"], strat=setup["strat"],
            max_attempts=MAX_ATTEMPTS, convert=batched_blockdiag.CONVERT)
    t_next = save_at[interval + 1].expand(1, BATCH).contiguous()
    return setup["step"], state, t_next, setup["inputs"]


def phase_interval_bd(device, loop):
    """One interval of K6 against its plain version, plain, kernel, kernel,
    plain: the row's second interval, where the accumulated backward
    conditionals are not zero."""
    import torch

    from odecheckpts_torch import kernels

    step, state, t_next, inputs = _bd_start(loop, interval=1)

    def run(fn):
        return lambda: fn(step, state, t_next, max_attempts=MAX_ATTEMPTS, **inputs)

    times = _time_pair((("plain", run(kernels.step_bd_interval_plain)),
                        ("kernel", run(kernels.step_bd_interval)),
                        ("kernel2", run(kernels.step_bd_interval)),
                        ("plain2", run(kernels.step_bd_interval_plain))))
    k_out, p_out = times["kernel"][1], times["plain"][1]
    other = int(torch.sum(k_out[15] != p_out[15]))
    equal = all(bool(torch.equal(a, b)) for a, b in zip(k_out, p_out))
    repeat = _runs_equal(times, k_out, torch)
    emit({"phase": "interval_bd", "kernel": "K6", "tol": BD_TOL, "batch": BATCH,
          "kernel_ms": [times["kernel"][0], times["kernel2"][0]],
          "plain_ms": [times["plain"][0], times["plain2"][0]],
          "lanes_with_other_step_counts": other, "arrays_equal": equal,
          "kernel_runs_equal": repeat})
    if other or not equal or not repeat:
        raise AssertionError(f"K6 and its plain version differ over an interval ({other} lanes), "
                             f"or two kernel runs differ ({not repeat})")
    return _timing("step_bd_interval", times, state, 15, nu=4, d=3,
                   run=run(kernels.step_bd_interval))


def _runs_equal(times, k_out, torch):
    """Whether the kernel's second run in ``times`` equals its first bit for
    bit (NaN where the first has NaN)."""
    return all(_same_bits(a, b, torch) for a, b in zip(times["kernel2"][1], k_out))


def phase_attempt_engine_bd(device, loop):
    """``engine="cuda"`` (K6's attempt form under the host loop) against the
    cuda-loop row, then one launch against its plain version."""
    import torch

    from odecheckpts_torch import kernels

    vf, _, params, _ = _bd_problem("anisotropic")
    solve = _bd_solver(vf, loop["u0s"], params, loop["tols"], "cuda")
    (secs, (u_s, u_f, nsteps)), counts = _path(["step_bd_attempt"], lambda: _timed(solve))
    ok, rmse, worst, capped = _bd_gates(u_s, nsteps, loop["truth"], torch)
    other = int(torch.sum(torch.any(nsteps != loop["nsteps"], dim=1)))
    same = bool(torch.equal(u_s, loop["u_s"])) and bool(torch.equal(u_f, loop["u_f"]))
    emit({"phase": "attempt_engine_bd", "kernel": "K6", "batch": BATCH, "seconds": secs,
          "loop_engine_seconds": loop["seconds"], "launches": counts["step_bd_attempt"],
          "rmse_over_tol": rmse / BD_TOL, "worst_lane_over_tol": worst / BD_TOL,
          "capped_lanes": capped, "lanes_with_other_step_counts": other,
          "outputs_equal_loop_engine": same})
    if not (ok and other == 0 and same):
        raise AssertionError(f"K6 attempt engine: gates {ok}, {other} lanes with other step "
                             f"counts, outputs equal {same}")

    step, state, t_next, inputs = _bd_start(loop)

    def kernel():
        return kernels.step_bd_attempt(step, state, t_next, **inputs)

    times = _time_pair((
        ("plain", lambda: kernels.step_bd_attempt_plain(step, state, t_next, **inputs)),
        ("kernel", kernel), ("kernel2", kernel),
        ("plain2", lambda: kernels.step_bd_attempt_plain(step, state, t_next, **inputs))))
    dev = max(float(torch.max(torch.abs(a - b)))
              for a, b in zip(times["kernel"][1], times["plain"][1]))
    repeat = _runs_equal(times, times["kernel"][1], torch)
    emit({"phase": "one_launch", "kernel": "K6", "form": "step_bd_attempt", "batch": BATCH,
          "kernel_ms": [times["kernel"][0], times["kernel2"][0]],
          "plain_ms": [times["plain"][0], times["plain2"][0]], "max_abs_dev": dev,
          "kernel_runs_equal": repeat})
    if dev != 0.0 or not repeat:
        raise AssertionError(
            f"one launch of K6's attempt form differs from its plain version by {dev}, or two "
            f"launches differ ({not repeat})")
    caps = {cap: _device_time("step_bd_interval", lambda cap=cap: kernels.step_bd_interval(
                step, state, t_next, **inputs, max_attempts=cap))["device_ms"] for cap in BD_CAPS}
    per_attempt = (caps[BD_CAPS[-1]] - caps[BD_CAPS[0]]) / (BD_CAPS[-1] - BD_CAPS[0])
    emit({"phase": "launch_cost_bd", "kernel": "K6", "batch": BATCH,
          "interval_ms_by_cap": caps, "per_attempt_ms": per_attempt,
          "fixed_ms": caps[BD_CAPS[0]] - BD_CAPS[0] * per_attempt})
    return counts, _timing("step_bd_attempt", times, state, 15, nu=4, d=3, run=kernel)


def phase_attempt_everystep(device):
    """One attempt of K7 against ``StepLL`` with the smoother and the filter
    strategy: every array equal, nu = 2, 3, 4, initial and mid-solve state;
    returns the largest deviation."""
    import torch

    from odecheckpts_torch import batched, kernels, problems

    vf, _, _, params = problems.rigid_body(time_span=ES_TSPAN)
    u0s = _ensemble(ATTEMPT_LANES, torch, device)
    tols = torch.tensor(np.geomspace(1e-1, 1e-5, ATTEMPT_LANES), dtype=torch.float32,
                        device=device)
    t1 = torch.full((1, ATTEMPT_LANES), ES_TSPAN[1], device=device)
    worst = 0.0
    for strategy in ("smoother", "filter"):
        for nu in (2, 3, 4):
            state, _, inputs = batched.initial_state(
                vf, u0s, params, save_at=np.array(ES_TSPAN, np.float32), dt0=DT0, tols=tols,
                num_derivatives=nu, strategy=strategy)
            step = batched.make_step_ll(vf, params, nu=nu, d=3, strategy=strategy)
            mid = state
            for _ in range(MID_ATTEMPTS):
                mid = kernels.attempt_plain(step, mid, t1, **inputs)
            mid = tuple(x.contiguous() for x in mid)  # the twin's gains are transposed views
            for label, start in (("init", state), ("mid", mid)):
                want = kernels.attempt_plain(step, start, t1, **inputs)
                got = kernels.step_everystep_attempt(step, start, t1, **inputs)
                torch.cuda.synchronize()
                dev = _equal_arrays("step_everystep_attempt", got, want,
                                    f"{strategy}, nu={nu}, {label}", torch)
                worst = max(worst, dev)
                emit({"phase": "attempt_everystep", "kernel": "K7", "strategy": strategy,
                      "nu": nu, "state": label,
                      "accepted": int(torch.sum(want[0] != start[0])), "max_abs_dev": dev,
                      "arrays_equal": True})
    return {"step_everystep_attempt": worst}


def _truth_at(row, times):
    """scipy LSODA(1e-12) reference of one rigid-body lane at ``times``."""
    import scipy.integrate

    p1, p2, p3 = -2.0, 1.25, -0.5
    sol = scipy.integrate.solve_ivp(
        lambda _t, y: [p1 * y[1] * y[2], p2 * y[0] * y[2], p3 * y[0] * y[1]],
        (ES_TSPAN[0], ES_TSPAN[1]), row, t_eval=times, rtol=1e-12, atol=1e-12, method="LSODA")
    return sol.y.T


def _everystep_split(solve):
    """CUDA-event times (ms) of one more solve, split at the call of
    ``_interpolate_at``: the attempts with their emission before it, the
    interpolation, output stacks and backward sweep after it."""
    import torch

    from odecheckpts_torch import batched_everystep

    real = batched_everystep._interpolate_at
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def marked(*args, **kwargs):
        marks[1].record()
        return real(*args, **kwargs)

    batched_everystep._interpolate_at = marked
    try:
        marks[0].record()
        solve()
        marks[2].record()
    finally:
        batched_everystep._interpolate_at = real
    torch.cuda.synchronize()
    return marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])


def phase_main_everystep(device):
    """The save-every-step row on K7."""
    import torch

    from odecheckpts_torch import batched, batched_everystep, kernels, problems

    vf, _, _, params = problems.rigid_body(time_span=ES_TSPAN)
    u0s = _ensemble(BATCH, torch, device)
    tols = torch.full((BATCH,), ES_TOL, dtype=torch.float32, device=device)

    def solver(engine):
        return lambda: batched_everystep.solve_every_step_batched(
            vf, u0s, params, t0=ES_TSPAN[0], t1=ES_TSPAN[1], dt0=DT0, tols=tols,
            max_steps=ES_MAX_STEPS, strategy="smoother", engine=engine)

    solve = solver("cuda")
    solve()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    times, launches = [], set()
    for _ in range(REPEATS):
        before = kernels.LAUNCHES["step_everystep_attempt"]
        secs, sol = _timed(solve)
        launches.add(kernels.LAUNCHES["step_everystep_attempt"] - before)
        times.append(secs)
    peak = torch.cuda.max_memory_allocated(device)
    launches = launches.pop() if len(launches) == 1 else sorted(launches)
    seconds = float(np.median(times))
    attempts_ms, sweep_ms = _everystep_split(solve)

    twin_secs, twin = _timed(solver("torch"))
    same = {f: bool(torch.equal(getattr(sol, f), getattr(twin, f))) for f in sol._fields}
    del twin
    finite = bool(torch.all(torch.isfinite(sol.marginal_u[sol.valid])))
    # every slot holds its lane's time after that attempt, so the largest is the last
    short = int(torch.sum(sol.t.max(dim=1).values < ES_TSPAN[1]))
    save_at = np.linspace(ES_TSPAN[0], ES_TSPAN[1], NUM_SAVE).astype(np.float32)
    _, _, ns = batched.solve_save_at_batched(vf, u0s, params, save_at=save_at, dt0=DT0,
                                             tols=tols, engine="cuda-loop",
                                             max_attempts=MAX_ATTEMPTS)
    other_steps = int(torch.sum(ns[:, -1] != sol.num_steps))

    # accuracy on the sampled lanes: the terminal value, and the smoothed and
    # filtered means at each lane's valid slots
    t0 = time.perf_counter()
    rows = u0s[:SAMPLE].double().cpu().numpy()
    e_t1, e_s, e_f = [], [], []
    for lane in range(SAMPLE):
        c = batched_everystep.compact(sol, lane)
        ref = _truth_at(rows[lane], np.append(c["t"].astype(np.float64), ES_TSPAN[1]))
        e_t1.append(np.sqrt(np.mean((sol.u_t1[lane].double().cpu().numpy() - ref[-1]) ** 2)))
        e_s.append(np.sqrt(np.mean((c["marginal_u"] - ref[:-1]) ** 2)))
        e_f.append(np.sqrt(np.mean((c["u"] - ref[:-1]) ** 2)))
    rms = lambda e: float(np.sqrt(np.mean(np.square(e))))  # noqa: E731
    truth_secs = time.perf_counter() - t0
    emit({"phase": "main_everystep", "strategy": "smoother", "tol": ES_TOL, "nu": 4,
          "max_steps": ES_MAX_STEPS, "batch": BATCH, "seconds": seconds, "seconds_all": times,
          "solves_per_sec": BATCH / seconds, "attempts_and_emission_ms": attempts_ms,
          "interpolation_outputs_and_backward_sweep_ms": sweep_ms,
          "twin_engine_seconds": twin_secs, "outputs_equal_twin_engine": same,
          "launches_per_solve": launches,
          "mean_steps": float(sol.num_steps.double().mean()),
          "mean_valid_slots": float(sol.valid.sum(dim=1).double().mean()),
          "lanes_short_of_t1": short, "smoothed_finite_at_valid_slots": finite,
          "lanes_with_other_step_counts_than_save_at": other_steps,
          "u_t1_rmse_over_tol": rms(e_t1) / ES_TOL,
          "u_t1_worst_lane_over_tol": max(e_t1) / ES_TOL,
          "smoothed_rmse_over_tol": rms(e_s) / ES_TOL,
          "smoothed_worst_lane_over_tol": max(e_s) / ES_TOL,
          "filtered_rmse_over_tol": rms(e_f) / ES_TOL, "truth_seconds": truth_secs,
          "peak_bytes": peak,
          "check_hbm_budget_estimate_bytes": batched.estimate_solve_bytes(
              BATCH, 3, num_derivatives=4, num_save_at=ES_MAX_STEPS + 1)})
    ok = (launches == ES_MAX_STEPS and all(same.values()) and finite and short == 0
          and other_steps == 0 and rms(e_t1) < RMSE_FACTOR * ES_TOL
          and max(e_t1) < LANE_FACTOR * ES_TOL and rms(e_s) < ES_SMOOTHED_FACTOR * ES_TOL)
    if not ok:
        raise AssertionError("save-every-step row failed one of its gates (see the line above)")
    return {"u0s": u0s, "tols": tols}


def phase_launch_everystep(device, row):
    """One launch of K7 against its plain version, from the row's initial
    state, timed."""
    import torch

    from odecheckpts_torch import batched, kernels, problems

    vf, _, _, params = problems.rigid_body(time_span=ES_TSPAN)
    u0s, tols = row["u0s"], row["tols"]
    state, _, inputs = batched.initial_state(
        vf, u0s, params, save_at=np.array(ES_TSPAN, np.float32), dt0=DT0, tols=tols,
        strategy="smoother")
    step = batched.make_step_ll(vf, params, nu=4, d=3, strategy="smoother")
    t1 = torch.full((1, BATCH), ES_TSPAN[1], device=device)
    times = _time_pair((
        ("plain", lambda: kernels.step_everystep_attempt_plain(step, state, t1, **inputs)),
        ("kernel", lambda: kernels.step_everystep_attempt(step, state, t1, **inputs)),
        ("kernel2", lambda: kernels.step_everystep_attempt(step, state, t1, **inputs)),
        ("plain2", lambda: kernels.step_everystep_attempt_plain(step, state, t1, **inputs)),
    ))
    dev = max(float(torch.max(torch.abs(a - b)))
              for a, b in zip(times["kernel"][1], times["plain"][1]))
    emit({"phase": "one_launch", "kernel": "K7", "form": "step_everystep_attempt",
          "batch": BATCH, "kernel_ms": [times["kernel"][0], times["kernel2"][0]],
          "plain_ms": [times["plain"][0], times["plain2"][0]], "max_abs_dev": dev})
    if dev != 0.0:
        raise AssertionError(f"one launch of K7 differs from its plain version by {dev}")
    return _timing("step_everystep_attempt", times, state, 15, nu=4, d=3,
                   run=lambda: kernels.step_everystep_attempt(step, state, t1, **inputs))


def _combine_flops(m, c):
    """Operations of one sqrt combine (``pit_fused.combine_sqrt_ll``): eight
    (m, m, m) and twelve (m, m, c) products at 2 per multiply-add, four
    (2m, m) QRs, one Gram solve with m and two with c right-hand sides
    (2 m^2 each), two right solves (m^3 each); the additions of the results
    are left out, so this is a lower count."""
    return (16 * m**3 + 24 * m * m * c + 4 * _qr_flops(2 * m, m, m) + 2 * m**3 + 4 * m * m * c
            + 2 * m**3)


def _max_dev(got, want, torch):
    return max(float(torch.max(torch.abs(g - w))) if g.numel() else 0.0
               for g, w in zip(got, want))


def _pit_problem(dtype, device, num_points=PIT_T):
    """The crossover workload: vf, init in ``dtype`` on ``device``, solver and
    the uniform grid's first ``num_points`` points (numpy float64)."""
    import torch

    from odecheckpts_torch import ivpsolvers, problems, taylor
    from odecheckpts_torch.ssm.base import Normal

    vf_p, u0s, _, params = problems.rigid_body(time_span=PIT_TSPAN)

    def vf(u, *, t):
        return vf_p(u, t=t, p=params)

    prior = ivpsolvers.prior_ibm(num_derivatives=PIT_NU, ode_shape=(3,))
    solver = ivpsolvers.solver_dynamic(
        ivpsolvers.strategy_filter(prior, ivpsolvers.correction_ts0()))
    tcoeffs = taylor.odejet_padded_scan(lambda u: vf(u, t=PIT_TSPAN[0]), u0s, num=PIT_NU)
    rv, scale = solver.initial_condition(tcoeffs, 1.0)
    init = (Normal(rv.mean.to(device=device, dtype=dtype),
                   rv.cholesky.to(device=device, dtype=dtype)),
            scale.to(device=device, dtype=dtype))
    grid = np.linspace(PIT_TSPAN[0], PIT_TSPAN[1], PIT_T)[:num_points]
    return vf, init, solver, torch.tensor(grid, dtype=dtype, device=device)


def _capture_second_window(device, dtype, prefix=""):
    """The element pairs that K8 is given on the first and on the last level
    of the final sweep of the main row's second window, from a solve of the
    row's first two windows in ``dtype``; each a pair of 5-tuples at m = 4,
    c = 3, P = 1024, keyed ``prefix`` + "first_level" and "last_level"."""
    import torch

    from odecheckpts_torch import ivpsolve, kernels

    vf, init, solver, grid = _pit_problem(dtype, device, 2 * 1024 + 1)
    calls, launch = [], kernels.pit_combine  # the gate off: no window is solved twice

    def recording(e_i, e_j):
        calls.append((e_i, e_j))
        return launch(e_i, e_j)

    kernels.pit_combine = recording
    try:
        ivpsolve.solve_fixed_grid(vf, init, grid=grid, solver=solver, window=1024,
                                  combine_engine="cuda", fallback_rtol=None, **PIT_KW)
    finally:
        kernels.pit_combine = launch
    torch.cuda.synchronize()
    levels = 10  # log2(1024); two sweeps a window
    if len(calls) != 2 * 2 * levels:
        raise AssertionError(f"two windows of two sweeps launch K8 {4 * levels} times, "
                             f"saw {len(calls)}")
    return {f"{prefix}first_level": calls[3 * levels],
            f"{prefix}last_level": calls[4 * levels - 1]}


def phase_combine_pit(device, captured):
    """K8 against its plain version: every built size, both types, a full
    and a ragged width, and the captured pairs of the main row."""
    import torch

    from odecheckpts_torch import kernels

    rng = np.random.default_rng(SEED)
    cases = [(f"{'f32' if dt == torch.float32 else 'f64'}/{m}/{c}/{p}", dt, m, c, p)
             for dt in (torch.float32, torch.float64) for m in kernels.PIT_COMBINE_M
             for c in kernels.PIT_COMBINE_C for p in (1024, 1000)]
    devs = {}
    for label, dt, m, c, p in cases:
        shapes = ((m, m, p), (m, c, p), (m, m, p), (m, c, p), (m, m, p))
        e_i, e_j = (tuple(torch.tensor(rng.standard_normal(s), dtype=dt, device=device)
                          for s in shapes) for _ in range(2))
        devs[label] = _max_dev(kernels.pit_combine(e_i, e_j),
                               kernels.pit_combine_plain(e_i, e_j), torch)
    for label, (e_i, e_j) in captured.items():
        devs[f"main_row/{label}"] = _max_dev(kernels.pit_combine(e_i, e_j),
                                             kernels.pit_combine_plain(e_i, e_j), torch)
    torch.cuda.synchronize()
    worst = max(devs.values())
    failed = [k for k, v in devs.items() if not v == 0.0]
    emit({"phase": "combine_pit", "kernel": "K8", "cases": len(devs), "max_abs_dev": worst,
          "nonzero": {k: devs[k] for k in failed}})
    if failed:
        raise AssertionError(f"K8 differs from its plain version in {failed}")
    return {"pit_combine": worst}


def _pit_outputs(sol):
    return (sol.u, sol.u_std, sol.output_scale, sol.posterior.init.mean,
            sol.posterior.init.cholesky)


def phase_main_pit(device):
    """The fixed-grid rows: sequential, and parallel in time on K8."""
    import scipy.integrate
    import torch

    from odecheckpts_torch import ivpsolve, kernels

    vf, init, solver, grid = _pit_problem(torch.float32, device)
    p1, p2, p3 = -2.0, 1.25, -0.5
    t_eval = grid.double().cpu().numpy()
    truth = scipy.integrate.solve_ivp(
        lambda _t, y: [p1 * y[1] * y[2], p2 * y[0] * y[2], p3 * y[0] * y[1]],
        (t_eval[0], t_eval[-1]), [1.0, 0.0, 0.9], t_eval=t_eval, rtol=1e-12, atol=1e-12,
        method="LSODA").y.T

    ivpsolve.solve_fixed_grid(vf, init, grid=grid[:PIT_SEQ_WARM_T], solver=solver)  # warm-up
    t_seq, seq = _timed(lambda: ivpsolve.solve_fixed_grid(vf, init, grid=grid, solver=solver))
    u_seq = seq.u.double()
    err_truth = float(np.max(np.abs(u_seq.cpu().numpy() - truth)))
    seq_ok = (bool(torch.all(torch.isfinite(seq.u))) and tuple(seq.u.shape) == (PIT_T, 3)
              and err_truth < PIT_LSODA_BOUND)
    emit({"phase": "main_pit", "row": "sequential", "dtype": "float32", "T": PIT_T,
          "seconds": t_seq, "max_abs_err_vs_lsoda": err_truth, "bound": PIT_LSODA_BOUND,
          "steps_per_sec": (PIT_T - 1) / t_seq})
    failed = [] if seq_ok else [("sequential", err_truth)]

    def parallel(window, engine, grid_=grid, init_=init, fallback_rtol=1.0):
        return ivpsolve.solve_fixed_grid(vf, init_, grid=grid_, solver=solver, window=window,
                                         combine_engine=engine, fallback_rtol=fallback_rtol,
                                         return_diagnostics=True, **PIT_KW)

    outs = {}
    for window, engine, cut in PIT_ROWS:
        num = PIT_T if cut is None else cut * window + 1  # the sequential filter is causal
        u_ref, share = u_seq[:num], (num - 1) / (PIT_T - 1)
        # warm-up: the first two windows, the gate off (the fallback's steps are
        # the sequential row's, warm already)
        parallel(window, engine, grid[: 2 * window + 1], fallback_rtol=None)
        before = kernels.LAUNCHES["pit_combine"]
        seconds, (sol, diag) = _timed(lambda: parallel(window, engine, grid[:num]))
        launches = kernels.LAUNCHES["pit_combine"] - before
        rel = float(torch.max(torch.abs(sol.u.double() - u_ref)) / torch.max(torch.abs(u_ref)))
        diverged = int(torch.sum(diag["window_diverged"]))
        finite = all(bool(torch.all(torch.isfinite(x))) for x in _pit_outputs(sol))
        fallback_row = diverged == diag["num_windows"]
        err = float(np.max(np.abs(sol.u.double().cpu().numpy() - truth[:num])))
        emit({"phase": "main_pit", "row": "parallel", "dtype": "float32", "T": num,
              "window": window, "combine_engine": engine, "seconds": seconds,
              "sequential_seconds": t_seq * share, "speedup_vs_seq": t_seq * share / seconds,
              "rel_vs_seq": rel, "window_diverged": diverged,
              "num_windows": diag["num_windows"],
              "window_delta_max": float(torch.max(diag["window_delta"])),
              "all_windows_finite": bool(torch.all(diag["window_finite"])),
              "fallback_row": fallback_row, "k8_launches_per_solve": launches,
              "max_abs_err_vs_lsoda": err})
        outs[(window, engine, cut)] = sol
        sweeps_levels = 2 * diag["num_windows"] * (window.bit_length() - 1)
        ok = finite and rel <= PIT_REL_GATE and tuple(sol.u.shape) == (num, 3)
        if engine == "cuda":
            ok = ok and not fallback_row and launches == sweeps_levels
        else:
            ok = ok and launches == 0
        if not ok:
            failed.append((window, engine, cut, rel, finite, launches, fallback_row))
    # "cuda" against "ll": four windows with the gate off, where every window's
    # answer is the prefix' own (gated); and the full row's first points against
    # the cut "ll" row (reported: warm start and filter are causal, but the two
    # solves batch the warm start's products over grids of other lengths)
    names = ("u", "u_std", "output_scale", "mean", "cholesky")
    num, ll_row = 4 * 1024 + 1, outs[(1024, "ll", 2)]
    ungated = [_pit_outputs(parallel(1024, e, grid[:num], fallback_rtol=None)[0])
               for e in ("cuda", "ll")]
    same = {
        "rows": {n: bool(torch.equal(a[:b.shape[0]], b)) for n, a, b in zip(
            names, _pit_outputs(outs[(1024, "cuda", None)]), _pit_outputs(ll_row))},
        "gate_off": {n: bool(torch.all((a == b) | (torch.isnan(a) & torch.isnan(b))))
                     for n, a, b in zip(names, *ungated)},
    }
    emit({"phase": "main_pit", "check": "cuda_equals_ll", "window": 1024, "points": num,
          "equal": same,
          "gate_off_finite": bool(all(torch.all(torch.isfinite(x)) for x in ungated[0]))})
    if not all(same["gate_off"].values()):
        failed.append(("cuda != ll", same))

    # where a "cuda" solve's time goes: the warm start alone, and two windows
    # of sweeps with the gate off (no fallback, no host read)
    from odecheckpts_torch import parallel_time

    t_warm, _ = _timed(lambda: parallel_time._warmstart_rk(
        vf, solver.ssm, init[0].mean, grid, 1, PIT_NU, stride=16, method="rk4"))
    two = grid[: 2 * 1024 + 1]
    t_two, _ = _timed(lambda: ivpsolve.solve_fixed_grid(
        vf, init, grid=two, solver=solver, window=1024, combine_engine="cuda",
        fallback_rtol=None, **PIT_KW))
    t_two_warm, _ = _timed(lambda: parallel_time._warmstart_rk(
        vf, solver.ssm, init[0].mean, two, 1, PIT_NU, stride=16, method="rk4"))
    emit({"phase": "main_pit", "split": "cuda, window 1024", "warmstart_seconds": t_warm,
          "sweeps_seconds_per_window": (t_two - t_two_warm) / 2,
          "sequential_seconds_per_window": t_seq * 1024 / (PIT_T - 1)})

    # the double instantiation on the path: the first PIT_F64_WINDOWS windows
    num = PIT_F64_WINDOWS * 1024 + 1
    vf, init64, solver, grid64 = _pit_problem(torch.float64, device, num)
    t_seq64, seq64 = _timed(
        lambda: ivpsolve.solve_fixed_grid(vf, init64, grid=grid64, solver=solver))
    before = kernels.LAUNCHES["pit_combine"]
    t_par64, (sol64, diag64) = _timed(lambda: parallel(1024, "cuda", grid64, init64))
    rel64 = float(torch.max(torch.abs(sol64.u - seq64.u)) / torch.max(torch.abs(seq64.u)))
    diverged64 = int(torch.sum(diag64["window_diverged"]))
    emit({"phase": "main_pit", "row": "parallel", "dtype": "float64", "T": num, "window": 1024,
          "combine_engine": "cuda", "seconds": t_par64, "sequential_seconds": t_seq64,
          "speedup_vs_seq": t_seq64 / t_par64, "rel_vs_seq": rel64,
          "window_diverged": diverged64, "num_windows": diag64["num_windows"],
          "window_delta_max": float(torch.max(diag64["window_delta"])),
          "k8_launches_per_solve": kernels.LAUNCHES["pit_combine"] - before,
          "max_abs_err_vs_lsoda": float(np.max(np.abs(sol64.u.cpu().numpy() - truth[:num])))})
    if not (rel64 <= PIT_F64_GATE and bool(torch.all(torch.isfinite(sol64.u)))
            and diverged64 < diag64["num_windows"] and sol64.u.dtype == torch.float64):
        failed.append(("float64", rel64, diverged64))
    if failed:
        raise AssertionError(f"fixed-grid rows failed their gates: {failed}")


def _event_timing(times, nbytes, flops, kernel, run):
    return _with_device_time(kernel, run, {
        "event_ms": min(times["kernel"][0], times["kernel2"][0]),
        "plain_ms": min(times["plain"][0], times["plain2"][0]), "bytes": nbytes,
        "flops": flops})


def phase_launch_pit(device, captured):
    """One launch of K8 at the main row's shapes against its plain version,
    float32 (the kernel table's row) and float64 (its ``f64`` entry)."""
    f32 = _launch_pit(captured["last_level"], PEAK_F32_FLOPS)
    f64 = _launch_pit(captured["f64/last_level"], PEAK_F64_FLOPS)
    bound_ms, bound_by = _bound(f64)
    return {**f32, "f64": {k: f64[k] for k in ("ms", "plain_ms", "host_ms", "event_ms")}
            | {"bound_ms": bound_ms, "bound_by": bound_by}}


def _launch_pit(pairs_ij, peak_flops):
    """K8 on one captured level (plain, kernel, kernel, plain), equal to its
    plain version; its timing, with ``peak_flops`` the rate of its type."""
    import torch

    from odecheckpts_torch import kernels

    e_i, e_j = pairs_ij
    m, c, pairs = e_i[0].shape[0], e_i[1].shape[1], e_i[0].shape[-1]
    times = _time_pair((
        ("plain", lambda: kernels.pit_combine_plain(e_i, e_j)),
        ("kernel", lambda: kernels.pit_combine(e_i, e_j)),
        ("kernel2", lambda: kernels.pit_combine(e_i, e_j)),
        ("plain2", lambda: kernels.pit_combine_plain(e_i, e_j)),
    ))
    dev = _max_dev(times["kernel"][1], times["plain"][1], torch)
    nbytes = 3 * sum(x.numel() * x.element_size() for x in e_i)  # 10 in, 5 out
    info = _event_timing(times, nbytes, pairs * _combine_flops(m, c), "pit_combine",
                         lambda: kernels.pit_combine(e_i, e_j))
    info["peak_flops"] = peak_flops
    emit({"phase": "one_launch", "kernel": "K8", "form": "pit_combine", "m": m, "c": c,
          "dtype": str(e_i[0].dtype).removeprefix("torch."),
          "pairs": pairs, "kernel_ms": [times["kernel"][0], times["kernel2"][0]],
          "plain_ms": [times["plain"][0], times["plain2"][0]], "max_abs_dev": dev,
          "bytes": nbytes, "flops": info["flops"]})
    if dev != 0.0:
        raise AssertionError(f"one launch of K8 differs from its plain version by {dev}")
    return info


def _library_qr_r(x, torch):
    """The one-call yardstick of K9: ``torch.linalg.qr`` with the diagonal's
    sign fixed (timed here, used nowhere in the port)."""
    r = torch.linalg.qr(x, mode="r").R
    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    one = torch.ones_like(diag)
    return r * torch.where(diag >= 0, one, -one)[..., :, None]


def phase_batched_qr(device):
    """K9 against its plain version and the reference; its time beside the
    plain version's and the library call's."""
    import torch

    from odecheckpts_torch import batched_qr, kernels

    rng = np.random.default_rng(SEED)
    worst, failed = 0.0, []
    for shape in QR_SHAPES:
        x = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)
        got = batched_qr.batched_qr_r(x)
        want = kernels.batched_qr_r_plain(x)
        ref = batched_qr.batched_qr_r_reference(x)
        torch.cuda.synchronize()
        dev = float(torch.max(torch.abs(got - want)))
        dev_ref = float(torch.max(torch.abs(got - ref)))
        gram = float(torch.max(torch.abs(got.transpose(-1, -2) @ got - x.transpose(-1, -2) @ x)))
        worst = max(worst, dev)
        emit({"phase": "batched_qr", "kernel": "K9", "shape": list(shape), "max_abs_dev": dev,
              "max_abs_dev_vs_reference": dev_ref, "gram_dev": gram})
        if dev != 0.0 or not dev_ref <= 2e-5 or not gram <= 2e-4:
            failed.append((shape, dev, dev_ref, gram))
    if failed:
        raise AssertionError(f"K9 failed (shape, vs plain, vs reference, gram): {failed}")
    batch, m, n = QR_SHAPES[-1]
    times = _time_pair((
        ("plain", lambda: kernels.batched_qr_r_plain(x)),
        ("library", lambda: _library_qr_r(x, torch)),
        ("kernel", lambda: kernels.batched_qr_r(x)),
        ("kernel2", lambda: kernels.batched_qr_r(x)),
        ("library2", lambda: _library_qr_r(x, torch)),
        ("plain2", lambda: kernels.batched_qr_r_plain(x)),
    ))
    lib_dev = float(torch.max(torch.abs(times["library"][1] - times["kernel"][1])))
    info = _event_timing(times, batch * (m * n + min(m, n) * n) * 4, batch * _qr_flops(m, n, n),
                         "batched_qr_r", lambda: kernels.batched_qr_r(x))
    info["library_ms"] = _device_time("qr", lambda: _library_qr_r(x, torch))["device_ms"]
    emit({"phase": "one_launch", "kernel": "K9", "form": "batched_qr_r", "shape": [batch, m, n],
          "kernel_ms": [times["kernel"][0], times["kernel2"][0]],
          "plain_ms": [times["plain"][0], times["plain2"][0]],
          "library_ms": [times["library"][0], times["library2"][0]],
          "library_max_abs_dev": lib_dev})
    if not lib_dev <= 2e-5:
        raise AssertionError(f"torch.linalg.qr with the sign fixed is {lib_dev} off K9")
    return {"batched_qr_r": worst}, info


def phase_qr_packing(device):
    """K10 and K11 against their plain versions and each other, then timed."""
    import torch

    from odecheckpts_torch import kernels, qr_packing

    rng = np.random.default_rng(SEED)
    worst = {"qr_packing_cols": 0.0, "qr_packing_masked": 0.0}
    failed = []
    for size in (10, 8, 6):
        x = torch.tensor(rng.standard_normal((size, size, 1024)), dtype=torch.float32,
                         device=device)
        outs = {}
        for iters in (1, 3):
            for variant in ("cols", "masked"):
                name = f"qr_packing_{variant}"
                got = qr_packing.bench_kernel(variant, size, size, iters)(x)
                want = getattr(kernels, name + "_plain")(x, iters)
                torch.cuda.synchronize()
                dev = float(torch.max(torch.abs(got - want)))
                worst[name] = max(worst[name], dev)
                outs[(variant, iters)] = got
                if dev != 0.0:
                    failed.append((name, size, iters, dev))
        tri_c = torch.triu(torch.movedim(outs[("cols", 1)], -1, 0))
        tri_m = torch.triu(torch.movedim(outs[("masked", 1)], -1, 0))
        close = bool(torch.all(torch.abs(tri_m - tri_c) <= 2e-5 + 2e-4 * torch.abs(tri_c)))
        emit({"phase": "qr_packing", "m": size, "n": size, "max_abs_dev": dict(worst),
              "variants_agree_on_upper_triangle": close})
        if not close:
            failed.append(("cols vs masked", size))
    if failed:
        raise AssertionError(f"K10 / K11 failed: {failed}")

    timing = {}
    for batch in PACKING_BATCHES:
        x = torch.tensor(rng.standard_normal((10, 10, batch)), dtype=torch.float32, device=device)
        run_c = qr_packing.bench_kernel("cols", 10, 10, PACKING_ITERS)
        run_m = qr_packing.bench_kernel("masked", 10, 10, PACKING_ITERS)
        run_c(x), run_m(x)  # warm-up
        times = _time_pair((("cols", lambda: run_c(x)), ("masked", lambda: run_m(x)),
                            ("masked2", lambda: run_m(x)), ("cols2", lambda: run_c(x))))
        ms_c = min(times["cols"][0], times["cols2"][0])
        ms_m = min(times["masked"][0], times["masked2"][0])
        emit({"phase": "qr_packing", "timed": True, "m": 10, "n": 10, "iters": PACKING_ITERS,
              "batch": batch, "cols_ms": ms_c, "masked_ms": ms_m,
              "cols_qr_per_sec_millions": batch * PACKING_ITERS / ms_c / 1e3,
              "masked_qr_per_sec_millions": batch * PACKING_ITERS / ms_m / 1e3,
              "packed_over_cols": ms_m / ms_c})
        if batch == PACKING_BATCHES[0]:  # the reference's size: the kernel table's row
            plain = _time_pair((
                ("cols", lambda: kernels.qr_packing_cols_plain(x, PACKING_ITERS)),
                ("masked", lambda: kernels.qr_packing_masked_plain(x, PACKING_ITERS))))
            nbytes = 2 * x.numel() * 4
            flops = batch * PACKING_ITERS * _qr_flops(10, 10, 10)
            for variant, run, ms in (("cols", run_c, ms_c), ("masked", run_m, ms_m)):
                name = f"qr_packing_{variant}"
                timing[name] = _with_device_time(name, lambda run=run: run(x), {
                    "event_ms": ms, "plain_ms": plain[variant][0], "bytes": nbytes,
                    "flops": flops})
    return worst, timing


def main():
    device, _smi = phase_device()
    import torch

    geometry = phase_build()
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
    worst.update(phase_attempt_dense(device))
    loop_dense, counts_dense = _path(["step_dense_interval"], lambda: phase_main_dense(device))
    timing["step_dense_interval"] = phase_interval_dense(device, loop_dense)
    counts_attempt_dense, timing["step_dense_attempt"] = phase_attempt_engine_dense(device,
                                                                                    loop_dense)
    del loop_dense
    worst.update(phase_attempt_bd(device))
    loop_bd, counts_bd = _path(["step_bd_interval"], lambda: phase_main_bd(device))
    phase_foil_bd(device, loop_bd)
    timing["step_bd_interval"] = phase_interval_bd(device, loop_bd)
    counts_attempt_bd, timing["step_bd_attempt"] = phase_attempt_engine_bd(device, loop_bd)
    del loop_bd
    worst.update(phase_attempt_everystep(device))
    row_es, counts_es = _path(["step_everystep_attempt"], lambda: phase_main_everystep(device))
    timing["step_everystep_attempt"] = phase_launch_everystep(device, row_es)
    del row_es
    captured = {**_capture_second_window(device, torch.float32),
                **_capture_second_window(device, torch.float64, "f64/")}
    worst.update(phase_combine_pit(device, captured))
    _, counts_pit = _path(["pit_combine"], lambda: phase_main_pit(device))
    timing["pit_combine"] = phase_launch_pit(device, captured)
    del captured
    (worst_qr, timing["batched_qr_r"]), counts_qr = _path(["batched_qr_r"],
                                                          lambda: phase_batched_qr(device))
    (worst_packing, timing_packing), counts_packing = _path(
        ["qr_packing_cols", "qr_packing_masked"], lambda: phase_qr_packing(device))
    worst.update(worst_qr)
    worst.update(worst_packing)
    timing.update(timing_packing)

    launches = {"step_ll_interval": counts_ll["step_ll_interval"],
                "step_hi_interval": counts_hi["step_hi_interval"],
                "step_ll_attempt": counts_attempt["step_ll_attempt"]["step_ll_attempt"],
                "step_hi_attempt": counts_attempt["step_hi_attempt"]["step_hi_attempt"],
                "step_dense_interval": counts_dense["step_dense_interval"],
                "step_dense_attempt": counts_attempt_dense["step_dense_attempt"],
                "step_bd_interval": counts_bd["step_bd_interval"],
                "step_bd_attempt": counts_attempt_bd["step_bd_attempt"],
                "step_everystep_attempt": counts_es["step_everystep_attempt"],
                "pit_combine": counts_pit["pit_combine"],
                "batched_qr_r": counts_qr["batched_qr_r"],
                "qr_packing_cols": counts_packing["qr_packing_cols"],
                "qr_packing_masked": counts_packing["qr_packing_masked"]}
    rows = []
    for name, (_kid, source, replaces) in KERNELS.items():
        bound_ms, bound_by = _bound(timing[name])
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": worst[name],
                     "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": timing[name].get("library_ms"),
                     "host_ms": timing[name]["host_ms"], "event_ms": timing[name]["event_ms"]})
        if name in STANDALONE:
            rows[-1]["note"] = "no solve path launches it: the launches of its phase"
        if name in geometry:
            rows[-1].update({k: v for k, v in geometry[name].items()
                             if k in ("threads_per_lane", "lanes_per_block", "threads_per_pair",
                                      "pairs_per_block", "smem_bytes", "blocks_per_sm")})
        if "f64" in timing[name]:
            rows[-1]["f64"] = timing[name]["f64"]
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
