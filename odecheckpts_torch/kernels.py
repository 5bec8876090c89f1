"""Hand-written CUDA kernels of the port and their wrappers.

==  ==========================  ==================================  =======================================================
id  wrapper                     source                              replaces (``odecheckpts_tpu``)
==  ==========================  ==================================  =======================================================
K1  ``step_ll_interval``        ``csrc/step_ll.cu``                 ``batched._pallas_interval(make_step_ll)``
K3  ``step_ll_attempt``         ``csrc/step_ll_attempt.cu``         ``batched._pallas_step(make_step_ll)``
K2  ``step_hi_interval``        ``csrc/step_hi.cu``                 ``batched_hi._pallas_interval(make_step_hi)``
K4  ``step_hi_attempt``         ``csrc/step_hi_attempt.cu``         ``batched_hi._pallas_step(make_step_hi)``
K2  ``step_hi_wide_interval``   ``csrc/step_hi_wide.cu``            ``batched_hi._pallas_interval(make_step_hi)``, wide d
K4  ``step_hi_wide_attempt``    ``csrc/step_hi_wide_attempt.cu``    ``batched_hi._pallas_step(make_step_hi)``, wide d
K5  ``step_dense_interval``     ``csrc/step_dense.cu``              ``batched_dense._pallas_interval(make_step_dense_ll)``
K5  ``step_dense_attempt``      ``csrc/step_dense_attempt.cu``      ``batched_dense._pallas_step(make_step_dense_ll)``
K6  ``step_bd_interval``        ``csrc/step_bd.cu``                 ``batched_blockdiag._pallas_interval(make_step_bd_ll)``
K6  ``step_bd_attempt``         ``csrc/step_bd_attempt.cu``         ``batched_blockdiag._pallas_step(make_step_bd_ll)``
K7  ``step_everystep_attempt``  ``csrc/step_everystep_attempt.cu``  ``batched_everystep._pallas_step(make_step_ll)``
K8  ``pit_combine``             ``csrc/pit_combine.cu``             ``pit_fused._pallas_combine`` (body ``combine_sqrt_ll``)
K9  ``batched_qr_r``            ``csrc/batched_qr.cu``              ``pallas_kernels.batched_qr_r``
K10 ``qr_packing_cols``         ``csrc/qr_packing.cu``              ``qr_packing_bench._bench_kernel("cols", ...)``
K11 ``qr_packing_masked``       ``csrc/qr_packing.cu``              ``qr_packing_bench._bench_kernel("masked", ...)``
==  ==========================  ==================================  =======================================================

(``qr_packing_bench``: ``experiments/6_tpu_batched_sweep/qr_packing_bench.py``.)

K1, K2 and the interval forms of K5 and K6 run a whole checkpoint interval
(the accept/reject loop of every lane) in one launch; K3, K4 and the attempt
forms of K5 and K6 run one attempt of the same step body per launch, under
the host loop ``attempt_loop``.  K2 and K4 have a second, wide form for
states of many components (the Brusselator method of lines, d = 64, 128):
one block per IVP lane and one thread per component instead of one thread
per lane (``csrc/step_hi_wide.cuh``).  K7 is one attempt of K3's step body
with the smoother or the filter strategy, launched a fixed number of times
by the save-every-step driver.  The twins are ``batched.StepLL`` (f32; K1, K3 and,
with its strategy, K7), ``batched_hi.StepHi`` (df32 pairs),
``batched_dense.StepDense`` (f32, dense covariance, TS1 or TS0) and
``batched_blockdiag.StepBD`` (f32, one factor and one scale per dimension).
K8 is one level of the parallel-in-time prefix (the sqrt combine of a window's
element pairs, float or double, a team of 8 threads a pair; twin
``pit_fused.combine_sqrt_ll``); K9-K11
are standalone: the batched QR and the two variants of its layout
microbenchmark (``batched_qr``, ``qr_packing``).

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use, one
``nvcc`` process per ``.cu`` file, all started together, then linked into
one shared library with a plain C interface (``odecheckpts_torch/_build/
<hash>/``, keyed by a hash of the sources and flags) and bound with
``ctypes``.  Nothing is built or imported from CUDA when this module is
imported.

A wrapper runs its kernel's plain PyTorch version on CPU tensors, launches
the kernel on CUDA tensors, and raises on anything else.  Each wrapper adds
one to its plain-integer entry in ``LAUNCHES`` where it launches its kernel,
and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import rounded

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libodeckpt_kernels.so"

# launches per kernel wrapper, counted where the kernel is launched
LAUNCHES = {
    "step_ll_interval": 0, "step_ll_attempt": 0,
    "step_hi_interval": 0, "step_hi_attempt": 0,
    "step_hi_wide_interval": 0, "step_hi_wide_attempt": 0,
    "step_dense_interval": 0, "step_dense_attempt": 0,
    "step_bd_interval": 0, "step_bd_attempt": 0,
    "step_everystep_attempt": 0,
    "pit_combine": 0, "batched_qr_r": 0, "qr_packing_cols": 0, "qr_packing_masked": 0,
}

# The ODE dimension of a wide entry (K2 and K4 wide): any even d up to
# HI_WIDE_MAX_D, one thread per component (csrc/step_hi_wide.cuh)
HI_WIDE_D, HI_WIDE_MAX_D = "2N", 1024
# (kernel, device functor of the step's vector field) -> (C symbol, ODE dim);
# the functors of order 2 are in _VARIANTS as well
_FUNCTORS = {
    ("step_ll_interval", "rigid_body"): ("odeckpt_step_ll_interval_rigid_body", 3),
    ("step_ll_interval", "rigid_body_anisotropic"):
        ("odeckpt_step_ll_interval_rigid_body_anisotropic", 3),
    ("step_ll_attempt", "rigid_body"): ("odeckpt_step_ll_attempt_rigid_body", 3),
    ("step_hi_interval", "rigid_body_df"): ("odeckpt_step_hi_interval_rigid_body_df", 3),
    ("step_hi_attempt", "rigid_body_df"): ("odeckpt_step_hi_attempt_rigid_body_df", 3),
    ("step_dense_interval", "brusselator"): ("odeckpt_step_dense_interval_brusselator", 4),
    ("step_dense_attempt", "brusselator"): ("odeckpt_step_dense_attempt_brusselator", 4),
    ("step_dense_interval", "rigid_body"): ("odeckpt_step_dense_interval_rigid_body", 3),
    ("step_dense_attempt", "rigid_body"): ("odeckpt_step_dense_attempt_rigid_body", 3),
    ("step_bd_interval", "rigid_body"): ("odeckpt_step_bd_interval_rigid_body", 3),
    ("step_bd_attempt", "rigid_body"): ("odeckpt_step_bd_attempt_rigid_body", 3),
    ("step_bd_interval", "rigid_body_anisotropic"):
        ("odeckpt_step_bd_interval_rigid_body_anisotropic", 3),
    ("step_bd_attempt", "rigid_body_anisotropic"):
        ("odeckpt_step_bd_attempt_rigid_body_anisotropic", 3),
    ("step_everystep_attempt", "rigid_body"): ("odeckpt_step_everystep_attempt_rigid_body", 3),
    ("step_ll_interval", "three_body_restricted"):
        ("odeckpt_step_ll_interval_three_body_restricted", 2),
    ("step_ll_attempt", "three_body_restricted"):
        ("odeckpt_step_ll_attempt_three_body_restricted", 2),
    ("step_ll_interval", "van_der_pol"): ("odeckpt_step_ll_interval_van_der_pol", 1),
    ("step_ll_attempt", "van_der_pol"): ("odeckpt_step_ll_attempt_van_der_pol", 1),
    ("step_hi_interval", "three_body_restricted_hi"):
        ("odeckpt_step_hi_interval_three_body_restricted_hi", 2),
    ("step_hi_attempt", "three_body_restricted_hi"):
        ("odeckpt_step_hi_attempt_three_body_restricted_hi", 2),
    ("step_hi_interval", "van_der_pol_hi"): ("odeckpt_step_hi_interval_van_der_pol_hi", 1),
    ("step_hi_attempt", "van_der_pol_hi"): ("odeckpt_step_hi_attempt_van_der_pol_hi", 1),
    ("step_hi_wide_interval", "brusselator_hi"):
        ("odeckpt_step_hi_wide_interval_brusselator_hi", HI_WIDE_D),
    ("step_hi_wide_attempt", "brusselator_hi"):
        ("odeckpt_step_hi_wide_attempt_brusselator_hi", HI_WIDE_D),
}
# the row functors of K2 and K4 wide (csrc/functors.cuh) -> float parameters;
# each is of order 1, built for the nu of HI_WIDE_NU, fixedpoint and TS0
_WIDE_FUNCTORS = {"brusselator_hi": 1}
# the orders K2 wide and K4 wide are built for: their lane (LaneWide in
# csrc/step_hi_wide.cuh) holds n <= 6, while K2 and K4 take every nu of
# batched_hi.SUPPORTED_NU
HI_WIDE_NU = (4, 5)
# The functors of order 2 on K1-K4 (csrc/functors.cuh; step_ll_o2*.cu,
# step_hi_o2*.cu): functor -> (ODE order, float parameters, the nu it is
# built for, the strategies, the corrections).  Their entries take the
# strategy code and the TS1 flag after nu.  The other functors are of order
# 1, built for every nu of their kernel, fixedpoint and TS0 on K1-K4.
_VARIANTS = {
    "three_body_restricted": (2, 2, (4,), ("fixedpoint", "filter"), ("ts0",)),
    "van_der_pol": (2, 1, (4,), ("fixedpoint", "filter"), ("ts0", "ts1")),
    "three_body_restricted_hi": (2, 2, (4,), ("fixedpoint", "filter"), ("ts0",)),
    "van_der_pol_hi": (2, 1, (4,), ("fixedpoint", "filter"), ("ts0", "ts1")),
}
# what K8-K11 are instantiated for: K8's state dimension m = nu + 1 and mean
# columns c, the (m, n) of K9 and of K10 / K11
PIT_COMBINE_M, PIT_COMBINE_C = (3, 4, 5), (1, 2, 3)
BATCHED_QR_SHAPES = ((10, 5), (6, 6), (4, 2), (6, 3), (8, 4), (12, 6))
QR_PACKING_SHAPES = ((10, 10), (8, 8), (6, 6))
# K10 / K11's team: QR_PACKING_TEAM threads a lane for a batch of at most
# QR_PACKING_TEAM_LANES_PER_SM lanes an SM (4 blocks of 32 lanes), else one
# (qr_packing_team; csrc/qr_packing.cu builds both)
QR_PACKING_TEAM, QR_PACKING_TEAM_LANES_PER_SM = 4, 128
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C symbol -> argument types of the entries that take no step functor
_ENTRIES = {
    "odeckpt_pit_combine": [_INT, _INT, _INT, _PTR, _PTR, ctypes.c_longlong, _INT, _PTR],
    "odeckpt_batched_qr": [_INT, _INT, _PTR, _PTR, ctypes.c_longlong, _INT, _PTR],
    "odeckpt_qr_packing_cols": [_INT, _INT, _INT, _INT, _PTR, _PTR, ctypes.c_longlong, _INT, _PTR],
    "odeckpt_qr_packing_masked": [_INT, _INT, _INT, _INT, _PTR, _PTR, ctypes.c_longlong, _INT,
                                  _PTR],
    "odeckpt_step_dense_interval_geometry": [_INT, _INT, _INT, _PTR],
    "odeckpt_step_dense_attempt_geometry": [_INT, _INT, _INT, _PTR],
    "odeckpt_step_bd_interval_geometry": [_INT, _INT, _PTR],
    "odeckpt_step_bd_attempt_geometry": [_INT, _INT, _PTR],
    "odeckpt_step_hi_interval_geometry": [_INT, _PTR],
    "odeckpt_step_hi_attempt_geometry": [_INT, _PTR],
    "odeckpt_step_hi_wide_interval_geometry": [_INT, _INT, _PTR],
    "odeckpt_step_hi_wide_attempt_geometry": [_INT, _INT, _PTR],
    "odeckpt_step_ll_interval_geometry": [_INT, _PTR],
    "odeckpt_step_ll_attempt_geometry": [_INT, _PTR],
    "odeckpt_step_everystep_attempt_geometry": [_INT, _INT, _PTR],
    "odeckpt_pit_combine_geometry": [_INT, _INT, _INT, _PTR],
}
# K7's strategy argument (the template parameter of step_ll.cuh's attempt)
STRATEGY_CODES = {"fixedpoint": 0, "smoother": 1, "filter": 2}
# K5's launch geometry (step_dense.cuh): a block is a tile of DENSE_LANES
# lanes of the form, one warp of DENSE_THREADS_PER_LANE threads each, or as
# many as a block's shared memory holds; a launch takes at most
# DENSE_LANES_MAX
DENSE_LANES = {"step_dense_interval": 6, "step_dense_attempt": 12}
DENSE_LANES_MAX, DENSE_THREADS_PER_LANE = 12, 32
SMEM_PER_BLOCK = 232_448  # the H100's dynamic shared memory per block, bytes
_DENSE_CONST_FLOATS, _NMAX = 64, 5


def _col_stride(m):
    """step_dense.cuh's col_stride: whole float4s, an odd number of them."""
    quads = (m + 3) // 4
    return 4 * quads if quads % 2 else 4 * quads + 4


def dense_lane_floats(nd, d):
    """Floats of one lane's slice of K5's shared memory (``DenseLayout`` in
    step_dense.cuh): the QR column list (2nd columns of ``_col_stride(2nd)``;
    the gain lives in its right half), the Householder vector, its squares
    and inv * vector, two copies of the five replaced arrays ((nd, nd) rows
    padded to an odd stride), the small vectors and the scalars."""
    m = 2 * nd
    lds, mp = nd | 1, (m + 3) // 4 * 4
    mat = nd * lds
    buf = 2 * nd + 3 * mat
    used = m * _col_stride(m) + 3 * mp + 2 * buf + 2 * nd + 3 * d + d * d + 2 * _NMAX + 8
    return (used + 3) // 4 * 4


def dense_geometry(nd, d, lanes_per_block=None, kernel="step_dense_interval"):
    """The launch geometry of K5's form ``kernel`` for state dimension
    ``nd`` and ODE dimension ``d``, as its C launch function computes it:
    lanes per block (the form's default tile unless ``lanes_per_block`` is
    given), threads per lane and per block, and dynamic shared-memory bytes
    per block."""
    lane_bytes = 4 * dense_lane_floats(nd, d)
    fit = (SMEM_PER_BLOCK - 4 * _DENSE_CONST_FLOATS) // lane_bytes
    lanes = lanes_per_block or min(DENSE_LANES[kernel], fit)
    return {"lanes_per_block": lanes, "threads_per_lane": DENSE_THREADS_PER_LANE,
            "threads_per_block": DENSE_THREADS_PER_LANE * lanes,
            "smem_bytes": 4 * _DENSE_CONST_FLOATS + lanes * lane_bytes}


# K6's launch geometry (step_bd.cuh): a thread per (lane, channel), a block
# is a tile of 32 consecutive lanes in d warps, warp = channel.
_BD_WARP = 32


def bd_geometry(nu, d):
    """The launch geometry of K6 (both forms) for nu and ODE dimension ``d``,
    as its C launch functions compute it: threads per lane, lanes and
    threads per block, and shared-memory bytes per block: the tile's
    exchange buffer and each thread's channel's mean, chol, bwdG, bwd_m and
    bwd_L (2n + 3n^2 floats) and its lane's 6 inputs."""
    threads, n = d * _BD_WARP, nu + 1
    floats = 2 * 2 * d * _BD_WARP + (2 * n + 3 * n * n + 6) * threads
    return {"threads_per_lane": d, "lanes_per_block": _BD_WARP, "threads_per_block": threads,
            "smem_bytes": 4 * floats}


# K1-K4's and K7's launch geometry (lanes.cuh): a thread per IVP lane,
# blocks of 128 lanes
_LANE_THREADS = 128


def _thread_per_lane():
    return {"threads_per_lane": 1, "lanes_per_block": _LANE_THREADS,
            "threads_per_block": _LANE_THREADS, "smem_bytes": 0}


def hi_geometry(nu):
    """The launch geometry of K2 and K4 (both forms, every nu of
    ``batched_hi.SUPPORTED_NU``), as their C launch functions compute it:
    threads per lane, lanes and threads per block, and shared-memory bytes
    per block."""
    from . import batched_hi

    if nu not in batched_hi.SUPPORTED_NU:
        raise ValueError(f"K2 and K4 are built for nu in {batched_hi.SUPPORTED_NU}, not {nu}")
    return _thread_per_lane()


# K2 and K4 wide (step_hi_wide.cuh): one block per lane, a thread per
# component in whole warps, the lane's LaneWide (HI_WIDE_LANE_FLOATS floats)
# and three rows of d floats in dynamic shared memory; blocks of at most
# HI_WIDE_SMALL_THREADS threads run the instantiation of that launch bound,
# wider ones the one bounded at HI_WIDE_MAX_D threads
HI_WIDE_LANE_FLOATS, HI_WIDE_SMALL_THREADS, _WARP = 363, 128, 32


def hi_wide_geometry(nu, d):
    """The launch geometry of K2 and K4 wide (both forms, nu in
    ``HI_WIDE_NU``) for ODE dimension ``d`` (at most ``HI_WIDE_MAX_D``), as
    their C launch functions compute it: threads per lane (d), lanes per
    block (1), threads per block (d in whole warps), shared-memory bytes per block
    (the lane's scalars, decisions, (n, n) arrays, constants and warp 0's
    scratch, and three rows of d floats) and ``max_threads``, the launch
    bound of the instantiation that runs it (``HI_WIDE_SMALL_THREADS`` for
    blocks up to that size, else ``HI_WIDE_MAX_D``)."""
    if nu not in HI_WIDE_NU:
        raise ValueError(f"K2 and K4 wide are built for nu = 4 and 5 (HI_WIDE_NU), not {nu}")
    if not 1 <= int(d) <= HI_WIDE_MAX_D:
        raise ValueError(f"K2 and K4 wide take 1 <= d <= {HI_WIDE_MAX_D} (a thread a "
                         f"component, one block a lane), got d={d}")
    threads = (d + _WARP - 1) // _WARP * _WARP
    return {"threads_per_lane": d, "lanes_per_block": 1, "threads_per_block": threads,
            "smem_bytes": 4 * (HI_WIDE_LANE_FLOATS + 3 * d),
            "max_threads": (HI_WIDE_SMALL_THREADS if threads <= HI_WIDE_SMALL_THREADS
                            else HI_WIDE_MAX_D)}


def ll_geometry(nu, d=3):
    """The launch geometry of K1 and K3 (both forms, nu = 2, 3 or 4) for ODE
    dimension ``d``, as their C launch functions compute it
    (``prev_smem_bytes`` in step_ll.cuh): ``hi_geometry``'s keys; a lane's
    five previous arrays (2 n d + 3 n^2 floats) sit in shared memory."""
    if nu not in (2, 3, 4):
        raise ValueError(f"K1, K3 and K7 are built for nu in (2, 3, 4), not {nu}")
    n = nu + 1
    return {**_thread_per_lane(),
            "smem_bytes": 4 * _LANE_THREADS * (2 * n * d + 3 * n * n)}


def everystep_geometry(nu):
    """K7's launch geometry (every strategy, nu = 2, 3 or 4): a thread per
    lane, ``hi_geometry``'s keys, no shared memory (the arrays an attempt
    does not read are copied from the input to the output after it,
    ``store_attempt`` in step_ll.cuh)."""
    ll_geometry(nu)
    return _thread_per_lane()


# K8's launch geometry (pit_combine.cuh): a team of PIT_TEAM threads a pair,
# PIT_PAIRS_PER_BLOCK pairs a block in two warps (the R1 and the R2 halves)
PIT_TEAM, PIT_PAIRS_PER_BLOCK = 8, 8


def pit_combine_geometry(m, c, dtype=torch.float32):
    """K8's launch geometry for state dimension ``m``, ``c`` mean columns
    and ``dtype`` (float32 or float64), as ``odeckpt_pit_combine_geometry``
    reports it: threads a pair, pairs and threads a block, and the block's
    shared memory: each pair's slice (``PairShared``: the ten operands, the
    two halves' product, column list, factor and right solve, and A_j U_i:
    17 m^2 + 4 m c scalars) at a stride of half a team more than a
    multiple of 32 scalars."""
    if m not in PIT_COMBINE_M or c not in PIT_COMBINE_C:
        raise ValueError(
            f"pit_combine is built for m in {PIT_COMBINE_M} and c in {PIT_COMBINE_C}, "
            f"got m={m}, c={c}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pit_combine takes float32 or float64 operands, got {dtype}")
    scalars = 17 * m * m + 4 * m * c
    stride = scalars + (PIT_TEAM // 2 - scalars) % 32
    itemsize = 8 if dtype == torch.float64 else 4
    return {"threads_per_pair": PIT_TEAM, "pairs_per_block": PIT_PAIRS_PER_BLOCK,
            "threads_per_block": PIT_TEAM * PIT_PAIRS_PER_BLOCK,
            "smem_bytes": PIT_PAIRS_PER_BLOCK * stride * itemsize}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            f"{CSRC} at first use"
        )
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _build_key():
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _ptxas_key(symbol):
    """(kernel, template key) of a mangled step-kernel symbol: nu for K1-K4
    (``"<nu>/<functor>"`` for K1 and K3 on a functor other than the rigid
    body; ``"<nu>/<functor>/<strategy>/<ts0 or ts1>"`` on a functor of order
    2, ``HiChannel<...>`` for K2 and K4), ``"<nu>/<launch bound>"`` for K2
    wide and K4 wide, ``"<nu>/<ts1 or ts0>/<functor>"`` for K5, ``"<nu>/<functor>"`` for K6,
    ``"<nu>/<strategy>"`` for K7; ``"<f32 or f64>/<m>/<c>"`` for K8 and
    ``"<m>/<n>"`` for K9 and ``"<m>/<n>/<threads a lane>"`` for K10 and K11,
    under their wrappers' names; None for other symbols."""
    m = re.search(r"pit_combineI([fd])Li(\d+)ELi(\d+)E", symbol)
    if m is not None:
        return "pit_combine", f"{'f32' if m.group(1) == 'f' else 'f64'}/{m.group(2)}/{m.group(3)}"
    m = re.search(r"(batched_qr|qr_packing_cols|qr_packing_masked)ILi(\d+)ELi(\d+)E(?:Li(\d+)E)?",
                  symbol)
    if m is not None:
        name = "batched_qr_r" if m.group(1) == "batched_qr" else m.group(1)
        team = f"/{m.group(4)}" if m.group(4) else ""
        return name, f"{m.group(2)}/{m.group(3)}{team}"
    m = re.search(r"(step_(?:ll|hi_wide|hi|dense|bd|everystep)_(?:interval|attempt))ILi(\d+)E",
                  symbol)
    if m is None:
        return None
    kernel, nu = m.group(1), int(m.group(2))
    rest = symbol[m.end():]
    if kernel.startswith("step_dense"):
        fm = re.match(r"Lb([01])ENS_(\d+)", rest)
        if fm is None:
            return None
        functor = rest[fm.end() : fm.end() + int(fm.group(2))]
        return kernel, f"{nu}/{'ts1' if fm.group(1) == '1' else 'ts0'}/{functor}"
    if kernel.startswith("step_bd"):
        fm = re.match(r"NS_(\d+)", rest)
        if fm is None:
            return None
        return kernel, f"{nu}/{rest[fm.end() : fm.end() + int(fm.group(1))]}"
    if kernel.startswith("step_ll"):  # the rigid body under nu, another functor beside it
        fm = re.match(r"NS_(\d+)", rest)
        functor = rest[fm.end() : fm.end() + int(fm.group(1))] if fm else "RigidBody"
        vm = re.match(r"ELi(\d)ELb([01])E", rest[fm.end() + len(functor):]) if fm else None
        if vm is not None:  # a functor of order 2: strategy code and TS1 flag
            names = {code: name for name, code in STRATEGY_CODES.items()}
            return kernel, _variant_key(nu, functor, names[int(vm.group(1))], vm.group(2))
        return kernel, nu if functor == "RigidBody" else f"{nu}/{functor}"
    if kernel.startswith("step_hi_wide"):  # "<nu>/<launch bound>"
        fm = re.match(r"Li(\d+)E", rest)
        return (kernel, f"{nu}/{fm.group(1)}") if fm else None
    if kernel.startswith("step_hi"):
        fm = re.match(r"NS_9HiChannelINS_(\d+)", rest)
        if fm is not None:
            functor = rest[fm.end() : fm.end() + int(fm.group(1))]
            vm = re.match(r"EEELb([01])ELb([01])E", rest[fm.end() + len(functor):])
            if vm is None:
                return None
            strategy = "filter" if vm.group(1) == "1" else "fixedpoint"
            return kernel, _variant_key(nu, f"HiChannel<{functor}>", strategy, vm.group(2))
    if kernel.startswith("step_everystep"):
        fm = re.match(r"Li(\d)E", rest)
        names = {code: name for name, code in STRATEGY_CODES.items()}
        if fm is None or int(fm.group(1)) not in names:
            return None
        return kernel, f"{nu}/{names[int(fm.group(1))]}"
    return kernel, nu


def _variant_key(nu, functor, strategy, ts1):
    """``"<nu>/<functor>/<strategy>/<ts0 or ts1>"``: the ptxas key of a K1-K4
    instantiation on a functor of order 2 (``ts1`` the mangled flag)."""
    return f"{nu}/{functor}/{strategy}/{'ts1' if ts1 == '1' else 'ts0'}"


def parse_ptxas(log):
    """Registers, spill bytes and static shared memory per kernel and template
    from ``ptxas -v`` output: ``{kernel: {key: {"registers": r,
    "spill_stores": s, "spill_loads": l, "stack": f}}}`` (and ``"smem": b``
    where ptxas prints ``b bytes smem``: K6's static shared memory; K5's is
    dynamic, see ``dense_geometry``), keyed by nu for K1-K4, by
    ``"<nu>/<launch bound>"`` for K2 wide and K4 wide (``"4/128"``) and by
    ``"<nu>/<ts1 or ts0>/<functor>"`` for K5 (``"4/ts1/Brusselator"``),
    ``"<nu>/<functor>"`` for K6, ``"<nu>/<strategy>"`` for K7,
    ``"<f32 or f64>/<m>/<c>"`` for K8 (``"f32/4/3"``), ``"<m>/<n>"`` for K9
    and ``"<m>/<n>/<threads a lane>"`` for K10 and K11 (``"10/10/4"``)."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)", line)
        if m:
            key = _ptxas_key(m.group(1))
            continue
        if key is None:
            continue
        entry = out.setdefault(key[0], {}).setdefault(key[1], {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            entry["smem"] = int(m.group(1))
    return out


def hi_channel_functor(functor):
    """The device functor that K2 and K4 run for ``functor`` on the hi
    channel of its pairs (``"<functor>_hi"``: ``csrc/step_hi.cuh``'s
    ``HiChannel``, or a row functor of the wide forms), or None where none
    is built."""
    name = f"{functor}_hi"
    return name if name in _VARIANTS or name in _WIDE_FUNCTORS else None


def hi_wide(functor):
    """Whether ``functor`` runs on the wide forms of K2 and K4 (a block per
    lane), which ``batched_hi.make_hi_solver`` then launches."""
    return functor in _WIDE_FUNCTORS


def order_two_instantiations():
    """``(functor, strategy, correction)`` of every K1 / K3 instantiation on
    a functor of order 2; K2 / K4 run each on the functor's hi channel."""
    return [(functor, strategy, correction)
            for functor, (_, _, _, strategies, corrections) in _VARIANTS.items()
            if hi_channel_functor(functor) for strategy in strategies
            for correction in corrections]


def _num_params(kernel, functor):
    """Float parameters of an entry: K6's entries and those of the
    anisotropic rigid body take a fourth, the scale; the functors of order 2
    their own count."""
    if functor in _VARIANTS:
        return _VARIANTS[functor][1]
    if functor in _WIDE_FUNCTORS:
        return _WIDE_FUNCTORS[functor]
    return 4 if kernel.startswith("step_bd") or functor == "rigid_body_anisotropic" else 3


def _num_flags(kernel, functor):
    """The ints an entry takes after nu: K5's ts1 flag, K7's strategy, the
    strategy code and the TS1 flag of a functor of order 2."""
    if functor in _VARIANTS:
        return 2
    return 1 if kernel.startswith(("step_dense", "step_everystep")) else 0


def _argtypes(kernel, functor):
    """C signature of a kernel's entry: nu, [flags], the host arrays of
    input and output pointers, the constants, the batch, [d: the wide
    forms], [max_attempts], the functor's parameters, the device index, the
    stream."""
    args = [ctypes.c_int] * (1 + _num_flags(kernel, functor))
    args += [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    if kernel.startswith("step_hi_wide"):
        args.append(ctypes.c_int)
    if kernel.endswith("interval"):
        args.append(ctypes.c_int)
    return (args + [ctypes.c_float] * _num_params(kernel, functor)
            + [ctypes.c_int, ctypes.c_void_p])


class _Library:
    def __init__(self, path, seconds, log):
        self.path, self.seconds, self.log = path, seconds, log
        self.lib = ctypes.CDLL(str(path))
        for (kernel, functor), (symbol, _) in _FUNCTORS.items():
            fn = getattr(self.lib, symbol)
            fn.argtypes = _argtypes(kernel, functor)
            fn.restype = ctypes.c_int
        for symbol, argtypes in _ENTRIES.items():
            fn = getattr(self.lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib.odeckpt_error_string.argtypes = [ctypes.c_int]
        self.lib.odeckpt_error_string.restype = ctypes.c_char_p

    def error_string(self, code):
        return self.lib.odeckpt_error_string(code).decode()


@functools.lru_cache(maxsize=1)
def library():
    """Build (once per source hash) and load the kernel library.

    Returns an object with ``path``, ``seconds`` (the wall-clock build time,
    0.0 when the library was already built) and ``log`` (nvcc's
    ``-Xptxas -v`` output; see ``parse_ptxas``)."""
    out_dir = BUILD_DIR / _build_key()
    so, log_path = out_dir / LIB_NAME, out_dir / "build.log"
    seconds = 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        t0 = time.perf_counter()
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = out_dir / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cmd, _obj, proc in jobs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{logs[-1]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        seconds = time.perf_counter() - t0
        log_path.write_text("".join(logs))
        os.replace(tmp, so)
        for _, obj, _ in jobs:
            obj.unlink()
    return _Library(so, seconds, log_path.read_text())


# ---------------------------------------------------------------------------
# plain versions


def active_ll(state, t_next):
    """Lanes of the 17-array f32 state still short of the checkpoint."""
    return state[0] < t_next


def active_hi(state, t_next):
    """Lanes of the 12-array df32 state still short of the checkpoint: a lane
    whose time rounds onto ``t_next`` in the hi word with ``t_lo < 0`` is
    still short of it (``odecheckpts_tpu/batched_hi.py:535-536``)."""
    return (state[0] < t_next) | ((state[0] == t_next) & (state[1] < 0))


def attempt_plain(step, state, t_next, *, atol, rtol, dt_max, dt_floor, tiny_scale):
    """Plain version of the attempt kernels (K3, K4, K7 and the attempt
    forms of K5 and K6): one attempt of the twin ``step`` on every lane
    (lanes at the checkpoint are frozen inside the step)."""
    return step(state, t_next, atol, rtol, dt_max, dt_floor, tiny_scale)


step_ll_attempt_plain = step_hi_attempt_plain = step_dense_attempt_plain = attempt_plain
step_bd_attempt_plain = step_everystep_attempt_plain = step_hi_wide_attempt_plain = attempt_plain


def attempt_loop(attempt, active, step, state, t_next, *, max_attempts, **inputs):
    """``attempt`` while any lane is ``active``, at most ``max_attempts``
    times: the host loop of the per-attempt engines (one device sync per
    attempt) and the plain version of the interval kernels."""
    for _ in range(max_attempts):
        if not bool(torch.any(active(state, t_next))):
            break
        state = attempt(step, state, t_next, **inputs)
    return state


def step_ll_interval_plain(step, state, t_next, *, max_attempts, **inputs):
    """Plain version of K1 and of the interval forms of K5 and K6: attempts
    of the twin (``batched.StepLL``, ``batched_dense.StepDense`` or
    ``batched_blockdiag.StepBD``) while any lane has
    ``t < t_next``.  Lanes at the checkpoint are frozen inside the step, so
    every lane ends in the state the per-lane kernel loop leaves it in."""
    return attempt_loop(attempt_plain, active_ll, step, state, t_next,
                        max_attempts=max_attempts, **inputs)


step_dense_interval_plain = step_bd_interval_plain = step_ll_interval_plain


def step_hi_interval_plain(step, state, t_next, *, max_attempts, **inputs):
    """Plain version of K2: attempts of the df32 twin while any lane is
    short of the checkpoint by the pair-aware predicate ``active_hi``."""
    return attempt_loop(attempt_plain, active_hi, step, state, t_next,
                        max_attempts=max_attempts, **inputs)


step_hi_wide_interval_plain = step_hi_interval_plain  # K2 wide: the same loop of the twin


def pit_combine_plain(e_i, e_j):
    """Plain version of K8: the twin ``pit_fused.combine_sqrt_ll``."""
    from . import pit_fused

    return pit_fused.combine_sqrt_ll(e_i, e_j)


def _sum_rows(x):
    """Sum over axis 0 in row order (the kernels' order), kept as size 1."""
    acc = x[0:1]
    for r in range(1, x.shape[0]):
        acc = acc + x[r : r + 1]
    return acc


def householder_masked_ll(x, *, mask_eliminated):
    """Masked full-matrix Householder on one lanes-last (m, n, B) stack: the
    reflections j < min(n, m - 1), each a zero-masked full column applied to
    all n columns; ``sqrt(norm2 + tiny)``, no rescaling, no sign
    normalization; the IEEE root on every device (``rounded.sqrt``).  With
    ``mask_eliminated`` the coefficient of column c is
    multiplied by ``c >= j`` (K11,
    ``experiments/6_tpu_batched_sweep/qr_packing_bench.py:42-70``); without it
    the eliminated columns take their (rounding-level) update too (K9,
    ``odecheckpts_tpu/pallas_kernels.py:28-60``)."""
    m, n = x.shape[0], x.shape[1]
    eps = torch.finfo(x.dtype).tiny
    rows = torch.arange(m, device=x.device).reshape(m, 1, 1)
    cols = torch.arange(n, device=x.device).reshape(1, n, 1)
    for j in range(min(n, m - 1)):
        below = (rows >= j).to(x.dtype)
        is_j = (rows == j).to(x.dtype)
        colm = x[:, j : j + 1] * below  # (m, 1, B)
        norm2 = _sum_rows(colm * colm)
        norm = rounded.sqrt(norm2 + eps)
        head = _sum_rows(colm * is_j)
        one = torch.ones_like(head)
        alpha = -torch.where(head >= 0, one, -one) * norm
        v = colm - is_j * alpha
        vnorm2 = norm2 + alpha * alpha - 2.0 * head * alpha
        safe = vnorm2 > eps
        inv = torch.where(safe, torch.full_like(vnorm2, 2.0) / torch.where(safe, vnorm2, one),
                          torch.zeros_like(vnorm2))
        coeff = _sum_rows(v * x)  # (1, n, B)
        if mask_eliminated:
            coeff = coeff * (cols >= j).to(x.dtype)
        x = x - (inv * v) * coeff
    return x


def batched_qr_r_plain(x):
    """Plain version of K9: R of every (m, n) matrix of ``x`` (B, m, n), the
    first min(m, n) rows with the diagonal's sign normalized."""
    m, n = x.shape[-2], x.shape[-1]
    k = min(m, n)
    r = householder_masked_ll(torch.movedim(x, 0, -1), mask_eliminated=False)[:k]
    diag = torch.stack([r[i, i] for i in range(k)])
    one = torch.ones_like(diag)
    return torch.movedim(r * torch.where(diag >= 0, one, -one)[:, None], -1, 0)


def _perturbation(k, dtype):
    """1e-6 * k as the kernels form it: both factors rounded to float32."""
    return float(torch.tensor(1e-6, dtype=dtype) * torch.tensor(float(k), dtype=dtype))


def qr_packing_cols_plain(x, iters):
    """Plain version of K10: ``iters`` column-list QRs (``batched._qr_r_cols``)
    of the lanes-last (m, n, B) ``x``, each after adding 1e-6 k."""
    from .batched import _qr_r_cols

    m, n = x.shape[0], x.shape[1]
    cols = x.transpose(0, 1)
    for k in range(iters):
        cols = _qr_r_cols(cols + _perturbation(k, x.dtype), m, n, torch.finfo(x.dtype).tiny)
    return cols.transpose(0, 1).contiguous()


def qr_packing_masked_plain(x, iters):
    """Plain version of K11: ``iters`` masked full-matrix QRs of the
    lanes-last (m, n, B) ``x``, each after adding 1e-6 k."""
    for k in range(iters):
        x = householder_masked_ll(x + _perturbation(k, x.dtype), mask_eliminated=True)
    return x


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_cuda_inputs(kernel, shapes, tensors, dtype=torch.float32):
    device = tensors[0].device
    for i, (x, want) in enumerate(zip(tensors, shapes)):
        if x.device != device or x.dtype != dtype:
            raise ValueError(
                f"{kernel} takes {dtype} tensors on one CUDA device; input {i} is "
                f"{x.dtype} on {x.device}"
            )
        if tuple(x.shape) != tuple(want):
            raise ValueError(f"{kernel} input {i} has shape {tuple(x.shape)}, expected {want}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel} input {i} is not contiguous")


def _launch(kernel, step, state, t_next, inputs, max_attempts=None):
    """Launch ``kernel`` on the CUDA tensors of ``state``: new output
    tensors, the launch on the current stream, one count in ``LAUNCHES``."""
    device = state[0].device
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors (or its plain version on CPU), got {device}")
    functor = step.device_functor
    symbol, dim = _functor_entry(kernel, step)
    flags = _variant_flags(kernel, functor, step)
    batch = state[0].shape[-1]
    extra = (t_next, inputs["atol"], inputs["rtol"], inputs["dt_max"], inputs["dt_floor"],
             inputs["tiny_scale"])
    shapes = list(step.state_shapes(batch)) + [(1, batch)] * len(extra)
    if len(state) + len(extra) != len(shapes):
        raise ValueError(f"{kernel} takes {len(shapes) - len(extra)} state arrays, got {len(state)}")
    _check_cuda_inputs(kernel, shapes, (*state, *extra))
    outs = tuple(torch.empty_like(x) for x in state)
    if batch == 0:
        return outs
    lib = library()
    ins_ptr = (ctypes.c_void_p * len(shapes))(*(x.data_ptr() for x in (*state, *extra)))
    outs_ptr = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    consts = step.packed_constants()
    params = tuple(float(p) for p in step.functor_params)
    num_params = _num_params(kernel, functor)
    if len(params) > num_params:
        raise ValueError(
            f"{kernel}: a device functor takes at most {num_params} parameters, got {params}")
    params = params + (0.0,) * (num_params - len(params))
    stream = torch.cuda.current_stream(device).cuda_stream
    index = device.index if device.index is not None else torch.cuda.current_device()
    head = (step.nu, *flags, ctypes.addressof(ins_ptr), ctypes.addressof(outs_ptr),
            consts.ctypes.data, batch)
    if dim == HI_WIDE_D:
        head = head + (step.d,)
    if max_attempts is not None:
        if not 0 <= int(max_attempts) < 2**31:
            raise ValueError(f"max_attempts must fit an int32, got {max_attempts}")
        head = head + (int(max_attempts),)
    rc = getattr(lib.lib, symbol)(*head, *params, index, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: {lib.error_string(rc)} ({rc})")
    LAUNCHES[kernel] += 1
    return outs


def _functor_entry(kernel, step):
    """(C symbol, ODE dimension) of ``kernel``'s entry for the step's device
    functor; raises ``NotImplementedError`` where the kernel has none and
    ``ValueError`` where the step's d is not the entry's (a wide entry: any
    even d up to ``HI_WIDE_MAX_D``)."""
    functor = step.device_functor
    if (kernel, functor) not in _FUNCTORS:
        have = sorted(f for k, f in _FUNCTORS if k == kernel)
        raise NotImplementedError(
            f"{kernel}: the vector field has no device functor for this kernel (got "
            f"{functor!r}; have {have}): ROADMAP queue 1 item 5"
        )
    symbol, dim = _FUNCTORS[(kernel, functor)]
    if dim == HI_WIDE_D:
        if step.d % 2 or not 2 <= step.d <= HI_WIDE_MAX_D:
            raise ValueError(f"device functor {functor!r} takes an even d <= {HI_WIDE_MAX_D}, "
                             f"the step has d={step.d}")
    elif step.d != dim:
        raise ValueError(f"device functor {functor!r} has d={dim}, the step has d={step.d}")
    return symbol, dim


def _variant_flags(kernel, functor, step):
    """The flag ints of ``kernel``'s entry for the step's configuration;
    raises ``ValueError`` where the functor's order is not the step's and
    ``NotImplementedError`` where no instantiation runs the configuration
    (the wide forms: nu in ``HI_WIDE_NU``, fixedpoint, TS0, ode_order 1)."""
    if kernel.startswith("step_hi_wide"):
        strategy = getattr(step, "strategy", "fixedpoint")
        order = getattr(step, "ode_order", 1)
        if step.nu not in HI_WIDE_NU or strategy != "fixedpoint" or step.ts1 or order != 1:
            raise NotImplementedError(
                f"{kernel} on {functor!r} is built for nu in {HI_WIDE_NU}, the "
                f"fixedpoint strategy, TS0 and ode_order=1; got nu={step.nu}, {strategy!r}, "
                f"{'ts1' if step.ts1 else 'ts0'}, ode_order={order}: ROADMAP queue 1 item 2")
        return ()
    order = _VARIANTS[functor][0] if functor in _VARIANTS else 1
    if getattr(step, "ode_order", 1) != order:
        raise ValueError(f"device functor {functor!r} has ode_order={order}, the step has "
                         f"ode_order={step.ode_order}")
    if kernel.startswith("step_dense"):
        return (int(step.ts1),)
    if kernel.startswith("step_everystep"):
        return (STRATEGY_CODES[step.strategy],)
    if kernel.startswith("step_bd"):
        return ()
    from . import batched, batched_hi

    strategy = getattr(step, "strategy", "fixedpoint")
    correction = "ts1" if step.ts1 else "ts0"
    nus, strategies, corrections = (
        _VARIANTS[functor][2:] if functor in _VARIANTS
        else ((batched_hi if kernel.startswith("step_hi") else batched).SUPPORTED_NU,
              ("fixedpoint",), ("ts0",)))
    if step.nu not in nus or strategy not in strategies or correction not in corrections:
        raise NotImplementedError(
            f"{kernel} on {functor!r} is built for nu in {nus}, strategies {strategies}, "
            f"corrections {corrections}; got nu={step.nu}, {strategy!r}, {correction!r}: "
            "ROADMAP queue 1 item 5")
    return (STRATEGY_CODES[strategy], int(step.ts1)) if functor in _VARIANTS else ()


def step_ll_interval(step, state, t_next, *, atol, rtol, dt_max, dt_floor,
                     tiny_scale, max_attempts):
    """K1: advance every lane of the 17-array lanes-last ``state`` to
    ``t_next`` (or ``max_attempts`` attempts), one launch per interval.

    ``step`` is the twin (``batched.StepLL``); it also carries what the
    kernel needs: nu, the rounded constants and the vector field's device
    functor and parameters.  On CPU tensors the twin runs; on CUDA tensors
    the kernel runs or this raises."""
    inputs = dict(atol=atol, rtol=rtol, dt_max=dt_max, dt_floor=dt_floor, tiny_scale=tiny_scale)
    if state[0].device.type == "cpu":
        return step_ll_interval_plain(step, state, t_next, max_attempts=max_attempts, **inputs)
    return _launch("step_ll_interval", step, state, t_next, inputs, max_attempts)


def step_ll_attempt(step, state, t_next, *, atol, rtol, dt_max, dt_floor, tiny_scale):
    """K3: one attempt of K1's step on every lane of the 17-array state."""
    inputs = dict(atol=atol, rtol=rtol, dt_max=dt_max, dt_floor=dt_floor, tiny_scale=tiny_scale)
    if state[0].device.type == "cpu":
        return step_ll_attempt_plain(step, state, t_next, **inputs)
    return _launch("step_ll_attempt", step, state, t_next, inputs)


def step_hi_interval(step, state, t_next, *, atol, rtol, dt_max, dt_floor,
                     tiny_scale, max_attempts):
    """K2: advance every lane of the 12-array df32 ``state`` to ``t_next``
    (pair-aware, or ``max_attempts`` attempts), one launch per interval.
    ``step`` is the twin ``batched_hi.StepHi``."""
    inputs = dict(atol=atol, rtol=rtol, dt_max=dt_max, dt_floor=dt_floor, tiny_scale=tiny_scale)
    if state[0].device.type == "cpu":
        return step_hi_interval_plain(step, state, t_next, max_attempts=max_attempts, **inputs)
    return _launch("step_hi_interval", step, state, t_next, inputs, max_attempts)


def step_hi_attempt(step, state, t_next, *, atol, rtol, dt_max, dt_floor, tiny_scale):
    """K4: one attempt of K2's step on every lane of the 12-array state."""
    inputs = dict(atol=atol, rtol=rtol, dt_max=dt_max, dt_floor=dt_floor, tiny_scale=tiny_scale)
    if state[0].device.type == "cpu":
        return step_hi_attempt_plain(step, state, t_next, **inputs)
    return _launch("step_hi_attempt", step, state, t_next, inputs)


def step_hi_wide_interval(step, state, t_next, *, atol, rtol, dt_max, dt_floor,
                          tiny_scale, max_attempts):
    """K2 wide: K2 (``step_hi_interval``) for a step whose device functor
    is a row functor of the wide forms (``hi_wide``), one block per lane and
    one thread per component, any even d up to ``HI_WIDE_MAX_D``."""
    inputs = dict(atol=atol, rtol=rtol, dt_max=dt_max, dt_floor=dt_floor, tiny_scale=tiny_scale)
    if state[0].device.type == "cpu":
        return step_hi_wide_interval_plain(step, state, t_next, max_attempts=max_attempts,
                                           **inputs)
    return _launch("step_hi_wide_interval", step, state, t_next, inputs, max_attempts)


def step_hi_wide_attempt(step, state, t_next, *, atol, rtol, dt_max, dt_floor, tiny_scale):
    """K4 wide: one attempt of K2 wide's step on every lane."""
    inputs = dict(atol=atol, rtol=rtol, dt_max=dt_max, dt_floor=dt_floor, tiny_scale=tiny_scale)
    if state[0].device.type == "cpu":
        return step_hi_wide_attempt_plain(step, state, t_next, **inputs)
    return _launch("step_hi_wide_attempt", step, state, t_next, inputs)


_GEOMETRY_KEYS = ("threads_per_lane", "lanes_per_block", "threads_per_block", "smem_bytes",
                  "blocks_per_sm", "registers", "local_bytes")
_PIT_GEOMETRY_KEYS = ("threads_per_pair", "pairs_per_block") + _GEOMETRY_KEYS[2:]
_WIDE_GEOMETRY_KEYS = _GEOMETRY_KEYS + ("max_threads",)


def _geometry_entry(symbol, *args, keys=_GEOMETRY_KEYS):
    lib = library()
    out = (ctypes.c_int * len(keys))()
    rc = getattr(lib.lib, symbol)(*(int(a) for a in args), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: {lib.error_string(rc)} ({rc})")
    return dict(zip(keys, out))


def step_hi_geometry(kernel, nu=4):
    """K2's or K4's launch geometry on the current CUDA device, as the C
    launch function of ``kernel`` ("step_hi_interval" or "step_hi_attempt")
    has it for nu: ``hi_geometry``'s keys, ``blocks_per_sm`` (resident
    blocks, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    ``registers`` and ``local_bytes`` per thread."""
    if kernel not in ("step_hi_interval", "step_hi_attempt"):
        raise ValueError(f"{kernel} is not K2 or K4")
    return _geometry_entry(f"odeckpt_{kernel}_geometry", nu)


def step_hi_wide_geometry(kernel, nu=4, d=64):
    """K2 wide's or K4 wide's launch geometry on the current CUDA device for
    nu and ODE dimension ``d``, as the C launch function of ``kernel``
    ("step_hi_wide_interval" or "step_hi_wide_attempt") has it:
    ``hi_wide_geometry``'s keys (``max_threads``: the launch bound of the
    instantiation that d takes), ``blocks_per_sm`` (resident blocks, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), ``registers`` and
    ``local_bytes`` per thread of that instantiation."""
    if kernel not in ("step_hi_wide_interval", "step_hi_wide_attempt"):
        raise ValueError(f"{kernel} is not a wide form of K2 or K4")
    hi_wide_geometry(nu, d)
    return _geometry_entry(f"odeckpt_{kernel}_geometry", nu, d, keys=_WIDE_GEOMETRY_KEYS)


def step_ll_geometry(kernel, nu=4):
    """K1's or K3's launch geometry on the current CUDA device, as the C
    launch function of ``kernel`` ("step_ll_interval" or "step_ll_attempt")
    has it for nu (the rigid body's entry): ``ll_geometry``'s keys,
    ``blocks_per_sm`` (resident blocks, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), ``registers`` and
    ``local_bytes`` per thread."""
    if kernel not in ("step_ll_interval", "step_ll_attempt"):
        raise ValueError(f"{kernel} is not K1 or K3")
    return _geometry_entry(f"odeckpt_{kernel}_geometry", nu)


def step_everystep_geometry(nu=4, strategy="smoother"):
    """K7's launch geometry on the current CUDA device for nu and the
    strategy: ``everystep_geometry``'s keys, ``blocks_per_sm``,
    ``registers`` and ``local_bytes`` per thread."""
    if strategy not in ("smoother", "filter"):
        raise ValueError(f"K7 runs the smoother or the filter strategy, got {strategy!r}")
    return _geometry_entry("odeckpt_step_everystep_attempt_geometry", nu, STRATEGY_CODES[strategy])


def step_pit_combine_geometry(m=4, c=3, dtype=torch.float32):
    """K8's launch geometry on the current CUDA device for the (m, c,
    dtype) instantiation: ``pit_combine_geometry``'s keys,
    ``blocks_per_sm`` (resident blocks, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), ``registers`` and
    ``local_bytes`` per thread."""
    pit_combine_geometry(m, c, dtype)
    return _geometry_entry("odeckpt_pit_combine_geometry", m, c, dtype == torch.float64,
                           keys=_PIT_GEOMETRY_KEYS)


def step_dense_interval(step, state, t_next, *, atol, rtol, dt_max, dt_floor,
                        tiny_scale, max_attempts):
    """K5, interval form: advance every lane of the dense 17-array state
    ((nd, B) means, (nd, nd, B) factors) to ``t_next`` (or ``max_attempts``
    attempts), one launch per interval.  ``step`` is the twin
    ``batched_dense.StepDense``; TS1 or TS0 follows ``step.ts1``."""
    inputs = dict(atol=atol, rtol=rtol, dt_max=dt_max, dt_floor=dt_floor, tiny_scale=tiny_scale)
    if state[0].device.type == "cpu":
        return step_dense_interval_plain(step, state, t_next, max_attempts=max_attempts, **inputs)
    return _launch("step_dense_interval", step, state, t_next, inputs, max_attempts)


def step_dense_attempt(step, state, t_next, *, atol, rtol, dt_max, dt_floor, tiny_scale):
    """K5, attempt form: one attempt of the dense step on every lane."""
    inputs = dict(atol=atol, rtol=rtol, dt_max=dt_max, dt_floor=dt_floor, tiny_scale=tiny_scale)
    if state[0].device.type == "cpu":
        return step_dense_attempt_plain(step, state, t_next, **inputs)
    return _launch("step_dense_attempt", step, state, t_next, inputs)


def step_dense_geometry(kernel, d, ts1=True, lanes_per_block=-1):
    """K5's launch geometry on the current CUDA device, as the C launch
    function of ``kernel`` ("step_dense_interval" or "step_dense_attempt")
    has it for the functor of ODE dimension ``d`` (4: Brusselator, 3: rigid
    body): ``dense_geometry``'s keys and ``blocks_per_sm`` (resident blocks,
    from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  A
    ``lanes_per_block`` > 0 makes that the tile of every later launch of the
    form (for measuring one geometry against another), 0 restores the
    default, -1 leaves it."""
    if kernel not in ("step_dense_interval", "step_dense_attempt"):
        raise ValueError(f"{kernel} is not a form of K5")
    if not -1 <= int(lanes_per_block) <= DENSE_LANES_MAX:
        raise ValueError(f"lanes_per_block must be in -1..{DENSE_LANES_MAX}, got {lanes_per_block}")
    lib = library()
    out = (ctypes.c_int * 4)()
    rc = getattr(lib.lib, f"odeckpt_{kernel}_geometry")(int(d), int(ts1), int(lanes_per_block),
                                                        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{kernel} geometry failed: {lib.error_string(rc)} ({rc})")
    return {"lanes_per_block": out[0], "threads_per_lane": DENSE_THREADS_PER_LANE,
            "threads_per_block": out[1], "smem_bytes": out[2], "blocks_per_sm": out[3]}


def step_bd_interval(step, state, t_next, *, atol, rtol, dt_max, dt_floor,
                     tiny_scale, max_attempts):
    """K6, interval form: advance every lane of the blockdiag 17-array state
    ((n, d, B) means, (n, n, d, B) factors, (d, B) scales) to ``t_next`` (or
    ``max_attempts`` attempts), one launch per interval.  ``step`` is the
    twin ``batched_blockdiag.StepBD``."""
    inputs = dict(atol=atol, rtol=rtol, dt_max=dt_max, dt_floor=dt_floor, tiny_scale=tiny_scale)
    if state[0].device.type == "cpu":
        return step_bd_interval_plain(step, state, t_next, max_attempts=max_attempts, **inputs)
    return _launch("step_bd_interval", step, state, t_next, inputs, max_attempts)


def step_bd_attempt(step, state, t_next, *, atol, rtol, dt_max, dt_floor, tiny_scale):
    """K6, attempt form: one attempt of the blockdiag step on every lane."""
    inputs = dict(atol=atol, rtol=rtol, dt_max=dt_max, dt_floor=dt_floor, tiny_scale=tiny_scale)
    if state[0].device.type == "cpu":
        return step_bd_attempt_plain(step, state, t_next, **inputs)
    return _launch("step_bd_attempt", step, state, t_next, inputs)


def step_bd_geometry(kernel, nu=4, functor="rigid_body_anisotropic"):
    """K6's launch geometry on the current CUDA device, as the C launch
    function of ``kernel`` ("step_bd_interval" or "step_bd_attempt") has it
    for nu and the device functor: ``bd_geometry``'s keys, ``blocks_per_sm``
    (resident blocks, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    ``registers`` and ``local_bytes`` per thread."""
    if kernel not in ("step_bd_interval", "step_bd_attempt"):
        raise ValueError(f"{kernel} is not a form of K6")
    if functor not in ("rigid_body", "rigid_body_anisotropic"):
        raise ValueError(f"K6 has no device functor {functor!r}")
    return _geometry_entry(f"odeckpt_{kernel}_geometry", nu, functor == "rigid_body_anisotropic")


def step_everystep_attempt(step, state, t_next, *, atol, rtol, dt_max, dt_floor, tiny_scale):
    """K7: one attempt of the isotropic step with ``step.strategy``
    "smoother" (the attempt's own backward conditional, no accumulation) or
    "filter" (no reversal) on every lane of the 17-array state.  ``step`` is
    the twin ``batched.StepLL`` made with that strategy; the fixedpoint
    strategy is K3's (``step_ll_attempt``)."""
    if step.strategy not in ("smoother", "filter"):
        raise ValueError(
            f"step_everystep_attempt runs the smoother or the filter strategy, got "
            f"{step.strategy!r} (fixedpoint: step_ll_attempt)")
    inputs = dict(atol=atol, rtol=rtol, dt_max=dt_max, dt_floor=dt_floor, tiny_scale=tiny_scale)
    if state[0].device.type == "cpu":
        return step_everystep_attempt_plain(step, state, t_next, **inputs)
    return _launch("step_everystep_attempt", step, state, t_next, inputs)


def _require_cuda(kernel, device):
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors (or its plain version on CPU), got {device}")


def _stream_args(device):
    """(device index, current stream) as the C entries take them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def _check_rc(kernel, lib, rc):
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: {lib.error_string(rc)} ({rc})")
    LAUNCHES[kernel] += 1


def pit_combine(e_i, e_j):
    """K8: the sqrt combine of every lane's element pair, earlier elements
    ``e_i`` with later ``e_j``; each a tuple (A, b, U, eta, Z) of lanes-last
    (m, m, P), (m, c, P), (m, m, P), (m, c, P), (m, m, P) tensors, float32 or
    float64.  One launch; five new output tensors.  Built for m in {3, 4, 5}
    and c in {1, 2, 3}.  A block axis between the matrix axes and the lanes,
    (m, m, d, P) and (m, c, d, P) (the blockdiag adapter's independent chain
    per ODE dimension), is folded into the lanes as the contiguous view
    (m, m, d P): still one launch, no copy; operands that are not contiguous
    are refused.  On CPU tensors the plain version runs; on CUDA tensors the
    kernel runs or this raises."""
    if len(e_i) != 5 or len(e_j) != 5:
        raise ValueError("pit_combine takes two elements of five arrays (A, b, U, eta, Z)")
    device = e_i[0].device
    if device.type == "cpu":
        return pit_combine_plain(e_i, e_j)
    _require_cuda("pit_combine", device)
    if e_i[0].dim() == 4:
        if not all(x.dim() == 4 and x.is_contiguous() for x in (*e_i, *e_j)):
            raise ValueError(
                "pit_combine folds a block axis into the lanes as a view: every operand must "
                "be a contiguous (m, k, d, P) tensor (not contiguous, or of mixed rank)")
        outs = _pit_combine_lanes(*(tuple(x.view(x.shape[0], x.shape[1], -1) for x in e)
                                    for e in (e_i, e_j)))
        return tuple(o.view(x.shape) for o, x in zip(outs, e_i))
    if e_i[0].dim() != 3:
        raise ValueError(
            f"pit_combine takes (m, k, P) operands or (m, k, d, P) with a block axis, got "
            f"{tuple(e_i[0].shape)}")
    return _pit_combine_lanes(e_i, e_j)


def _pit_combine_lanes(e_i, e_j):
    """The launch of K8 on lanes-last (m, k, P) operands on the card."""
    dtype, device = e_i[0].dtype, e_i[0].device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pit_combine takes float32 or float64 operands, got {dtype}")
    m, pairs, c = e_i[0].shape[0], e_i[0].shape[-1], e_i[1].shape[1]
    if m not in PIT_COMBINE_M or c not in PIT_COMBINE_C:
        raise ValueError(
            f"pit_combine is built for m in {PIT_COMBINE_M} and c in {PIT_COMBINE_C}, "
            f"got m={m}, c={c}"
        )
    shapes = [(m, m, pairs), (m, c, pairs), (m, m, pairs), (m, c, pairs), (m, m, pairs)] * 2
    _check_cuda_inputs("pit_combine", shapes, (*e_i, *e_j), dtype)
    outs = tuple(torch.empty_like(x) for x in e_i)
    if pairs == 0:
        return outs
    lib = library()
    ins_ptr = (ctypes.c_void_p * 10)(*(x.data_ptr() for x in (*e_i, *e_j)))
    outs_ptr = (ctypes.c_void_p * 5)(*(x.data_ptr() for x in outs))
    rc = lib.lib.odeckpt_pit_combine(
        m, c, int(dtype == torch.float64), ctypes.addressof(ins_ptr),
        ctypes.addressof(outs_ptr), pairs, *_stream_args(device))
    _check_rc("pit_combine", lib, rc)
    return outs


def batched_qr_r(x):
    """K9: R factors of a batch of small matrices, ``x`` (B, m, n) float32 ->
    (B, min(m, n), n), diag(R) >= 0.  The wrapper moves the batch axis last
    for the kernel and back.  Built for the (m, n) of ``BATCHED_QR_SHAPES``.
    On CPU tensors the plain version runs; on CUDA tensors the kernel runs or
    this raises."""
    if x.dim() != 3:
        raise ValueError(f"batched_qr_r takes a (B, m, n) tensor, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return batched_qr_r_plain(x)
    _require_cuda("batched_qr_r", x.device)
    batch, m, n = x.shape
    if (m, n) not in BATCHED_QR_SHAPES:
        raise ValueError(f"batched_qr_r is built for (m, n) in {BATCHED_QR_SHAPES}, got {(m, n)}")
    x_ll = torch.movedim(x, 0, -1).contiguous()
    _check_cuda_inputs("batched_qr_r", [(m, n, batch)], (x_ll,))
    out = torch.empty((min(m, n), n, batch), dtype=x.dtype, device=x.device)
    if batch:
        lib = library()
        rc = lib.lib.odeckpt_batched_qr(m, n, x_ll.data_ptr(), out.data_ptr(), batch,
                                        *_stream_args(x.device))
        _check_rc("batched_qr_r", lib, rc)
    return torch.movedim(out, -1, 0)


def _qr_packing(kernel, plain, x, iters):
    if x.dim() != 3:
        raise ValueError(f"{kernel} takes a lanes-last (m, n, B) tensor, got {tuple(x.shape)}")
    if not 0 <= int(iters) < 2**31:
        raise ValueError(f"iters must fit an int32, got {iters}")
    if x.device.type == "cpu":
        return plain(x, iters)
    _require_cuda(kernel, x.device)
    m, n, batch = x.shape
    if (m, n) not in QR_PACKING_SHAPES:
        raise ValueError(f"{kernel} is built for (m, n) in {QR_PACKING_SHAPES}, got {(m, n)}")
    _check_cuda_inputs(kernel, [(m, n, batch)], (x,))
    out = torch.empty_like(x)
    if batch:
        lib = library()
        index, stream = _stream_args(x.device)
        rc = getattr(lib.lib, f"odeckpt_{kernel}")(m, n, int(iters),
                                                  qr_packing_team(batch, _sm_count(index)),
                                                  x.data_ptr(), out.data_ptr(), batch, index,
                                                  stream)
        _check_rc(kernel, lib, rc)
    return out


def qr_packing_team(batch, sm_count):
    """Threads a lane of a K10 / K11 launch of ``batch`` lanes on a device of
    ``sm_count`` SMs: a team of ``QR_PACKING_TEAM`` up to 4 of its blocks (32
    lanes each) an SM, else one thread a lane.  A team's time grows with its
    blocks an SM; on an H100 K10's fifth block costs more than a thread a
    lane takes (``qr_packing_trial.py``)."""
    return QR_PACKING_TEAM if batch <= QR_PACKING_TEAM_LANES_PER_SM * sm_count else 1


@functools.cache
def _sm_count(index):
    """The SMs of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def qr_packing_cols(x, iters):
    """K10: ``iters`` column-list QRs of every lane's (m, n) matrix of the
    lanes-last float32 ``x`` (m, n, B), each after adding 1e-6 k; the last one
    is returned.  Built for the (m, n) of ``QR_PACKING_SHAPES``."""
    return _qr_packing("qr_packing_cols", qr_packing_cols_plain, x, iters)


def qr_packing_masked(x, iters):
    """K11: as ``qr_packing_cols`` with the masked full-matrix QR, every
    reflection applied to all n columns under the ``active`` mask."""
    return _qr_packing("qr_packing_masked", qr_packing_masked_plain, x, iters)
