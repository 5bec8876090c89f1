"""Hand-written CUDA kernels of the port and their wrappers.

K1, ``step_ll_interval``: one whole checkpoint interval of the lanes-last
isotropic TS0 fixedpoint step (``csrc/step_ll.cu``), the counterpart of the
Pallas kernel ``odecheckpts_tpu.batched._pallas_interval(make_step_ll)``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``odecheckpts_torch/_build/<hash>/``,
keyed by a hash of the sources and flags) and bound with ``ctypes``.  Nothing
is built or imported from CUDA when this module is imported.

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

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libodeckpt_kernels.so"

# launches per kernel wrapper, counted where the kernel is launched
LAUNCHES = {"step_ll_interval": 0}

# device functor name (problems.<vf>.device_functor) -> (C symbol, ODE dim)
_FUNCTORS = {"rigid_body": ("odeckpt_step_ll_interval_rigid_body", 3)}


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


def parse_ptxas(log):
    """Registers and spill bytes per kernel template from ``ptxas -v`` output:
    ``{nu: {"registers": r, "spill_stores": s, "spill_loads": l, "stack": f}}``."""
    out, nu = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)", line)
        if m:
            tm = re.search(r"step_ll_interval\w*?ILi(\d+)E", m.group(1))
            nu = int(tm.group(1)) if tm else None
            continue
        if nu is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(nu, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)),
            )
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(nu, {})["registers"] = int(m.group(1))
    return out


class _Library:
    def __init__(self, path, seconds, log):
        self.path, self.seconds, self.log = path, seconds, log
        self.lib = ctypes.CDLL(str(path))
        for symbol, _ in _FUNCTORS.values():
            fn = getattr(self.lib, symbol)
            fn.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        self.lib.odeckpt_error_string.argtypes = [ctypes.c_int]
        self.lib.odeckpt_error_string.restype = ctypes.c_char_p

    def error_string(self, code):
        return self.lib.odeckpt_error_string(code).decode()


@functools.lru_cache(maxsize=1)
def library():
    """Build (once per source hash) and load the kernel library.

    Returns an object with ``path``, ``seconds`` (the build time, 0.0 when
    the library was already built) and ``log`` (nvcc's ``-Xptxas -v``
    output; see ``parse_ptxas``)."""
    out_dir = BUILD_DIR / _build_key()
    so, log_path = out_dir / LIB_NAME, out_dir / "build.log"
    seconds = 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in _sources() if s.suffix == ".cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return _Library(so, seconds, log_path.read_text())


def step_ll_interval_plain(step, state, t_next, *, atol, rtol, dt_max, dt_floor,
                           tiny_scale, max_attempts):
    """Plain version of K1: attempts of the twin ``step`` while any lane has
    ``t < t_next``, at most ``max_attempts`` of them.  Lanes at the
    checkpoint are frozen inside the step, so every lane ends in the state
    the per-lane kernel loop leaves it in."""
    for _ in range(max_attempts):
        if not bool(torch.any(state[0] < t_next)):
            break
        state = step(state, t_next, atol, rtol, dt_max, dt_floor, tiny_scale)
    return state


def _check_cuda_inputs(step, state, extra):
    n, d = step.nu + 1, step.d
    b = state[0].shape[-1]
    shapes = {1: (n, d, b), 4: (n, d, b), 8: (n, d, b), 11: (n, d, b),
              2: (n, n, b), 3: (n, n, b), 5: (n, n, b), 9: (n, n, b),
              10: (n, n, b), 12: (n, n, b)}
    device = state[0].device
    for i, x in enumerate(list(state) + list(extra)):
        want = shapes.get(i, (1, b))
        if x.device != device or x.dtype != torch.float32:
            raise ValueError(
                f"K1 takes float32 tensors on one CUDA device; input {i} is "
                f"{x.dtype} on {x.device}"
            )
        if tuple(x.shape) != want:
            raise ValueError(f"K1 input {i} has shape {tuple(x.shape)}, expected {want}")
        if not x.is_contiguous():
            raise ValueError(f"K1 input {i} is not contiguous")


def step_ll_interval(step, state, t_next, *, atol, rtol, dt_max, dt_floor,
                     tiny_scale, max_attempts):
    """K1: advance every lane of the 17-array lanes-last ``state`` to
    ``t_next`` (or ``max_attempts`` attempts), one launch per interval.

    ``step`` is the twin (``batched.StepLL``); it also carries what the
    kernel needs: nu, the rounded constants and the vector field's device
    functor and parameters.  On CPU tensors the twin runs; on CUDA tensors
    the kernel runs or this raises."""
    device = state[0].device
    if device.type == "cpu":
        return step_ll_interval_plain(
            step, state, t_next, atol=atol, rtol=rtol, dt_max=dt_max,
            dt_floor=dt_floor, tiny_scale=tiny_scale, max_attempts=max_attempts,
        )
    if device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors (or its plain version on CPU), got {device}")
    functor = getattr(step.vf, "device_functor", None)
    if functor not in _FUNCTORS:
        raise NotImplementedError(
            f"vector field has no device functor (got {functor!r}; have "
            f"{sorted(_FUNCTORS)}): ROADMAP queue 2, the vector-field contract"
        )
    symbol, dim = _FUNCTORS[functor]
    if step.d != dim:
        raise ValueError(f"device functor {functor!r} has d={dim}, the step has d={step.d}")
    extra = (t_next, atol, rtol, dt_max, dt_floor, tiny_scale)
    _check_cuda_inputs(step, state, extra)
    if not 0 <= int(max_attempts) < 2**31:
        raise ValueError(f"max_attempts must fit an int32, got {max_attempts}")
    batch = state[0].shape[-1]
    outs = tuple(torch.empty_like(x) for x in state)
    if batch == 0:
        return outs
    lib = library()
    ins_ptr = (ctypes.c_void_p * 23)(*(x.data_ptr() for x in (*state, *extra)))
    outs_ptr = (ctypes.c_void_p * 17)(*(x.data_ptr() for x in outs))
    consts = step.packed_constants()
    p1, p2, p3 = (float(p) for p in step.params)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib.lib, symbol)(
        step.nu, ctypes.addressof(ins_ptr), ctypes.addressof(outs_ptr),
        consts.ctypes.data, batch, int(max_attempts), p1, p2, p3,
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: {lib.error_string(rc)} ({rc})")
    LAUNCHES["step_ll_interval"] += 1
    return outs
