"""The block body of K2 wide and K4 wide (``odecheckpts_torch/csrc/
step_hi_wide.cuh``), compiled for the CPU and held against the twin bit for
bit.

The two sources of the wide forms (``step_hi_wide.cu``,
``step_hi_wide_attempt.cu``) are compiled with ``g++ -O1
-ffp-contract=off`` (every operation rounded on its own, as nvcc's
``-fmad=false``) against ``_SHIM``, a stand-in for ``cuda_runtime.h``: a
launch runs its blocks one after the other, each block's threads as
``std::thread``s; ``threadIdx`` / ``blockIdx`` / ``blockDim`` are
thread-locals; ``__syncthreads`` is a ``std::barrier`` of the block,
``__syncwarp`` one of the warp, and ``__shfl_sync`` a slot per lane between
two waits at the warp's barrier; dynamic shared memory is a buffer per
block; ``expf`` and ``logf`` are taken in float64 and rounded once, as
``odecheckpts_torch.rounded`` gives the CPU twin.  The triple-chevron
launches are rewritten to the shim's launch; the sources are otherwise as
built for the card (the shim is included first: nvcc knows ``__device__``
and the rest without a header).

Each case runs the C entries through ctypes on a few lanes of experiment
4's kind of ensemble (``problems.brusselator(N)`` after the f64 Taylor
init, tolerances 1e-5 to 1e-9 across the lanes) and requires every output
array to equal ``kernels.step_hi_wide_interval_plain`` (40 attempts) or
``kernels.step_hi_wide_attempt_plain`` (one attempt, and 40 chained) bit
for bit.  d = 8 is a block of one warp (the controller shares warp 0), d =
64 one of two.  Skips only where ``g++`` is absent.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from odecheckpts_torch import batched_hi, kernels, problems

CSRC = Path(kernels.__file__).resolve().parent / "csrc"
SOURCES = ("step_hi_wide.cu", "step_hi_wide_attempt.cu")
LANES = 3
ATTEMPTS = 40

_SHIM = r"""
#pragma once
#include <math.h>

#include <barrier>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

inline float shim_expf(float x) { return static_cast<float>(std::exp(static_cast<double>(x))); }
inline float shim_logf(float x) { return static_cast<float>(std::log(static_cast<double>(x))); }
#define expf(x) shim_expf(x)
#define logf(x) shim_logf(x)

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;
struct cudaFuncAttributes {
  size_t sharedSizeBytes, localSizeBytes;
  int numRegs;
};
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, K) { return cudaErrorInvalidValue; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaErrorInvalidValue; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, K, int, size_t) {
  return cudaErrorInvalidValue;
}

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

namespace shim {
struct Warp {
  std::barrier<> sync{32};
  float slot[32];
};
struct Block {
  std::barrier<> sync;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<float> smem;
  Block(unsigned threads, int smem_bytes) : sync(threads), smem(smem_bytes / sizeof(float) + 1) {
    for (unsigned w = 0; w < threads / 32; ++w) warps.push_back(std::make_unique<Warp>());
  }
};
inline thread_local Block* block = nullptr;
}  // namespace shim

inline thread_local dim3 threadIdx, blockIdx, blockDim;

inline void __syncthreads() { shim::block->sync.arrive_and_wait(); }
inline shim::Warp& shim_warp() { return *shim::block->warps[threadIdx.x / 32]; }
inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp().sync.arrive_and_wait(); }
inline float __shfl_sync(unsigned, float v, int src) {
  shim::Warp& w = shim_warp();
  w.slot[threadIdx.x % 32] = v;
  w.sync.arrive_and_wait();
  const float out = w.slot[src];
  w.sync.arrive_and_wait();
  return out;
}
inline float* shim_smem() { return shim::block->smem.data(); }

template <class Kernel, class... Args>
void shim_launch(dim3 grid, dim3 block, int smem_bytes, cudaStream_t, Kernel kernel,
                 Args... args) {
  for (unsigned b = 0; b < grid.x; ++b) {
    shim::Block blk(block.x, smem_bytes);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([&, t] {
        shim::block = &blk;
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        blockDim = block;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
"""


def _rewrite(source):
    """A .cu source for the shim: launches to ``shim_launch``, the dynamic
    shared memory to the block's buffer."""
    out, n = re.subn(r"(\w+(?:<[^;<>]*>)?)\s*<<<([^>]*)>>>\(", r"shim_launch(\2, \1, ", source)
    assert n > 0, "no launch found"
    out, n = re.subn(r"extern __shared__ float smem\[\];", "float* smem = shim_smem();", out)
    assert n > 0, "no dynamic shared memory found"
    return out


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the CPU rehearsal of the wide block body needs it")
    tmp = tmp_path_factory.mktemp("hi_wide_rehearsal")
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, tmp / header.name)
    (tmp / "cuda_runtime.h").write_text(_SHIM)
    objs = []
    for name in SOURCES:
        src = tmp / (name + ".cpp")
        src.write_text(_rewrite((CSRC / name).read_text()))
        objs.append(src)
    lib = tmp / "libhi_wide_rehearsal.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
         "-I", str(tmp), "-include", "cuda_runtime.h", *map(str, objs), "-o", str(lib)],
        capture_output=True, text=True, timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return ctypes.CDLL(str(lib))


def _start(N, nu, batch=LANES):
    """Experiment 4's kind of ensemble after the f64 Taylor init, toward t =
    2.5 (as ``tests/test_torch_kernels.py``'s card cases)."""
    vf, (y0,), _, _ = problems.brusselator(N)
    rng = np.random.default_rng(7)
    y0s = y0.numpy()[None] * (1.0 + 0.01 * rng.standard_normal((batch, 2 * N)))
    tols = torch.tensor(np.geomspace(1e-5, 1e-9, batch), dtype=torch.float32)
    save_at = np.linspace(0.0, 10.0, 5).astype(np.float32)
    state, inputs = batched_hi.initial_state(
        vf, torch.tensor(y0s.astype(np.float32)), (), save_at=save_at, dt0=1e-5, tols=tols,
        num_derivatives=nu)
    step = batched_hi.make_step_hi(batched_hi.wrap_vf_plain(vf, ()), nu=nu, d=2 * N)
    return step, tuple(x.contiguous() for x in state), torch.full((1, batch), 2.5), inputs


def _run(lib, kernel, step, state, t_next, inputs, max_attempts=None):
    """The C entry of ``kernel`` on CPU tensors, packed as
    ``kernels._launch`` packs them."""
    extra = (t_next, inputs["atol"], inputs["rtol"], inputs["dt_max"], inputs["dt_floor"],
             inputs["tiny_scale"])
    ins = [x.contiguous() for x in (*state, *extra)]
    outs = tuple(torch.empty_like(x) for x in state)
    ins_ptr = (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins))
    outs_ptr = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    consts = np.ascontiguousarray(step.packed_constants())
    fn = getattr(lib, f"odeckpt_{kernel}_brusselator_hi")
    head = [ctypes.c_int(step.nu), ctypes.c_void_p(ctypes.addressof(ins_ptr)),
            ctypes.c_void_p(ctypes.addressof(outs_ptr)), ctypes.c_void_p(consts.ctypes.data),
            ctypes.c_longlong(state[0].shape[-1]), ctypes.c_int(step.d)]
    if max_attempts is not None:
        head.append(ctypes.c_int(max_attempts))
    (c,) = step.functor_params
    rc = fn(*head, ctypes.c_float(c), ctypes.c_int(0), ctypes.c_void_p(0))
    assert rc == 0
    return outs


def _assert_same_bits(got, want, where):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        same = torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert same, f"{where}: array {i} differs, max |diff| {float((g - w).abs().max())}"


@pytest.mark.parametrize("nu", [4, 5])
@pytest.mark.parametrize("N", [4, 32])
def test_hi_wide_interval_body_matches_the_twin_bit_for_bit(rehearsal, N, nu):
    """K2 wide's source, 40 attempts a lane, against the twin's loop."""
    step, state, t_next, inputs = _start(N, nu)
    want = kernels.step_hi_wide_interval_plain(step, state, t_next, max_attempts=ATTEMPTS,
                                               **inputs)
    got = _run(rehearsal, "step_hi_wide_interval", step, state, t_next, inputs,
               max_attempts=ATTEMPTS)
    _assert_same_bits(got, want, f"K2 wide, d = {2 * N}, nu = {nu}")
    accepted = (want[11] - state[11])[0]
    assert float(accepted.max()) > 1  # the covariance work ran


@pytest.mark.parametrize("nu", [4, 5])
@pytest.mark.parametrize("N", [4, 32])
def test_hi_wide_attempt_body_matches_the_twin_bit_for_bit(rehearsal, N, nu):
    """K4 wide's source: one attempt, then 40 chained, against the twin's
    attempt."""
    step, state, t_next, inputs = _start(N, nu)
    k_state = p_state = state
    for k in range(ATTEMPTS):
        k_state = _run(rehearsal, "step_hi_wide_attempt", step, k_state, t_next, inputs)
        p_state = kernels.step_hi_wide_attempt_plain(step, p_state, t_next, **inputs)
        _assert_same_bits(k_state, p_state, f"K4 wide, d = {2 * N}, nu = {nu}, attempt {k}")
    assert float((p_state[11] - state[11]).max()) > 1
