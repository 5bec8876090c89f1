"""A stand-in for ``cuda_runtime.h`` that compiles the port's CUDA sources
with g++ for the CPU (a helper of the rehearsal tests, not a test module:
pytest collects no test from it).

``SHIM`` is ``-include``d first (nvcc knows ``__device__`` and the rest
without a header): a launch runs its blocks one after the other, each
block's threads as ``std::thread``s; ``threadIdx`` / ``blockIdx`` /
``blockDim`` are thread-locals; ``__syncthreads`` is a ``std::barrier`` of
the block, ``__syncwarp`` one of the warp, and ``__shfl_sync`` (with its
``width``) a slot per lane between two waits at the warp's barrier; dynamic
shared memory is a buffer per block; ``expf`` and ``logf`` are taken in
float64 and rounded once, as ``odecheckpts_torch.rounded`` gives the CPU
twin.  ``build`` rewrites the triple-chevron launches to the shim's launch
and compiles with ``g++ -O1 -ffp-contract=off`` (every operation rounded on
its own, as nvcc's ``-fmad=false``) into one shared library.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

SHIM = r"""
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
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  shim::Warp& w = shim_warp();
  const unsigned lane = threadIdx.x % 32;
  w.slot[lane] = v;
  w.sync.arrive_and_wait();
  const float out = w.slot[lane / width * width + src % width];
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


def rewrite(source):
    """A .cu source for the shim: launches to ``shim_launch``, the dynamic
    shared memory (where there is any) to the block's buffer."""
    out, n = re.subn(r"(\w+(?:<[^;<>]*>)?)\s*<<<([^>]*)>>>\(", r"shim_launch(\2, \1, ", source)
    assert n > 0, "no launch found"
    return re.sub(r"extern __shared__ float smem\[\];", "float* smem = shim_smem();", out)


def build(csrc, sources, tmp, name, edit=None, flags=()):
    """Compile ``sources`` (names under ``csrc``, each passed through
    ``edit`` first where given, then ``rewrite``) against the shim, with
    g++'s extra ``flags`` (``-D`` defines), into ``tmp/lib<name>.so`` and load
    it; None where g++ is absent."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    tmp = Path(tmp)
    for header in Path(csrc).glob("*.cuh"):
        shutil.copy(header, tmp / header.name)
    (tmp / "cuda_runtime.h").write_text(SHIM)
    objs = []
    for src_name in sources:
        text = (Path(csrc) / src_name).read_text()
        src = tmp / (src_name + ".cpp")
        src.write_text(rewrite(edit(text) if edit else text))
        objs.append(src)
    lib = tmp / f"lib{name}.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
         "-I", str(tmp), "-include", "cuda_runtime.h", *flags, *map(str, objs), "-o", str(lib)],
        capture_output=True, text=True, timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return ctypes.CDLL(str(lib))
