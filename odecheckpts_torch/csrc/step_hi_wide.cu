// K2 wide: one whole checkpoint interval of the df32 step for wide states
// (step_hi_wide.cuh), one block per IVP lane, one thread per component.
// Replaces odecheckpts_tpu/batched_hi.py:_pallas_interval(make_step_hi,
// num_state=12, active_fn=_active_hi) at d = 64 and 128 (experiment 4's
// batched Brusselator ensembles).  The plain PyTorch twin is
// odecheckpts_torch/batched_hi.py:StepHi; kernels.py binds this file through
// ctypes.
//
// The block loops while its lane is short of the checkpoint by the
// pair-aware predicate (active_hi) and fewer than max_attempts attempts ran:
// K2's per-lane loop (step_hi.cu says why that gives the Pallas kernel's
// results), with the lane's time read from shared memory after the
// attempt's last barrier, so every thread takes the same branch.

#include "step_hi_wide.cuh"

namespace {

// MAXT: the launch bound, WIDE_SMALL_THREADS or WIDE_MAX_THREADS (wide_bound);
// one resident block asked for (ptxas then gave K4 wide's nu = 4 form 117
// registers and no spill, against 96 registers and a 4-byte spill without it).
template <int NU, int MAXT, class VF>
__global__ void __launch_bounds__(MAXT, 1)
    step_hi_wide_interval(ArgsHi args, ConstsWide c, VF vf, int64_t B, int d, int max_attempts) {
  constexpr int N = NU + 1;
  extern __shared__ float smem[];
  LaneWide& L = *reinterpret_cast<LaneWide*>(smem);
  float* rows = smem + WIDE_LANE_FLOATS;
  const int64_t b = blockIdx.x;
  ColumnHi<N> s;
  const LaneInputsHi in = load_lane_wide(L, s, args, c, b, B, d);
  int cur = 0;
  for (int k = 0; k < max_attempts && active_hi(L.t_hi, L.t_lo, in.t_next); ++k)
    attempt_wide<NU, VF>(L, rows, s, c, vf, in, d, cur);
  store_lane_wide(L, s, args, b, B, d, cur);
}

// The instantiation that runs nu and d (launch bound wide_bound(d)), or
// nullptr where nu is not built.
template <class VF>
auto instantiation(int nu, int d) -> decltype(&step_hi_wide_interval<4, WIDE_SMALL_THREADS, VF>) {
  const bool small = wide_bound(d) == WIDE_SMALL_THREADS;
  switch (nu) {
    case 4:
      return small ? step_hi_wide_interval<4, WIDE_SMALL_THREADS, VF>
                   : step_hi_wide_interval<4, WIDE_MAX_THREADS, VF>;
    case 5:
      return small ? step_hi_wide_interval<5, WIDE_SMALL_THREADS, VF>
                   : step_hi_wide_interval<5, WIDE_MAX_THREADS, VF>;
    default: return nullptr;
  }
}

template <class VF>
int launch(int nu, const void* in_ptrs, const void* out_ptrs, const void* consts,
           long long batch, int d, int max_attempts, VF vf, int device, void* stream) {
  const auto kernel = instantiation<VF>(nu, d);
  if (d < 1 || d > WIDE_MAX_THREADS || kernel == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  ArgsHi args;
  ConstsWide c;
  unpack_hi(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch)), block(wide_threads(d));
  const int smem = wide_smem_bytes(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t B = batch;
  kernel<<<grid, block, smem, st>>>(args, c, vf, B, d, max_attempts);
  return static_cast<int>(cudaGetLastError());
}

template <class VF>
int report(int nu, int d, int* out) {
  const auto kernel = instantiation<VF>(nu, d);
  return kernel == nullptr ? static_cast<int>(cudaErrorInvalidValue)
                           : wide_report(kernel, d, out);
}

}  // namespace

// C interface (bound with ctypes in kernels.py): as
// odeckpt_step_hi_interval_rigid_body_df (step_hi.cu), with the ODE
// dimension d (even, 2 .. 1,024) after the batch; c is the Brusselator's
// diffusion constant.  One block per lane: batch blocks, on the instantiation
// of launch bound wide_bound(d) (128 threads for d <= 128, else 1,024).
extern "C" int odeckpt_step_hi_wide_interval_brusselator_hi(int nu, const void* in_ptrs,
                                                            const void* out_ptrs,
                                                            const void* consts, long long batch,
                                                            int d, int max_attempts, float c,
                                                            int device, void* stream) {
  return launch(nu, in_ptrs, out_ptrs, consts, batch, d, max_attempts, BrusselatorRow{c},
                device, stream);
}

// The launch geometry of this form for nu and d on the current device: out
// = threads per lane (d), lanes per block (1), threads per block, shared
// memory bytes per block, resident blocks per SM (occupancy API), registers
// per thread, local (stack) bytes per thread, the launch bound of the
// instantiation that d takes.
extern "C" int odeckpt_step_hi_wide_interval_geometry(int nu, int d, int* out) {
  return report<BrusselatorRow>(nu, d, out);
}
