// K4 wide: one attempt of K2 wide's df32 step (step_hi_wide.cuh) on every
// lane, one block per IVP lane, one thread per component.  Replaces
// odecheckpts_tpu/batched_hi.py:_pallas_step(make_step_hi) at d = 64 and 128,
// the per-attempt kernel of engine "pallas"; the host loop around it
// (kernels.attempt_loop with kernels.active_hi) syncs once per attempt.
// Lanes that are not active are frozen inside the step, so the kernel steps
// every lane unconditionally, as the Pallas kernel does.

#include "step_hi_wide.cuh"

namespace {

// MAXT and the launch bound as in step_hi_wide.cu.
template <int NU, int MAXT, class VF>
__global__ void __launch_bounds__(MAXT, 1)
    step_hi_wide_attempt(ArgsHi args, ConstsWide c, VF vf, int64_t B, int d) {
  constexpr int N = NU + 1;
  extern __shared__ float smem[];
  LaneWide& L = *reinterpret_cast<LaneWide*>(smem);
  float* rows = smem + WIDE_LANE_FLOATS;
  const int64_t b = blockIdx.x;
  ColumnHi<N> s;
  const LaneInputsHi in = load_lane_wide(L, s, args, c, b, B, d);
  int cur = 0;
  attempt_wide<NU, VF>(L, rows, s, c, vf, in, d, cur);
  store_lane_wide(L, s, args, b, B, d, cur);
}

// The instantiation that runs nu and d (launch bound wide_bound(d)), or
// nullptr where nu is not built.
template <class VF>
auto instantiation(int nu, int d) -> decltype(&step_hi_wide_attempt<4, WIDE_SMALL_THREADS, VF>) {
  const bool small = wide_bound(d) == WIDE_SMALL_THREADS;
  switch (nu) {
    case 4:
      return small ? step_hi_wide_attempt<4, WIDE_SMALL_THREADS, VF>
                   : step_hi_wide_attempt<4, WIDE_MAX_THREADS, VF>;
    case 5:
      return small ? step_hi_wide_attempt<5, WIDE_SMALL_THREADS, VF>
                   : step_hi_wide_attempt<5, WIDE_MAX_THREADS, VF>;
    default: return nullptr;
  }
}

template <class VF>
int launch(int nu, const void* in_ptrs, const void* out_ptrs, const void* consts,
           long long batch, int d, VF vf, int device, void* stream) {
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
  kernel<<<grid, block, smem, st>>>(args, c, vf, B, d);
  return static_cast<int>(cudaGetLastError());
}

template <class VF>
int report(int nu, int d, int* out) {
  const auto kernel = instantiation<VF>(nu, d);
  return kernel == nullptr ? static_cast<int>(cudaErrorInvalidValue)
                           : wide_report(kernel, d, out);
}

}  // namespace

// C interface: as odeckpt_step_hi_wide_interval_brusselator_hi, without
// max_attempts.
extern "C" int odeckpt_step_hi_wide_attempt_brusselator_hi(int nu, const void* in_ptrs,
                                                           const void* out_ptrs,
                                                           const void* consts, long long batch,
                                                           int d, float c, int device,
                                                           void* stream) {
  return launch(nu, in_ptrs, out_ptrs, consts, batch, d, BrusselatorRow{c}, device, stream);
}

// As odeckpt_step_hi_wide_interval_geometry, for this form.
extern "C" int odeckpt_step_hi_wide_attempt_geometry(int nu, int d, int* out) {
  return report<BrusselatorRow>(nu, d, out);
}
