// K1 on the vector fields of order 2 (functors.cuh): one whole checkpoint
// interval of the isotropic f32 step, one IVP lane per thread, as step_ll.cu
// runs it for the rigid body.  Instantiated at nu = 4 for the restricted
// three-body problem (TS0; fixedpoint and filter) and for Van der Pol (TS0
// and TS1; fixedpoint and filter): experiments 5 and 1 of the reference
// (experiments/5_vs_interpolation/batched_tpu.py:65-125,
// experiments/1_van_der_pol/tpu_ensemble.py:47-90).  The error unit is the
// constants' residual flag, so both units share an instantiation.  A file of
// its own, so that nvcc builds it beside step_ll.cu.
//
// Replaces odecheckpts_tpu/batched.py:_pallas_interval(make_step_ll) with
// ode_order=2 (and correction "ts1", strategy "filter", error_unit
// "residual"); the twin is odecheckpts_torch/batched.py:StepLL made with the
// same options.  What bounds it and why it matches the twin bit for bit:
// step_ll.cuh and step_ll.cu.

#include "step_ll.cuh"

namespace {

template <int NU, class VF, int STRATEGY, bool TS1>
__global__ void __launch_bounds__(THREADS)
    step_ll_interval(Args args, Consts c, VF vf, int64_t B, int max_attempts) {
  run_lane<NU, VF, true, STRATEGY, TS1>(args, c, vf, B, max_attempts);
}

template <class VF>
int launch(int nu, int strategy, int ts1, const void* in_ptrs, const void* out_ptrs,
           const void* consts, long long batch, int max_attempts, VF vf, int device,
           void* stream) {
  Args args;
  Consts c;
  unpack(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_o2<VF>(nu, strategy, ts1, [&](auto s, auto t) {
    constexpr int smem = prev_smem_bytes<4, VF::D>();
    auto kernel = step_ll_interval<4, VF, decltype(s)::value, decltype(t)::value>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<lanes_grid(batch), THREADS, smem, st>>>(args, c, vf, batch, max_attempts);
    return cudaGetLastError();
  }));
}

}  // namespace

// C interface: as odeckpt_step_ll_interval_rigid_body, with the strategy
// code (0 fixedpoint, 2 filter: kernels.STRATEGY_CODES) and the TS1 flag
// after nu, and the functor's parameters: (mu, mp) for the three-body
// problem, (mu) for Van der Pol.
extern "C" int odeckpt_step_ll_interval_three_body_restricted(
    int nu, int strategy, int ts1, const void* in_ptrs, const void* out_ptrs,
    const void* consts, long long batch, int max_attempts, float mu, float mp, int device,
    void* stream) {
  return launch(nu, strategy, ts1, in_ptrs, out_ptrs, consts, batch, max_attempts,
                ThreeBodyRestricted{mu, mp}, device, stream);
}

extern "C" int odeckpt_step_ll_interval_van_der_pol(int nu, int strategy, int ts1,
                                                    const void* in_ptrs, const void* out_ptrs,
                                                    const void* consts, long long batch,
                                                    int max_attempts, float mu, int device,
                                                    void* stream) {
  return launch(nu, strategy, ts1, in_ptrs, out_ptrs, consts, batch, max_attempts,
                VanDerPol{mu}, device, stream);
}
