// K3 on the vector fields of order 2 (functors.cuh): one attempt of the
// isotropic f32 step on every lane, one IVP lane per thread, as
// step_ll_attempt.cu runs it for the rigid body; the host loop around it is
// kernels.attempt_loop.  Instantiated as step_ll_o2.cu is (nu = 4; the
// three-body problem under TS0, Van der Pol under TS0 and TS1; fixedpoint and
// filter; either error unit).
//
// Replaces odecheckpts_tpu/batched.py:_pallas_step(make_step_ll) with
// ode_order=2; the twin is odecheckpts_torch/batched.py:StepLL.  What bounds
// it: as step_ll_attempt.cu, the launch and the state's round trip through
// device memory.

#include "step_ll.cuh"

namespace {

template <int NU, class VF, int STRATEGY, bool TS1>
__global__ void __launch_bounds__(THREADS)
    step_ll_attempt(Args args, Consts c, VF vf, int64_t B) {
  run_lane<NU, VF, false, STRATEGY, TS1>(args, c, vf, B, 1);
}

template <class VF>
int launch(int nu, int strategy, int ts1, const void* in_ptrs, const void* out_ptrs,
           const void* consts, long long batch, VF vf, int device, void* stream) {
  Args args;
  Consts c;
  unpack(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_o2<VF>(nu, strategy, ts1, [&](auto s, auto t) {
    constexpr int smem = prev_smem_bytes<4, VF::D>();
    auto kernel = step_ll_attempt<4, VF, decltype(s)::value, decltype(t)::value>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<lanes_grid(batch), THREADS, smem, st>>>(args, c, vf, batch);
    return cudaGetLastError();
  }));
}

}  // namespace

// C interface: as odeckpt_step_ll_interval_three_body_restricted and
// odeckpt_step_ll_interval_van_der_pol, without max_attempts.
extern "C" int odeckpt_step_ll_attempt_three_body_restricted(
    int nu, int strategy, int ts1, const void* in_ptrs, const void* out_ptrs,
    const void* consts, long long batch, float mu, float mp, int device, void* stream) {
  return launch(nu, strategy, ts1, in_ptrs, out_ptrs, consts, batch,
                ThreeBodyRestricted{mu, mp}, device, stream);
}

extern "C" int odeckpt_step_ll_attempt_van_der_pol(int nu, int strategy, int ts1,
                                                   const void* in_ptrs, const void* out_ptrs,
                                                   const void* consts, long long batch,
                                                   float mu, int device, void* stream) {
  return launch(nu, strategy, ts1, in_ptrs, out_ptrs, consts, batch, VanDerPol{mu},
                device, stream);
}
