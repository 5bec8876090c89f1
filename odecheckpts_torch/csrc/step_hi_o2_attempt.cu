// K4 on the vector fields of order 2, evaluated on the hi channel: one
// attempt of the df32 step on every lane, one IVP lane per thread, as
// step_hi_attempt.cu runs it for the rigid body.  Instantiated as
// step_hi_o2.cu is.
//
// Replaces odecheckpts_tpu/batched_hi.py:_pallas_step(make_step_hi) with
// ode_order=2; the twin is odecheckpts_torch/batched_hi.py:StepHi.

#include "step_hi.cuh"

namespace {

template <int NU, class VF, bool FILTER, bool TS1>
__global__ void __launch_bounds__(THREADS)
    step_hi_attempt(ArgsHi args, ConstsHi c, VF vf, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;
  LaneHi<NU + 1, VF::D> s;
  const LaneInputsHi in = load_lane_hi(s, args, b, B);
  attempt_hi<NU, VF, FILTER, TS1>(s, c, vf, in);
  store_lane_hi(s, args, b, B);
}

template <class VF>
int launch(int nu, int strategy, int ts1, const void* in_ptrs, const void* out_ptrs,
           const void* consts, long long batch, VF vf, int device, void* stream) {
  ArgsHi args;
  ConstsHi c;
  unpack_hi(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_o2<VF>(nu, strategy, ts1, [&](auto s, auto t) {
    step_hi_attempt<4, VF, decltype(s)::value == 2, decltype(t)::value>
        <<<lanes_grid(batch), THREADS, 0, st>>>(args, c, vf, batch);
    return cudaGetLastError();
  }));
}

}  // namespace

// C interface: as odeckpt_step_hi_interval_three_body_restricted_hi and
// odeckpt_step_hi_interval_van_der_pol_hi, without max_attempts.
extern "C" int odeckpt_step_hi_attempt_three_body_restricted_hi(
    int nu, int strategy, int ts1, const void* in_ptrs, const void* out_ptrs,
    const void* consts, long long batch, float mu, float mp, int device, void* stream) {
  return launch(nu, strategy, ts1, in_ptrs, out_ptrs, consts, batch,
                HiChannel<ThreeBodyRestricted>{{mu, mp}}, device, stream);
}

extern "C" int odeckpt_step_hi_attempt_van_der_pol_hi(int nu, int strategy, int ts1,
                                                      const void* in_ptrs, const void* out_ptrs,
                                                      const void* consts, long long batch,
                                                      float mu, int device, void* stream) {
  return launch(nu, strategy, ts1, in_ptrs, out_ptrs, consts, batch,
                HiChannel<VanDerPol>{{mu}}, device, stream);
}
