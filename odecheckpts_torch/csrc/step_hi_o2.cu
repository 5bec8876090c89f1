// K2 on the vector fields of order 2, evaluated on the hi channel
// (step_hi.cuh: HiChannel over functors.cuh; batched_hi.wrap_vf_plain): one
// whole checkpoint interval of the df32 step, one IVP lane per thread, as
// step_hi.cu runs it for the rigid body.  Instantiated at nu = 4 for the
// restricted three-body problem (TS0; fixedpoint and filter) and for Van der
// Pol (TS0 and TS1; fixedpoint and filter), either error unit: the rtol 1e-7
// row of experiment 5 and the df32 rows of experiment 1
// (experiments/5_vs_interpolation/batched_tpu.py:80-93,
// experiments/1_van_der_pol/tpu_ensemble.py:62-76).
//
// Replaces odecheckpts_tpu/batched_hi.py:_pallas_interval(make_step_hi) with
// ode_order=2; the twin is odecheckpts_torch/batched_hi.py:StepHi.  What
// bounds it: as step_hi.cu, per-thread registers and latency.

#include "step_hi.cuh"

namespace {

template <int NU, class VF, bool FILTER, bool TS1>
__global__ void __launch_bounds__(THREADS)
    step_hi_interval(ArgsHi args, ConstsHi c, VF vf, int64_t B, int max_attempts) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;  // the ragged edge of the last block
  LaneHi<NU + 1, VF::D> s;
  const LaneInputsHi in = load_lane_hi(s, args, b, B);
  for (int k = 0; k < max_attempts && active_hi(s.t_hi, s.t_lo, in.t_next); ++k)
    attempt_hi<NU, VF, FILTER, TS1>(s, c, vf, in);
  store_lane_hi(s, args, b, B);
}

template <class VF>
int launch(int nu, int strategy, int ts1, const void* in_ptrs, const void* out_ptrs,
           const void* consts, long long batch, int max_attempts, VF vf, int device,
           void* stream) {
  ArgsHi args;
  ConstsHi c;
  unpack_hi(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_o2<VF>(nu, strategy, ts1, [&](auto s, auto t) {
    step_hi_interval<4, VF, decltype(s)::value == 2, decltype(t)::value>
        <<<lanes_grid(batch), THREADS, 0, st>>>(args, c, vf, batch, max_attempts);
    return cudaGetLastError();
  }));
}

}  // namespace

// C interface: as odeckpt_step_hi_interval_rigid_body_df, with the strategy
// code and the TS1 flag after nu, and the f32 functor's parameters.
extern "C" int odeckpt_step_hi_interval_three_body_restricted_hi(
    int nu, int strategy, int ts1, const void* in_ptrs, const void* out_ptrs,
    const void* consts, long long batch, int max_attempts, float mu, float mp, int device,
    void* stream) {
  return launch(nu, strategy, ts1, in_ptrs, out_ptrs, consts, batch, max_attempts,
                HiChannel<ThreeBodyRestricted>{{mu, mp}}, device, stream);
}

extern "C" int odeckpt_step_hi_interval_van_der_pol_hi(int nu, int strategy, int ts1,
                                                       const void* in_ptrs, const void* out_ptrs,
                                                       const void* consts, long long batch,
                                                       int max_attempts, float mu, int device,
                                                       void* stream) {
  return launch(nu, strategy, ts1, in_ptrs, out_ptrs, consts, batch, max_attempts,
                HiChannel<VanDerPol>{{mu}}, device, stream);
}
