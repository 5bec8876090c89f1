// K4: one attempt of K2's df32 step (step_hi.cuh) on every lane, one IVP
// lane per thread.  Replaces odecheckpts_tpu/batched_hi.py:
// _pallas_step(make_step_hi), the per-attempt kernel of engine "pallas"; the
// host loop around it (kernels.attempt_loop with kernels.active_hi) syncs
// once per attempt.  Every launch reads and writes the whole 12-array state;
// what bounds this engine is the launch, that round trip and the sync.
// Lanes that are not active are frozen inside the step, so the kernel steps
// every lane unconditionally, as the Pallas kernel does.

#include "step_hi.cuh"

namespace {

template <int NU, class VF>
__global__ void __launch_bounds__(THREADS)
    step_hi_attempt(ArgsHi args, ConstsHi c, VF vf, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;
  LaneHi<NU + 1, VF::D> s;
  const LaneInputsHi in = load_lane_hi(s, args, b, B);
  attempt_hi<NU, VF>(s, c, vf, in);
  store_lane_hi(s, args, b, B);
}

template <class VF>
int launch(int nu, const void* in_ptrs, const void* out_ptrs, const void* consts,
           long long batch, VF vf, int device, void* stream) {
  ArgsHi args;
  ConstsHi c;
  unpack_hi(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = lanes_grid(batch), block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t B = batch;
  switch (nu) {
    case 4: step_hi_attempt<4, VF><<<grid, block, 0, st>>>(args, c, vf, B); break;
    case 5: step_hi_attempt<5, VF><<<grid, block, 0, st>>>(args, c, vf, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class VF>
int report(int nu, int* out) {
  switch (nu) {
    case 4: return lane_report(step_hi_attempt<4, VF>, out);
    case 5: return lane_report(step_hi_attempt<5, VF>, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface: as odeckpt_step_hi_interval_rigid_body_df, without max_attempts.
extern "C" int odeckpt_step_hi_attempt_rigid_body_df(int nu, const void* in_ptrs,
                                                     const void* out_ptrs, const void* consts,
                                                     long long batch, float p1, float p2,
                                                     float p3, int device, void* stream) {
  return launch(nu, in_ptrs, out_ptrs, consts, batch, RigidBodyDf{p1, p2, p3}, device, stream);
}

// As odeckpt_step_hi_interval_geometry, for this form.
extern "C" int odeckpt_step_hi_attempt_geometry(int nu, int* out) {
  return report<RigidBodyDf>(nu, out);
}
