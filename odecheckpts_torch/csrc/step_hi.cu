// K2: one whole checkpoint interval of the df32 step (step_hi.cuh), one IVP
// lane per thread.  Replaces odecheckpts_tpu/batched_hi.py:
// _pallas_interval(make_step_hi, num_state=12, active_fn=_active_hi), the
// Pallas kernel of the bench's df32 band.  The plain PyTorch twin is
// odecheckpts_torch/batched_hi.py:StepHi; kernels.py binds this file through
// ctypes.
//
// Why a per-thread loop gives the Pallas kernel's results: the Pallas kernel
// loops over a lane TILE while any lane of the tile is active by the
// pair-aware predicate t_hi < t_next || (t_hi == t_next && t_lo < 0) (and
// the tile's attempt count k < max_attempts).  A lane that is not active has
// a remainder rem = max((t_next - t_hi) - t_lo, 0) of 0 on the compensated
// axis, so the step freezes it: `accept` carries `~frozen`, and dt_out keeps
// the stored dt where `frozen`, so no field changes.  Steps never move t
// backwards (dt_mean >= 0) and never past t_next (they are clamped to the
// remainder), so a lane that stops being active stays inactive.  An active
// lane therefore makes exactly one attempt per tile iteration, and its own
// attempt count equals the tile's k while it is active; looping per lane
// while it is active and k < max_attempts leaves every lane in the state the
// tile loop leaves it in.  (As in K1, a lane whose time is NaN is neither
// active nor frozen: the tile loop would keep stepping it, this loop does
// not.  Such a lane is already lost.)

#include "step_hi.cuh"

namespace {

template <int NU, class VF>
__global__ void __launch_bounds__(THREADS)
    step_hi_interval(ArgsHi args, ConstsHi c, VF vf, int64_t B, int max_attempts) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;  // the ragged edge of the last block
  LaneHi<NU + 1, VF::D> s;
  const LaneInputsHi in = load_lane_hi(s, args, b, B);
  for (int k = 0; k < max_attempts && active_hi(s.t_hi, s.t_lo, in.t_next); ++k)
    attempt_hi<NU, VF>(s, c, vf, in);
  store_lane_hi(s, args, b, B);
}

template <class VF>
int launch(int nu, const void* in_ptrs, const void* out_ptrs, const void* consts,
           long long batch, int max_attempts, VF vf, int device, void* stream) {
  ArgsHi args;
  ConstsHi c;
  unpack_hi(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = lanes_grid(batch), block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t B = batch;
  switch (nu) {
    case 4: step_hi_interval<4, VF><<<grid, block, 0, st>>>(args, c, vf, B, max_attempts); break;
    case 5: step_hi_interval<5, VF><<<grid, block, 0, st>>>(args, c, vf, B, max_attempts); break;
    case 6: step_hi_interval<6, VF><<<grid, block, 0, st>>>(args, c, vf, B, max_attempts); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class VF>
int report(int nu, int* out) {
  switch (nu) {
    case 4: return lane_report(step_hi_interval<4, VF>, out);
    case 5: return lane_report(step_hi_interval<5, VF>, out);
    case 6: return lane_report(step_hi_interval<6, VF>, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface (bound with ctypes in kernels.py).  in_ptrs / out_ptrs point
// to host arrays of 18 / 12 device pointers in the lanes-last state order
// (batched_hi.NUM_STATE_HI, then t_next, atol, rtol, dt_max, dt_floor,
// tiny_scale), consts to the host float buffer of StepHi.packed_constants(),
// stream is a cudaStream_t.  Returns the cudaError_t of the launch.
extern "C" int odeckpt_step_hi_interval_rigid_body_df(int nu, const void* in_ptrs,
                                                      const void* out_ptrs, const void* consts,
                                                      long long batch, int max_attempts,
                                                      float p1, float p2, float p3, int device,
                                                      void* stream) {
  return launch(nu, in_ptrs, out_ptrs, consts, batch, max_attempts, RigidBodyDf{p1, p2, p3},
                device, stream);
}

// The launch geometry of this form for nu on the current device: out =
// threads per lane, lanes per block, threads per block, shared-memory bytes
// per block, resident blocks per SM (occupancy API), registers per thread,
// local (stack) bytes per thread.
extern "C" int odeckpt_step_hi_interval_geometry(int nu, int* out) {
  return report<RigidBodyDf>(nu, out);
}
