// K1: one whole checkpoint interval of the isotropic TS0 fixedpoint solver,
// one IVP lane per thread (the lane's previous arrays in shared memory).  The step body (run_lane) and the notes on what bounds it and why
// it matches its twin bit for bit are in step_ll.cuh.
//
// Replaces odecheckpts_tpu/batched.py:_pallas_interval(make_step_ll), the
// Pallas kernel of the f32 work-precision path.  The plain PyTorch twin is
// odecheckpts_torch/batched.py:StepLL; kernels.py binds this file through
// ctypes and compares nothing itself (the tests and chip_smoke.py do).
//
// Why a per-thread loop gives the Pallas kernel's results: the Pallas kernel
// loops over a lane TILE while any lane of the tile has t < t_next (and the
// tile's attempt count k < max_attempts).  A lane with t >= t_next is frozen
// inside the step (no field changes), and a lane that reaches t_next never
// leaves it (accepted steps only move t forward).  So an active lane makes
// exactly one attempt per tile iteration, and its own attempt count equals
// the tile's k while it is active.  Looping per lane until t >= t_next or k
// reaches max_attempts therefore leaves every lane in the same state.  (The
// one difference: a lane whose t is NaN is neither active nor frozen; the
// tile loop would keep stepping it while other lanes are active, this loop
// does not.  Such a lane is already lost.)

#include "step_ll.cuh"

namespace {

template <int NU, class VF>
__global__ void __launch_bounds__(THREADS)
    step_ll_interval(Args args, Consts c, VF vf, int64_t B, int max_attempts) {
  run_lane<NU, VF, true>(args, c, vf, B, max_attempts);
}

template <int NU, class VF>
cudaError_t launch_nu(cudaStream_t st, const Args& args, const Consts& c, VF vf, int64_t B,
                      int max_attempts) {
  constexpr int smem = prev_smem_bytes<NU, VF::D>();
  cudaError_t err = cudaFuncSetAttribute(step_ll_interval<NU, VF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  step_ll_interval<NU, VF><<<lanes_grid(B), THREADS, smem, st>>>(args, c, vf, B, max_attempts);
  return cudaGetLastError();
}

template <class VF>
int launch(int nu, const void* in_ptrs, const void* out_ptrs, const void* consts,
           long long batch, int max_attempts, VF vf, int device, void* stream) {
  Args args;
  Consts c;
  unpack(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nu) {
    case 2: err = launch_nu<2>(st, args, c, vf, batch, max_attempts); break;
    case 3: err = launch_nu<3>(st, args, c, vf, batch, max_attempts); break;
    case 4: err = launch_nu<4>(st, args, c, vf, batch, max_attempts); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <class VF>
int report(int nu, int* out) {
  switch (nu) {
    case 2: return lane_report(step_ll_interval<2, VF>, out, prev_smem_bytes<2, VF::D>());
    case 3: return lane_report(step_ll_interval<3, VF>, out, prev_smem_bytes<3, VF::D>());
    case 4: return lane_report(step_ll_interval<4, VF>, out, prev_smem_bytes<4, VF::D>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface (bound with ctypes in kernels.py).  in_ptrs / out_ptrs point
// to host arrays of 23 / 17 device pointers in the lanes-last state order
// (batched.NUM_STATE), consts to the host float buffer of
// StepLL.packed_constants(), stream is a cudaStream_t.  Returns the
// cudaError_t of the launch.
extern "C" int odeckpt_step_ll_interval_rigid_body(int nu, const void* in_ptrs,
                                                   const void* out_ptrs, const void* consts,
                                                   long long batch, int max_attempts, float p1,
                                                   float p2, float p3, int device, void* stream) {
  return launch(nu, in_ptrs, out_ptrs, consts, batch, max_attempts, RigidBody{p1, p2, p3},
                device, stream);
}

// The anisotropic rigid body takes (p1, p2, s3 * p3, s3): the isotropic foil
// of the blockdiag engine's row.
extern "C" int odeckpt_step_ll_interval_rigid_body_anisotropic(
    int nu, const void* in_ptrs, const void* out_ptrs, const void* consts, long long batch,
    int max_attempts, float p1, float p2, float p3, float p4, int device, void* stream) {
  return launch(nu, in_ptrs, out_ptrs, consts, batch, max_attempts,
                RigidBodyAniso{p1, p2, p3, p4}, device, stream);
}

// The launch geometry of this form for nu on the current device (the rigid
// body's entry): out = threads per lane, lanes per block, threads per block,
// shared-memory bytes per block, resident blocks per SM (occupancy API),
// registers per thread, local (stack) bytes per thread.
extern "C" int odeckpt_step_ll_interval_geometry(int nu, int* out) {
  return report<RigidBody>(nu, out);
}

extern "C" const char* odeckpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
