// K6, interval form: one whole checkpoint interval of the blockdiag TS0
// fixedpoint solver, one thread per (IVP lane, channel), a tile of 32 lanes
// in D warps a block.  The step body (run_bd) and the notes on its
// layout and arithmetic are in step_bd.cuh.
//
// Replaces odecheckpts_tpu/batched_blockdiag.py:481,
// _pallas_interval(make_step_bd_ll), the Pallas kernel of
// engine="pallas-loop" on the blockdiag backend.  The plain PyTorch twin is
// odecheckpts_torch/batched_blockdiag.py:StepBD; kernels.py binds this file
// through ctypes.
//
// What bounds it on the H100: how many warps an SM keeps in flight against
// each thread's dependent chain of scalar operations (an accepted attempt
// at nu = 4 is ~2,900 operations of the algorithm per channel, several
// thousand instructions of unrolled code, every multiply and add issued on
// its own under -fmad=false).  The working arrays of an accepted attempt
// take up to 168 registers a thread, which leaves four tiles, twelve warps,
// an SM; a tile's slots and inputs take 36,480 bytes of shared memory at
// nu = 4 (PERF.md, chip_smoke.py phase 2).  The state is read once per
// launch and written once, besides the previous values an accepted attempt
// stores; rejected attempts touch neither device memory nor the covariance
// arithmetic.
//
// Why the warp loop gives the Pallas kernel's results: the Pallas kernel
// loops over a lane TILE while any lane of the tile has t < t_next.  A lane
// with t >= t_next is frozen inside the step (`accept` carries `~frozen`,
// `dt` keeps `dt_st` under `upd`, batched_blockdiag.py:231-255), and a lane
// that reaches t_next never leaves it.  Here every warp loops while any of
// its lanes has t < t_next (and k < max_attempts), and a lane that does not
// is left as it is (NaN t included, as the first design's per-lane loop
// left it), so each lane makes exactly the attempts of a per-lane loop
// until t >= t_next or k reaches max_attempts.  The D warps of a tile hold
// the same lanes with bit-identical lane scalars, so they agree on every
// loop test and reach the exchange's block barrier equally often.

#include "step_bd.cuh"

namespace {

template <int NU, class VF>
__global__ void __launch_bounds__(bd_threads_per_block(VF::D), BD_MIN_BLOCKS)
    step_bd_interval(Args args, Consts c, VF vf, int64_t B, int max_attempts) {
  run_bd<NU, VF, true>(args, c, vf, B, max_attempts);
}

template <int NU, class VF>
cudaError_t launch_nu(cudaStream_t st, const Args& args, const Consts& c, VF vf, int64_t B,
                      int max_attempts) {
  return launch_bd(step_bd_interval<NU, VF>, VF::D, bd_smem_bytes<NU, VF::D>(), B, st, args, c,
                   vf, B, max_attempts);
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
    case 2: return bd_report<VF>(step_bd_interval<2, VF>, bd_smem_bytes<2, VF::D>(), out);
    case 3: return bd_report<VF>(step_bd_interval<3, VF>, bd_smem_bytes<3, VF::D>(), out);
    case 4: return bd_report<VF>(step_bd_interval<4, VF>, bd_smem_bytes<4, VF::D>(), out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface (bound with ctypes in kernels.py): as
// odeckpt_step_ll_interval_rigid_body, with a fourth functor parameter.  The
// anisotropic rigid body takes (p1, p2, s3 * p3, s3).
extern "C" int odeckpt_step_bd_interval_rigid_body(int nu, const void* in_ptrs,
                                                   const void* out_ptrs, const void* consts,
                                                   long long batch, int max_attempts, float p1,
                                                   float p2, float p3, float p4, int device,
                                                   void* stream) {
  return launch(nu, in_ptrs, out_ptrs, consts, batch, max_attempts,
                make_functor<RigidBody>(p1, p2, p3, p4), device, stream);
}

extern "C" int odeckpt_step_bd_interval_rigid_body_anisotropic(
    int nu, const void* in_ptrs, const void* out_ptrs, const void* consts, long long batch,
    int max_attempts, float p1, float p2, float p3, float p4, int device, void* stream) {
  return launch(nu, in_ptrs, out_ptrs, consts, batch, max_attempts,
                make_functor<RigidBodyAniso>(p1, p2, p3, p4), device, stream);
}

// The launch geometry of this form for nu and the functor (1: anisotropic
// rigid body, 0: rigid body) on the current device: out = threads per lane,
// lanes per block, threads per block, shared-memory bytes per block (static
// and dynamic), resident blocks per SM (occupancy API), registers per
// thread, local (stack) bytes per thread.
extern "C" int odeckpt_step_bd_interval_geometry(int nu, int anisotropic, int* out) {
  return anisotropic ? report<RigidBodyAniso>(nu, out) : report<RigidBody>(nu, out);
}
