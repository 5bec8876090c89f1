// K6, interval form: one whole checkpoint interval of the blockdiag TS0
// fixedpoint solver, one IVP lane per thread.  The step body, the layout
// chosen and the notes on its arithmetic are in step_bd.cuh.
//
// Replaces odecheckpts_tpu/batched_blockdiag.py:481,
// _pallas_interval(make_step_bd_ll), the Pallas kernel of
// engine="pallas-loop" on the blockdiag backend.  The plain PyTorch twin is
// odecheckpts_torch/batched_blockdiag.py:StepBD; kernels.py binds this file
// through ctypes.
//
// What bounds it on the H100: as K1, each lane's dependent chain of scalar
// operations, d channels long, on a state that lives in local memory (521
// floats a lane at nu = 4, d = 3); the state's bytes are read once and
// written once per launch, and rejected attempts touch neither device
// memory nor the covariance arithmetic.
//
// Why a per-thread loop gives the Pallas kernel's results: see step_ll.cu.
// A lane with t >= t_next is frozen inside the step (`accept` carries
// `~frozen`, `dt` keeps `dt_st` under `upd`, batched_blockdiag.py:231-255),
// so looping per lane until t >= t_next or k reaches max_attempts leaves
// every lane in the state the tile loop leaves it in.

#include "step_bd.cuh"

namespace {

template <int NU, class VF>
__global__ void __launch_bounds__(THREADS)
    step_bd_interval(Args args, Consts c, VF vf, int64_t B, int max_attempts) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;  // the ragged edge of the last block
  LaneBD<NU + 1, VF::D> s;
  const LaneInputs in = load_lane_bd(s, args, b, B);
  for (int k = 0; k < max_attempts && s.t < in.t_next; ++k) attempt_bd<NU, VF>(s, c, vf, in);
  store_lane_bd(s, args, b, B);
}

template <class VF>
int launch(int nu, const void* in_ptrs, const void* out_ptrs, const void* consts,
           long long batch, int max_attempts, VF vf, int device, void* stream) {
  Args args;
  Consts c;
  unpack(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = lanes_grid(batch), block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t B = batch;
  switch (nu) {
    case 2: step_bd_interval<2, VF><<<grid, block, 0, st>>>(args, c, vf, B, max_attempts); break;
    case 3: step_bd_interval<3, VF><<<grid, block, 0, st>>>(args, c, vf, B, max_attempts); break;
    case 4: step_bd_interval<4, VF><<<grid, block, 0, st>>>(args, c, vf, B, max_attempts); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
