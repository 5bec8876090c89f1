// K5, interval form: one whole checkpoint interval of the dense-covariance
// TS1 / TS0 fixedpoint solver, one IVP lane per thread.  The step body and
// the notes on its arithmetic are in step_dense.cuh.
//
// Replaces odecheckpts_tpu/batched_dense.py:703,
// _pallas_interval(make_step_dense_ll), the Pallas kernel of
// engine="pallas-loop" on the dense backend.  The plain PyTorch twin is
// odecheckpts_torch/batched_dense.py:StepDense; kernels.py binds this file
// through ctypes.
//
// What bounds it on the H100: not the state's bytes (2,487 floats a lane,
// read once and written once per launch) but each lane's long dependent
// chain of scalar operations on local memory.  An accepted attempt at
// nu = 4, d = 4 runs a (40, 40), a (20, 24) and a (40, 20) Householder QR,
// two triangular solves and three (20, 20) products, ~0.2 MFLOP, and
// touches its ~22 KB of working arrays many times over.  Those arrays do not
// fit in registers or L1, so they stream through L2 and device memory: at
// the full ensemble that traffic, not the state, is what the kernel waits
// on.  This first version accepts that; a warp-per-lane design with the
// lane's matrices in shared memory is the redesign (ROADMAP), at the price
// of parallel sums in another order than the twin's.
//
// Why a per-thread loop gives the Pallas kernel's results: the Pallas
// kernel loops over a lane TILE while any lane of the tile has t < t_next
// (and the tile's attempt count k < max_attempts).  A lane with
// t >= t_next is frozen inside the step: `accept` carries `~frozen` and
// `dt` keeps `dt_st` under `upd` (batched_dense.py:454-478), so no field
// changes; and a lane that reaches t_next never leaves it.  So an active
// lane makes exactly one attempt per tile iteration, and its own attempt
// count equals the tile's k while it is active: looping per lane until
// t >= t_next or k reaches max_attempts leaves every lane in the same state.
// (A lane whose t is NaN is neither active nor frozen; the tile loop would
// keep stepping it while other lanes are active, this loop does not.  Such
// a lane is already lost.)

#include "step_dense.cuh"

namespace {

template <int NU, bool TS1, class VF>
__global__ void __launch_bounds__(THREADS)
    step_dense_interval(Args args, Consts c, VF vf, int64_t B, int max_attempts) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;  // the ragged edge of the last block
  constexpr int ND = (NU + 1) * VF::D;
  LaneDense<ND> s;
  WorkDense<ND, VF::D> w;
  const LaneInputs in = load_lane_dense(s, args, b, B);
  for (int k = 0; k < max_attempts && s.t < in.t_next; ++k)
    attempt_dense<NU, TS1, VF>(s, w, c, vf, in);
  store_lane_dense(s, args, b, B);
}

template <class VF>
int launch(int nu, int ts1, const void* in_ptrs, const void* out_ptrs, const void* consts,
           long long batch, int max_attempts, VF vf, int device, void* stream) {
  Args args;
  Consts c;
  unpack(args, c, in_ptrs, out_ptrs, consts);
  if (nu != 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = lanes_grid(batch), block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t B = batch;
  if (ts1)
    step_dense_interval<4, true, VF><<<grid, block, 0, st>>>(args, c, vf, B, max_attempts);
  else
    step_dense_interval<4, false, VF><<<grid, block, 0, st>>>(args, c, vf, B, max_attempts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (bound with ctypes in kernels.py): as
// odeckpt_step_ll_interval_rigid_body, with ts1 (0 or 1) after nu.  The
// Brusselator functor (N = 2, d = 4) takes its diffusion constant as p1.
extern "C" int odeckpt_step_dense_interval_brusselator(int nu, int ts1, const void* in_ptrs,
                                                       const void* out_ptrs, const void* consts,
                                                       long long batch, int max_attempts,
                                                       float p1, float /*p2*/, float /*p3*/,
                                                       int device, void* stream) {
  return launch(nu, ts1, in_ptrs, out_ptrs, consts, batch, max_attempts, Brusselator<2>{p1},
                device, stream);
}

extern "C" int odeckpt_step_dense_interval_rigid_body(int nu, int ts1, const void* in_ptrs,
                                                      const void* out_ptrs, const void* consts,
                                                      long long batch, int max_attempts,
                                                      float p1, float p2, float p3, int device,
                                                      void* stream) {
  return launch(nu, ts1, in_ptrs, out_ptrs, consts, batch, max_attempts,
                RigidBody{p1, p2, p3}, device, stream);
}
