// K5, interval form: one whole checkpoint interval of the dense-covariance
// TS1 / TS0 fixedpoint solver, one warp per IVP lane, a block per tile of
// consecutive lanes.  The step body, the shared-memory layout and the notes
// on its arithmetic are in step_dense.cuh.
//
// Replaces odecheckpts_tpu/batched_dense.py:703,
// _pallas_interval(make_step_dense_ll), the Pallas kernel of
// engine="pallas-loop" on the dense backend.  The plain PyTorch twin is
// odecheckpts_torch/batched_dense.py:StepDense; kernels.py binds this file
// through ctypes.
//
// What bounds it on the H100: not the state's bytes (2,487 floats a lane,
// read once and written once per launch) but each lane's work.  An accepted
// attempt at nu = 4, d = 4 runs a (40, 40), a (20, 24) and a (40, 20)
// Householder QR, two triangular solves and three (20, 20) products, ~0.2
// MFLOP, on 18,272 bytes of arrays.  The first design kept those arrays per
// thread in local memory, which streamed through L2 and device memory at
// every QR pass (302 ms an interval at 32,768 lanes).  Here they live in
// shared memory, one warp per lane, so a reflection's column updates run
// side by side and nothing leaves the SM between the tile's load and its
// store.  What is left: the instructions a warp runs per reflection (its
// 2nd-term norm and each column's 2nd-term dot product stay serial, in the
// twin's order, and a column round costs the same however few columns are
// left), the shared-memory traffic of the column rounds, and the 12 lanes an
// SM's shared memory holds (chip_smoke.py phases 2 and 12; PERF.md).
//
// Why a per-lane loop gives the Pallas kernel's results: the Pallas
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
__global__ void __launch_bounds__(WARP * DENSE_LANES_MAX, 1)
    step_dense_interval(Args args, Consts c, VF vf, int64_t B, int max_attempts) {
  run_tile_dense<NU, TS1, VF>(args, c, vf, B, max_attempts);
}

// Lanes per block: 6, two blocks an SM (measured on the H100 against 4, 8
// and 12: a block ends with its slowest lane, and a second block fills an
// SM while one drains).  g_lanes: the tile of later launches; 0, the default.
constexpr int LANES = 6;
int g_lanes = 0;

template <class VF>
DenseGeometry geometry() {
  return dense_geometry<5 * VF::D, VF::D>(g_lanes, LANES);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t B = batch;
  const DenseGeometry g = geometry<VF>();
  if (ts1)
    err = launch_dense(step_dense_interval<4, true, VF>, g, batch, st, args, c, vf, B,
                       max_attempts);
  else
    err = launch_dense(step_dense_interval<4, false, VF>, g, batch, st, args, c, vf, B,
                       max_attempts);
  return static_cast<int>(err);
}

template <class VF>
int report(int ts1, int* out) {
  DenseGeometry g = geometry<VF>();
  const cudaError_t err = ts1 ? dense_occupancy(step_dense_interval<4, true, VF>, g)
                              : dense_occupancy(step_dense_interval<4, false, VF>, g);
  out[0] = g.lanes;
  out[1] = g.threads;
  out[2] = g.smem;
  out[3] = g.blocks_per_sm;
  return static_cast<int>(err);
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

// The launch geometry of this form at nu = 4 for the functor of dimension d
// (4: Brusselator, 3: rigid body) on the current device: out = lanes per
// block, threads per block, dynamic shared-memory bytes, resident blocks per
// SM.  lanes_per_block > 0 makes it the tile of every later launch of this
// form (a measurement hook), 0 restores the default, < 0 leaves it.
extern "C" int odeckpt_step_dense_interval_geometry(int d, int ts1, int lanes_per_block,
                                                    int* out) {
  if (lanes_per_block > DENSE_LANES_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes_per_block >= 0) g_lanes = lanes_per_block;
  if (d == 4) return report<Brusselator<2>>(ts1, out);
  if (d == 3) return report<RigidBody>(ts1, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
