// K5, attempt form: one attempt of the dense step (step_dense.cuh) on every
// lane, one warp per IVP lane, a block per tile of consecutive lanes.
// Replaces odecheckpts_tpu/batched_dense.py:710,
// _pallas_step(make_step_dense_ll), the per-attempt kernel of
// engine="pallas"; the host loop around it is kernels.attempt_loop.
//
// Every launch reads and writes the whole dense state (2,487 floats a lane
// at nu = 4, d = 4, 652 MB at 32,768 lanes) and the host syncs once per
// attempt: the state's round trip through device memory, the launch and the
// sync bound this engine, on top of one attempt's chain (see step_dense.cu).
// The tile's cooperative load and store read and write each element of
// consecutive lanes as one run of consecutive words, so whole 32-byte
// sectors move (8 lanes or more a tile).  Lanes at the checkpoint are frozen
// inside the step, so the kernel steps every lane unconditionally, as the
// Pallas kernel does.

#include "step_dense.cuh"

namespace {

template <int NU, bool TS1, class VF>
__global__ void __launch_bounds__(WARP * DENSE_LANES_MAX, 1)
    step_dense_attempt(Args args, Consts c, VF vf, int64_t B) {
  run_tile_dense<NU, TS1, VF>(args, c, vf, B, 1);
}

// Lanes per block: 12, one block an SM (the fastest tile measured on the
// H100; each element of the tile is a run of 48 bytes).  g_lanes: the tile
// of later launches; 0, the default.
constexpr int LANES = 12;
int g_lanes = 0;

template <class VF>
DenseGeometry geometry() {
  return dense_geometry<5 * VF::D, VF::D>(g_lanes, LANES);
}

template <class VF>
int launch(int nu, int ts1, const void* in_ptrs, const void* out_ptrs, const void* consts,
           long long batch, VF vf, int device, void* stream) {
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
    err = launch_dense(step_dense_attempt<4, true, VF>, g, batch, st, args, c, vf, B);
  else
    err = launch_dense(step_dense_attempt<4, false, VF>, g, batch, st, args, c, vf, B);
  return static_cast<int>(err);
}

template <class VF>
int report(int ts1, int* out) {
  DenseGeometry g = geometry<VF>();
  const cudaError_t err = ts1 ? dense_occupancy(step_dense_attempt<4, true, VF>, g)
                              : dense_occupancy(step_dense_attempt<4, false, VF>, g);
  out[0] = g.lanes;
  out[1] = g.threads;
  out[2] = g.smem;
  out[3] = g.blocks_per_sm;
  return static_cast<int>(err);
}

}  // namespace

// C interface: as odeckpt_step_dense_interval_*, without max_attempts.
extern "C" int odeckpt_step_dense_attempt_brusselator(int nu, int ts1, const void* in_ptrs,
                                                      const void* out_ptrs, const void* consts,
                                                      long long batch, float p1, float /*p2*/,
                                                      float /*p3*/, int device, void* stream) {
  return launch(nu, ts1, in_ptrs, out_ptrs, consts, batch, Brusselator<2>{p1}, device, stream);
}

extern "C" int odeckpt_step_dense_attempt_rigid_body(int nu, int ts1, const void* in_ptrs,
                                                     const void* out_ptrs, const void* consts,
                                                     long long batch, float p1, float p2,
                                                     float p3, int device, void* stream) {
  return launch(nu, ts1, in_ptrs, out_ptrs, consts, batch, RigidBody{p1, p2, p3}, device,
                stream);
}

// As odeckpt_step_dense_interval_geometry, for this form.
extern "C" int odeckpt_step_dense_attempt_geometry(int d, int ts1, int lanes_per_block,
                                                   int* out) {
  if (lanes_per_block > DENSE_LANES_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes_per_block >= 0) g_lanes = lanes_per_block;
  if (d == 4) return report<Brusselator<2>>(ts1, out);
  if (d == 3) return report<RigidBody>(ts1, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
