// K5, attempt form: one attempt of the dense step (step_dense.cuh) on every
// lane, one IVP lane per thread.  Replaces
// odecheckpts_tpu/batched_dense.py:710, _pallas_step(make_step_dense_ll),
// the per-attempt kernel of engine="pallas"; the host loop around it is
// kernels.attempt_loop.
//
// Every launch reads and writes the whole dense state (2,487 floats a lane
// at nu = 4, d = 4) and the host syncs once per attempt: the launch, the
// state's round trip through device memory and the sync bound this engine,
// on top of the step itself (see step_dense.cu).  Lanes at the checkpoint
// are frozen inside the step, so the kernel steps every lane
// unconditionally, as the Pallas kernel does.

#include "step_dense.cuh"

namespace {

template <int NU, bool TS1, class VF>
__global__ void __launch_bounds__(THREADS)
    step_dense_attempt(Args args, Consts c, VF vf, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;
  constexpr int ND = (NU + 1) * VF::D;
  LaneDense<ND> s;
  WorkDense<ND, VF::D> w;
  const LaneInputs in = load_lane_dense(s, args, b, B);
  attempt_dense<NU, TS1, VF>(s, w, c, vf, in);
  store_lane_dense(s, args, b, B);
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
  const dim3 grid = lanes_grid(batch), block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t B = batch;
  if (ts1)
    step_dense_attempt<4, true, VF><<<grid, block, 0, st>>>(args, c, vf, B);
  else
    step_dense_attempt<4, false, VF><<<grid, block, 0, st>>>(args, c, vf, B);
  return static_cast<int>(cudaGetLastError());
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
