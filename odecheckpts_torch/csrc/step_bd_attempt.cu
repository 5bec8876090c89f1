// K6, attempt form: one attempt of the blockdiag step (step_bd.cuh) on every
// lane, one IVP lane per thread.  Replaces
// odecheckpts_tpu/batched_blockdiag.py:488, _pallas_step(make_step_bd_ll),
// the per-attempt kernel of engine "pallas" on the blockdiag backend; the
// host loop around it is kernels.attempt_loop.
//
// Every launch reads and writes the whole 17-array state (521 floats a lane
// at nu = 4, d = 3) and the host syncs once per attempt: what bounds this
// engine is the launch, the state's round trip through device memory and
// the sync.  Lanes at the checkpoint are frozen inside the step, so the
// kernel steps every lane unconditionally, as the Pallas kernel does.

#include "step_bd.cuh"

namespace {

template <int NU, class VF>
__global__ void __launch_bounds__(THREADS) step_bd_attempt(Args args, Consts c, VF vf, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;
  LaneBD<NU + 1, VF::D> s;
  const LaneInputs in = load_lane_bd(s, args, b, B);
  attempt_bd<NU, VF>(s, c, vf, in);
  store_lane_bd(s, args, b, B);
}

template <class VF>
int launch(int nu, const void* in_ptrs, const void* out_ptrs, const void* consts,
           long long batch, VF vf, int device, void* stream) {
  Args args;
  Consts c;
  unpack(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = lanes_grid(batch), block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t B = batch;
  switch (nu) {
    case 2: step_bd_attempt<2, VF><<<grid, block, 0, st>>>(args, c, vf, B); break;
    case 3: step_bd_attempt<3, VF><<<grid, block, 0, st>>>(args, c, vf, B); break;
    case 4: step_bd_attempt<4, VF><<<grid, block, 0, st>>>(args, c, vf, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: as the entries of step_bd.cu, without max_attempts.
extern "C" int odeckpt_step_bd_attempt_rigid_body(int nu, const void* in_ptrs,
                                                  const void* out_ptrs, const void* consts,
                                                  long long batch, float p1, float p2, float p3,
                                                  float p4, int device, void* stream) {
  return launch(nu, in_ptrs, out_ptrs, consts, batch, make_functor<RigidBody>(p1, p2, p3, p4),
                device, stream);
}

extern "C" int odeckpt_step_bd_attempt_rigid_body_anisotropic(
    int nu, const void* in_ptrs, const void* out_ptrs, const void* consts, long long batch,
    float p1, float p2, float p3, float p4, int device, void* stream) {
  return launch(nu, in_ptrs, out_ptrs, consts, batch,
                make_functor<RigidBodyAniso>(p1, p2, p3, p4), device, stream);
}
