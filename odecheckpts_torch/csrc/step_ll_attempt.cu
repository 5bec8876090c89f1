// K3: one attempt of K1's f32 step (step_ll.cuh, run_lane) on every lane,
// one IVP lane per thread.  Replaces
// odecheckpts_tpu/batched.py:_pallas_step(make_step_ll), the per-attempt
// kernel of engine "pallas"; the host loop around it is kernels.attempt_loop.
//
// Every launch reads and writes the whole 17-array state (217 floats a lane
// at nu = 4, d = 3) and the host syncs once per attempt to test whether any
// lane is still short of the checkpoint: what bounds this engine is the
// launch, the state's round trip through device memory and the sync, not the
// arithmetic.  That is the nature of the per-attempt engine; K1 exists to
// avoid it.  Lanes at the checkpoint are frozen inside the step, so the
// kernel steps every lane unconditionally, as the Pallas kernel does.

#include "step_ll.cuh"

namespace {

template <int NU, class VF>
__global__ void __launch_bounds__(THREADS)
    step_ll_attempt(Args args, Consts c, VF vf, int64_t B) {
  run_lane<NU, VF, false>(args, c, vf, B, 1);
}

template <int NU, class VF>
cudaError_t launch_nu(cudaStream_t st, const Args& args, const Consts& c, VF vf, int64_t B) {
  constexpr int smem = prev_smem_bytes<NU, VF::D>();
  cudaError_t err = cudaFuncSetAttribute(step_ll_attempt<NU, VF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  step_ll_attempt<NU, VF><<<lanes_grid(B), THREADS, smem, st>>>(args, c, vf, B);
  return cudaGetLastError();
}

template <class VF>
int launch(int nu, const void* in_ptrs, const void* out_ptrs, const void* consts,
           long long batch, VF vf, int device, void* stream) {
  Args args;
  Consts c;
  unpack(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nu) {
    case 2: err = launch_nu<2>(st, args, c, vf, batch); break;
    case 3: err = launch_nu<3>(st, args, c, vf, batch); break;
    case 4: err = launch_nu<4>(st, args, c, vf, batch); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <class VF>
int report(int nu, int* out) {
  switch (nu) {
    case 2: return lane_report(step_ll_attempt<2, VF>, out, prev_smem_bytes<2, VF::D>());
    case 3: return lane_report(step_ll_attempt<3, VF>, out, prev_smem_bytes<3, VF::D>());
    case 4: return lane_report(step_ll_attempt<4, VF>, out, prev_smem_bytes<4, VF::D>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface: as odeckpt_step_ll_interval_rigid_body, without max_attempts.
extern "C" int odeckpt_step_ll_attempt_rigid_body(int nu, const void* in_ptrs,
                                                  const void* out_ptrs, const void* consts,
                                                  long long batch, float p1, float p2, float p3,
                                                  int device, void* stream) {
  return launch(nu, in_ptrs, out_ptrs, consts, batch, RigidBody{p1, p2, p3}, device, stream);
}

// As odeckpt_step_ll_interval_geometry, for this form.
extern "C" int odeckpt_step_ll_attempt_geometry(int nu, int* out) {
  return report<RigidBody>(nu, out);
}
