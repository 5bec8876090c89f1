// K6, attempt form: one attempt of the blockdiag step (step_bd.cuh) on every
// lane, one thread per (IVP lane, channel), a tile of 32 lanes in D warps a
// block.  Replaces odecheckpts_tpu/batched_blockdiag.py:488,
// _pallas_step(make_step_bd_ll), the per-attempt kernel of engine "pallas"
// on the blockdiag backend; the host loop around it is kernels.attempt_loop.
//
// Every launch reads and writes the 17-array state (521 floats a lane at
// nu = 4, d = 3) and the host syncs once per attempt: what bounds this
// engine is the launch, the state's round trip and the sync.  The kernel is
// the interval form's body (run_bd in step_bd.cuh) with one attempt: each
// thread copies its channel's arrays to shared memory (the loads of a warp
// whole 128-byte lines), runs the attempt and writes them back.  Lanes at
// the checkpoint are frozen inside the step, so the kernel steps every lane
// unconditionally, as the Pallas kernel does.

#include "step_bd.cuh"

namespace {

template <int NU, class VF>
__global__ void __launch_bounds__(bd_threads_per_block(VF::D), BD_MIN_BLOCKS)
    step_bd_attempt(Args args, Consts c, VF vf, int64_t B) {
  run_bd<NU, VF, false>(args, c, vf, B, 1);
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
  const int64_t B = batch;
  switch (nu) {
    case 2: err = launch_bd(step_bd_attempt<2, VF>, VF::D, bd_smem_bytes<2, VF::D>(), batch, st,
                            args, c, vf, B); break;
    case 3: err = launch_bd(step_bd_attempt<3, VF>, VF::D, bd_smem_bytes<3, VF::D>(), batch, st,
                            args, c, vf, B); break;
    case 4: err = launch_bd(step_bd_attempt<4, VF>, VF::D, bd_smem_bytes<4, VF::D>(), batch, st,
                            args, c, vf, B); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <class VF>
int report(int nu, int* out) {
  switch (nu) {
    case 2: return bd_report<VF>(step_bd_attempt<2, VF>, bd_smem_bytes<2, VF::D>(), out);
    case 3: return bd_report<VF>(step_bd_attempt<3, VF>, bd_smem_bytes<3, VF::D>(), out);
    case 4: return bd_report<VF>(step_bd_attempt<4, VF>, bd_smem_bytes<4, VF::D>(), out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// As odeckpt_step_bd_interval_geometry, for this form.
extern "C" int odeckpt_step_bd_attempt_geometry(int nu, int anisotropic, int* out) {
  return anisotropic ? report<RigidBodyAniso>(nu, out) : report<RigidBody>(nu, out);
}
