// K7: one attempt of the isotropic f32 step (step_ll.cuh) with the smoother
// or the filter strategy on every lane, one IVP lane per thread.  Replaces
// odecheckpts_tpu/batched_everystep.py:238, _pallas_step(make_step_ll) with
// strategy "smoother" or "filter": the per-attempt kernel under the
// attempt-aligned save-every-step driver
// (odecheckpts_torch/batched_everystep.py), which launches it a fixed number
// of times and keeps each launch's outputs as one slot.  The plain PyTorch
// twin is odecheckpts_torch/batched.py:StepLL made with that strategy.
//
// Smoother: the backward arrays take the attempt's own one-step conditional
// (gain, noise mean, noise factor of the revert QR) instead of the
// accumulation of K1 and K3, so the (2n, n) accumulation QR and its products
// drop out.  Filter: no reversal at all; a (2n, n) QR gives the predicted
// factor and the backward arrays pass through.
//
// What bounds it: as K3, the launch and the state's round trip through device
// memory (217 floats a lane read and written at nu = 4, d = 3), not the
// arithmetic; the driver needs that round trip, because every attempt's
// posterior and conditional are kept.  Lanes at t1 are frozen inside the
// step, so the kernel steps every lane unconditionally.  Of the 17 arrays an
// attempt reads two (mean, chol); the lane holds only those and the scalars
// (step_ll.cuh: LaneAttempt, store_attempt).

#include "step_ll.cuh"

namespace {

template <int NU, int STRATEGY, class VF>
__global__ void __launch_bounds__(THREADS)
    step_everystep_attempt(Args args, Consts c, VF vf, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;
  LaneAttempt<NU + 1, VF::D> s;
  const LaneInputs in = load_attempt(s, args, b, B);
  attempt<NU, VF, STRATEGY>(s, c, vf, in);
  store_attempt<STRATEGY>(s, args, b, B);
}

template <int STRATEGY, class VF>
int launch_strategy(int nu, const Args& args, const Consts& c, long long batch, VF vf,
                    cudaStream_t st) {
  const dim3 grid = lanes_grid(batch), block(THREADS);
  const int64_t B = batch;
  switch (nu) {
    case 2: step_everystep_attempt<2, STRATEGY, VF><<<grid, block, 0, st>>>(args, c, vf, B); break;
    case 3: step_everystep_attempt<3, STRATEGY, VF><<<grid, block, 0, st>>>(args, c, vf, B); break;
    case 4: step_everystep_attempt<4, STRATEGY, VF><<<grid, block, 0, st>>>(args, c, vf, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class VF>
int launch(int nu, int strategy, const void* in_ptrs, const void* out_ptrs, const void* consts,
           long long batch, VF vf, int device, void* stream) {
  Args args;
  Consts c;
  unpack(args, c, in_ptrs, out_ptrs, consts);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (strategy == SMOOTHER) return launch_strategy<SMOOTHER, VF>(nu, args, c, batch, vf, st);
  if (strategy == FILTER) return launch_strategy<FILTER, VF>(nu, args, c, batch, vf, st);
  return static_cast<int>(cudaErrorInvalidValue);  // fixedpoint is K3's
}

template <int STRATEGY>
int report(int nu, int* out) {
  switch (nu) {
    case 2: return lane_report(step_everystep_attempt<2, STRATEGY, RigidBody>, out);
    case 3: return lane_report(step_everystep_attempt<3, STRATEGY, RigidBody>, out);
    case 4: return lane_report(step_everystep_attempt<4, STRATEGY, RigidBody>, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface: as odeckpt_step_ll_attempt_rigid_body, with the strategy code
// (1 smoother, 2 filter: kernels.STRATEGY_CODES) after nu.
extern "C" int odeckpt_step_everystep_attempt_rigid_body(int nu, int strategy,
                                                         const void* in_ptrs,
                                                         const void* out_ptrs,
                                                         const void* consts, long long batch,
                                                         float p1, float p2, float p3,
                                                         int device, void* stream) {
  return launch(nu, strategy, in_ptrs, out_ptrs, consts, batch, RigidBody{p1, p2, p3}, device,
                stream);
}

// The launch geometry for nu and the strategy code on the current device, as
// odeckpt_step_hi_interval_geometry reports it.
extern "C" int odeckpt_step_everystep_attempt_geometry(int nu, int strategy, int* out) {
  if (strategy == SMOOTHER) return report<SMOOTHER>(nu, out);
  if (strategy == FILTER) return report<FILTER>(nu, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
