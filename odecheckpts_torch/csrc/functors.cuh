// Second-order vector fields of the f32 step (step_ll.cuh, K1 and K3) and,
// evaluated on the hi word of each pair, of the df32 step (step_hi.cuh, K2
// and K4; HiChannel); and the row functors of the wide df32 step
// (step_hi_wide.cuh), at the end.  Each mirrors the row-wise torch vector field of the
// same name in problems.py operation by operation, with the parameters as
// kernel arguments: u is the position row m_pred[0], du the velocity row
// m_pred[1] (O = 2), out the acceleration.
//
// jacs (TS1, D = 1; HAS_JACS): the per-lane scalar Jacobians d f / d u and d f / d du,
// written as the terms of forward-mode differentiation of the vector field
// in the order of the twin's unit-tangent torch.func.jvp (batched.StepLL.
// _jacobians), as step_dense.cuh's Brusselator::jac is.

#pragma once

namespace {

// The restricted three-body problem (Arenstorf orbit): mu the moon's mass
// ratio and mp = 1 - mu, both rounded from the host's doubles
// (problems.three_body_restricted's device_params).  r^3 = r2 sqrt(r2) with
// IEEE sqrtf and division.
struct ThreeBodyRestricted {
  static constexpr int D = 2;
  static constexpr int O = 2;
  static constexpr bool HAS_JACS = false;
  float mu, mp;
  __device__ void operator()(const float* u, const float* du, float /*t*/, float* out) const {
    const float x1 = u[0], x2 = u[1], dx1 = du[0], dx2 = du[1];
    const float a = x1 + mu, b = x1 - mp;
    const float r1 = a * a + x2 * x2;
    const float r2 = b * b + x2 * x2;
    const float d1 = r1 * sqrtf(r1);
    const float d2 = r2 * sqrtf(r2);
    out[0] = ((x1 + 2.0f * dx2) - (mp * a) / d1) - (mu * b) / d2;
    out[1] = ((x2 - 2.0f * dx1) - (mp * x2) / d1) - (mu * x2) / d2;
  }
};

// Van der Pol in second-order form, f = mu (du (1 - u^2) - u), d = 1.
struct VanDerPol {
  static constexpr int D = 1;
  static constexpr int O = 2;
  static constexpr bool HAS_JACS = true;
  float mu;
  __device__ void operator()(const float* u, const float* du, float /*t*/, float* out) const {
    out[0] = mu * (du[0] * (1.0f - u[0] * u[0]) - u[0]);
  }
  // tangents: u u -> u + u = 2u, 1 - u u -> -(2u), du (1 - u u) -> du
  // (-(2u)), minus u -> ... - 1, times mu; in du: 1 - u^2, times mu
  __device__ void jacs(const float* u, const float* du, float /*t*/, float* j) const {
    j[0] = mu * (du[0] * -(2.0f * u[0]) - 1.0f);
    j[1] = mu * (1.0f - u[0] * u[0]);
  }
};

// The Brusselator of problems.brusselator(NB) (laplacian="slices") as a row
// functor of the wide df32 step, on the hi words (batched_hi.wrap_vf_plain):
// thread q forms component q of f from y, the row of the lane's d = 2 NB
// hi words of m_pred[0] in shared memory: u_q, its neighbours and v_q for
// q < NB, else v, its neighbours and u_{q - NB}; the boundary values are 1
// (u) and 3 (v).  Operation for operation step_dense.cuh's Brusselator; c =
// (NB + 1)^2 / 50 rounded to f32 on the host.
struct BrusselatorRow {
  static constexpr int O = 1;
  float c;
  __device__ float operator()(const float* y, int q, int d) const {
    const int nb = d / 2;
    if (q < nb) {
      const float u = y[q], v = y[nb + q];
      const float ul = q == 0 ? 1.0f : y[q - 1], ur = q == nb - 1 ? 1.0f : y[q + 1];
      const float conv_u = ul - 2.0f * u + ur;
      return 1.0f + u * u * v - 4.0f * u + c * conv_u;
    }
    const int i = q - nb;
    const float u = y[i], v = y[q];
    const float vl = i == 0 ? 3.0f : y[q - 1], vr = i == nb - 1 ? 3.0f : y[q + 1];
    const float conv_v = vl - 2.0f * v + vr;
    return 3.0f * u - u * u * v + c * conv_v;
  }
};

}  // namespace
