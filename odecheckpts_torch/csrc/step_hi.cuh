// The df32 step of K2 (step_hi.cu) and K4 (step_hi_attempt.cu): one adaptive
// attempt of the isotropic TS0 fixedpoint solver with the solution mean, the
// time axis and the residual in compensated (hi, lo) f32 pairs, one IVP lane
// per thread.
//
// K2 replaces odecheckpts_tpu/batched_hi.py:_pallas_interval(make_step_hi,
// num_state=12, active_fn=_active_hi), the Pallas kernel of the df32 band
// (rtol 1e-5..1e-9) of the work-precision bench; K4 replaces
// batched_hi.py:_pallas_step(make_step_hi), one attempt per launch.  The
// plain PyTorch twin is odecheckpts_torch/batched_hi.py:StepHi.
//
// What bounds it: per-thread registers and latency, not bytes.  A lane holds
// 2 + 4*n*d + 2*n*n + 4 state floats (150 at nu = 5, d = 3), the
// (2n) x (2n) = 144-float column list of the revert QR at nu = 5, the
// extrapolated mean pair and the step's temporaries.  The pair arithmetic
// multiplies the mean's operation count (an error-free product is 17
// flops), but the covariance QR, in plain f32, is still most of an attempt.
// This first version accepts register spills (ptxas -v counts per nu are in
// PERF.md).
//
// The arithmetic follows batched_hi.py:make_step_hi (TS0, ode_order 1,
// fixedpoint, dynamic calibration, error unit "qoi") operation by operation
// and in the same order:
//   * the df32 operations of odecheckpts_tpu/df32.py:37-138 (two_sum,
//     fast_two_sum, Dekker's split and two_prod, add, add1, sub, mul, mul1,
//     div1).  They are error-free only if no multiply-add is contracted:
//     build with -fmad=false and without --use_fast_math;
//   * the clamped checkpoint step: the remainder rem = t_next - t on the
//     compensated time axis; the mean advances by dt_mean = min(dt_prop, rem),
//     the covariance by the floored dt; a remainder below 1e-5 dt_max is a
//     tiny step that is force-accepted, advances the mean by extrapolation
//     only and freezes covariance, scale, G_acc, msp and nsteps; an accepted
//     clamped step snaps t to exactly (t_next, 0) and keeps the controller
//     state (dt, errn memory);
//   * the mean extrapolated in real coordinates with dt^k / k! as pairs
//     (_taylor_extrap_df), the residual z = u' - f(u) in pairs;
//   * the first n reflections only of the revert QR (_qr_r_cols_partial);
//   * l_pred = (p * R_yy^T) * mag -- in this order, unlike K1;
//   * the fixedpoint smoother in increment form: msp += G_acc (gain (-g z)),
//     G_acc = G_acc gain;
//   * the stall bound 4 * 2^-45 * max(|t_hi|, 1) of the compensated axis.

#pragma once

#include <cstring>

#include "lanes.cuh"

namespace {

constexpr int NMAX_HI = 6;  // n = nu + 1 for nu <= 5
constexpr int NUM_STATE_HI = 12;
constexpr int NUM_IN_HI = NUM_STATE_HI + 6;  // + t_next, atol, rtol, dt_max, dt_floor, tiny_scale

// Rounded f32 constants, in the order of StepHi.packed_constants().
struct ConstsHi {
  float a[NMAX_HI * NMAX_HI];   // Pascal transition A, row-major, stride NMAX_HI
  float lq[NMAX_HI * NMAX_HI];  // chol(Qbar), row-major, stride NMAX_HI
  float lq_norm[NMAX_HI];       // ||Lq[k, :]||
  float inv_fact[NMAX_HI];      // 1 / (nu - i)!
  float max_lq, a_inf_norm, sqrt_d, kappa, neg_n1, n2, safety, factor_min,
      factor_max, big, clip, tiny_frac, stall;
};
static_assert(sizeof(ConstsHi) == 97 * sizeof(float), "layout of StepHi.packed_constants");

struct ArgsHi {
  const float* in[NUM_IN_HI];
  float* out[NUM_STATE_HI];
};

// ---------------------------------------------------------------------------
// df32 pairs (odecheckpts_tpu/df32.py): x = hi + lo, |lo| <= ulp(hi) / 2

struct F2 {
  float hi, lo;
};

__device__ __forceinline__ F2 two_sum(float a, float b) {
  const float s = a + b;
  const float bb = s - a;
  return {s, (a - (s - bb)) + (b - bb)};
}

__device__ __forceinline__ F2 fast_two_sum(float a, float b) {
  const float s = a + b;
  return {s, b - (s - a)};
}

__device__ __forceinline__ F2 split(float a) {
  const float c = 4097.0f * a;
  const float hi = c - (c - a);
  return {hi, a - hi};
}

__device__ __forceinline__ F2 two_prod(float a, float b) {
  const float p = a * b;
  const F2 as = split(a), bs = split(b);
  return {p, ((as.hi * bs.hi - p) + as.hi * bs.lo + as.lo * bs.hi) + as.lo * bs.lo};
}

__device__ __forceinline__ F2 add(F2 x, F2 y) {
  const F2 s = two_sum(x.hi, y.hi);
  return fast_two_sum(s.hi, s.lo + (x.lo + y.lo));
}

__device__ __forceinline__ F2 add1(F2 x, float b) {
  const F2 s = two_sum(x.hi, b);
  return fast_two_sum(s.hi, s.lo + x.lo);
}

__device__ __forceinline__ F2 sub(F2 x, F2 y) { return add(x, F2{-y.hi, -y.lo}); }

__device__ __forceinline__ F2 mul(F2 x, F2 y) {
  const F2 p = two_prod(x.hi, y.hi);
  return fast_two_sum(p.hi, p.lo + (x.hi * y.lo + x.lo * y.hi));
}

__device__ __forceinline__ F2 mul1(F2 x, float b) {
  const F2 p = two_prod(x.hi, b);
  return fast_two_sum(p.hi, p.lo + x.lo * b);
}

__device__ __forceinline__ F2 div1(F2 x, float b) {
  const float q0 = x.hi / b;
  const F2 p = two_prod(q0, b);
  const float r = ((x.hi - p.hi) - p.lo) + x.lo;
  return fast_two_sum(q0, r / b);
}

// Pair vector fields as functors, each mirroring the torch pair vector field
// of the same name in problems.py; the parameters come in as kernel
// arguments.
struct RigidBodyDf {
  static constexpr int D = 3;
  float p1, p2, p3;
  __device__ void operator()(const F2* u, F2* out) const {
    out[0] = mul1(mul(u[1], u[2]), p1);
    out[1] = mul1(mul(u[0], u[2]), p2);
    out[2] = mul1(mul(u[0], u[1]), p3);
  }
};

template <int N, int D>
struct LaneHi {
  float t_hi, t_lo, scale, dt, errn_prev, nsteps;
  float mean_hi[N][D], mean_lo[N][D], chol[N][N], g_acc[N][N], msp_hi[N][D], msp_lo[N][D];
};

struct LaneInputsHi {
  float t_next, atol, rtol, dt_max, dt_floor, tiny_scale;
};

// Still short of the checkpoint (batched_hi.py:535-536): a lane whose hi word
// rounds onto t_next with t_lo < 0 has a positive remainder; testing t_hi
// alone would drop its checkpoint ~ulp/2 early.
__device__ __forceinline__ bool active_hi(float t_hi, float t_lo, float t_next) {
  return t_hi < t_next || (t_hi == t_next && t_lo < 0.0f);
}

// One accept/reject attempt (make_step_hi's `step`), updating s in place.
template <int NU, class VF>
__device__ __forceinline__ void attempt_hi(LaneHi<NU + 1, VF::D>& s, const ConstsHi& c,
                                           const VF& vf, const LaneInputsHi& in) {
  constexpr int N = NU + 1;
  constexpr int D = VF::D;
  constexpr int M = 2 * N;
  const float atol = in.atol, rtol = in.rtol, dt_max = in.dt_max, dt_floor = in.dt_floor,
              tiny_scale = in.tiny_scale;

  // remainder to the checkpoint on the compensated time axis
  const F2 se = two_sum(in.t_next, -s.t_hi);
  const float rem = maxp(se.hi + (se.lo - s.t_lo), 0.0f);
  const bool frozen = rem <= 0.0f;
  const float dt_prop = minp(maxp(s.dt, dt_floor), dt_max);
  const bool clamped = rem <= dt_prop;
  const float dt_mean = minp(dt_prop, rem);
  const bool tiny = clamped && (rem <= c.tiny_frac * dt_max);
  const float dt = maxp(dt_mean, dt_floor);

  float pows[N];
  pows[NU] = 1.0f;
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) pows[i] = pows[i + 1] * dt;
  const float sq = sqrtf(dt);
  float p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = sq * pows[i] * c.inv_fact[i];
  const F2 t_new = add1(F2{s.t_hi, s.t_lo}, dt_mean);

  // -- extrapolate the mean in pairs, real coordinates: m_i + sum_k c_k m_{i+k}
  F2 ck[N];  // ck[k] = dt_mean^k / k!; ck[0] unused
  ck[1] = F2{dt_mean, 0.0f};
#pragma unroll
  for (int k = 2; k < N; ++k) ck[k] = div1(mul1(ck[k - 1], dt_mean), static_cast<float>(k));
  F2 m_pred[N][D];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int q = 0; q < D; ++q) {
      F2 acc{s.mean_hi[i][q], s.mean_lo[i][q]};
#pragma unroll
      for (int k = 1; k < N - i; ++k)
        acc = add(acc, mul(F2{s.mean_hi[i + k][q], s.mean_lo[i + k][q]}, ck[k]));
      m_pred[i][q] = acc;
    }

  // -- TS0 residual on the first derivative, in pairs
  F2 fx[D], z[D];
  vf(m_pred[0], fx);
#pragma unroll
  for (int q = 0; q < D; ++q) z[q] = sub(m_pred[1][q], fx[q]);

  // -- local scale and error (f32: they only steer the controller)
  const float s_unit = p[1] * c.lq_norm[1];
  float zz = z[0].hi * z[0].hi;
  float qq = atol + rtol * fabsf(m_pred[0][0].hi);
  float tol_acc = 1.0f / (qq * qq);
#pragma unroll
  for (int i = 1; i < D; ++i) {
    zz = zz + z[i].hi * z[i].hi;
    qq = atol + rtol * fabsf(m_pred[0][i].hi);
    tol_acc = tol_acc + 1.0f / (qq * qq);
  }
  const float sigma = sqrtf(zz) / (s_unit * c.sqrt_d);
  const float err_u = sigma * (p[0] * c.lq_norm[0]);
  const float errn = c.kappa * err_u * sqrtf(tol_acc / static_cast<float>(D));

  const float sigma_safe = isfinite(sigma) ? sigma : c.big;
  const float new_scale = minp(maxp(sigma_safe, tiny_scale), c.big);

  // -- extrapolate the covariance (f32) with reversal, preconditioned
  float l_bar[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) l_bar[i][k] = minp(maxp(s.chol[i][k] / p[i], -c.clip), c.clip);
  float mag = new_scale * c.max_lq;
#pragma unroll
  for (int i = 0; i < N; ++i) mag = maxp(mag, row_absmax(l_bar[i]));
  mag = maxp(mag * c.a_inf_norm, tiny_scale);
  const float inv_mag = 1.0f / mag;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) l_bar[i][k] = l_bar[i][k] * inv_mag;  // l_bar_n
  const float lq_s = new_scale * inv_mag;

  // revert-QR columns: column i < N is [ (A l_bar_n)[i] ; lq_s Lq[i] ],
  // column N + i is [ l_bar_n[i] ; 0 ]; only the first N reflections run
  float cols[M][M];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = -0.0f;  // the exact identity of +; zero entries of A skipped
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (c.a[i * NMAX_HI + j] != 0.0f) acc = acc + c.a[i * NMAX_HI + j] * l_bar[j][k];
      cols[i][k] = acc;
      cols[i][N + k] = lq_s * c.lq[i * NMAX_HI + k];
      cols[N + i][k] = l_bar[i][k];
      cols[N + i][N + k] = 0.0f;
    }
  qr_r_cols<M, M, N>(cols);  // R[r][col] = cols[col][r] for r < N

  float x[N][N];  // X = R_yy^-1 R_yx
  tri_solve_upper<N, M>(cols, x);
  float l_pred[N][N], gain[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      l_pred[i][k] = (p[i] * cols[i][k]) * mag;
      gain[i][k] = p[i] * x[k][i] / p[k];
    }

  // -- TS0 correction (rank-1 update on the observation row), mean in pairs
  float l_obs_n[N];
  const float m2 = maxp(row_absmax(l_pred[1]), tiny_scale);
#pragma unroll
  for (int k = 0; k < N; ++k) l_obs_n[k] = l_pred[1][k] / m2;
  float s2 = l_obs_n[0] * l_obs_n[0];
#pragma unroll
  for (int k = 1; k < N; ++k) s2 = s2 + l_obs_n[k] * l_obs_n[k];
  s2 = s2 + FLT_MIN;
  float gc[N], g_corr[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = l_pred[i][0] * l_obs_n[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + l_pred[i][j] * l_obs_n[j];
    gc[i] = acc / s2;
    g_corr[i] = gc[i] / m2;
  }

  // -- fixedpoint accumulation, increment form
  float gd[N][D];  // gain @ diff, diff[j][q] = -(g_corr[j] z[q].hi)
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int q = 0; q < D; ++q) {
      float acc = gain[i][0] * -(g_corr[0] * z[q].hi);
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + gain[i][j] * -(g_corr[j] * z[q].hi);
      gd[i][q] = acc;
    }

  // -- PI control
  const float errn_s = maxp(errn, FLT_MIN);
  float factor = c.safety * expf(c.neg_n1 * logf(errn_s) +
                                 c.n2 * (logf(s.errn_prev) - logf(errn_s)));
  if (!isfinite(factor)) factor = c.factor_min;
  const float dt_next = minp(dt * minp(maxp(factor, c.factor_min), c.factor_max), dt_max);

  const float dt_stall = c.stall * maxp(fabsf(s.t_hi), 1.0f);
  const bool accept = ((errn <= 1.0f) || (dt <= dt_stall) || tiny) && !frozen;
  const bool snap = accept && clamped;

  if (!(frozen || snap)) s.dt = dt_next;
  if (!accept) return;
  if (snap) {
    s.t_hi = in.t_next;
    s.t_lo = 0.0f;
  } else {
    s.t_hi = t_new.hi;
    s.t_lo = t_new.lo;
    s.errn_prev = errn_s;
  }
  if (tiny) {  // extrapolation only; covariance and accumulation frozen
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int q = 0; q < D; ++q) {
        s.mean_hi[i][q] = m_pred[i][q].hi;
        s.mean_lo[i][q] = m_pred[i][q].lo;
      }
    return;
  }
  float g_acc_new[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int q = 0; q < D; ++q) {
      const F2 cor = sub(m_pred[i][q], mul1(z[q], g_corr[i]));
      s.mean_hi[i][q] = cor.hi;
      s.mean_lo[i][q] = cor.lo;
      float incr = s.g_acc[i][0] * gd[0][q];
#pragma unroll
      for (int j = 1; j < N; ++j) incr = incr + s.g_acc[i][j] * gd[j][q];
      const F2 msp = add1(F2{s.msp_hi[i][q], s.msp_lo[i][q]}, incr);
      s.msp_hi[i][q] = msp.hi;
      s.msp_lo[i][q] = msp.lo;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s.chol[i][k] = l_pred[i][k] - gc[i] * l_obs_n[k];
      float acc = s.g_acc[i][0] * gain[0][k];
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + s.g_acc[i][j] * gain[j][k];
      g_acc_new[i][k] = acc;
    }
  }
  copy_to(s.g_acc, g_acc_new);
  s.scale = new_scale;
  s.nsteps = s.nsteps + 1.0f;
}

template <int N, int D>
__device__ __forceinline__ LaneInputsHi load_lane_hi(LaneHi<N, D>& s, const ArgsHi& args,
                                                     int64_t b, int64_t B) {
  s.t_hi = args.in[0][b];
  s.t_lo = args.in[1][b];
  load(s.mean_hi, args.in[2], b, B);
  load(s.mean_lo, args.in[3], b, B);
  load(s.chol, args.in[4], b, B);
  s.scale = args.in[5][b];
  load(s.g_acc, args.in[6], b, B);
  load(s.msp_hi, args.in[7], b, B);
  load(s.msp_lo, args.in[8], b, B);
  s.dt = args.in[9][b];
  s.errn_prev = args.in[10][b];
  s.nsteps = args.in[11][b];
  return LaneInputsHi{args.in[12][b], args.in[13][b], args.in[14][b],
                      args.in[15][b], args.in[16][b], args.in[17][b]};
}

template <int N, int D>
__device__ __forceinline__ void store_lane_hi(const LaneHi<N, D>& s, const ArgsHi& args,
                                              int64_t b, int64_t B) {
  args.out[0][b] = s.t_hi;
  args.out[1][b] = s.t_lo;
  store(s.mean_hi, args.out[2], b, B);
  store(s.mean_lo, args.out[3], b, B);
  store(s.chol, args.out[4], b, B);
  args.out[5][b] = s.scale;
  store(s.g_acc, args.out[6], b, B);
  store(s.msp_hi, args.out[7], b, B);
  store(s.msp_lo, args.out[8], b, B);
  args.out[9][b] = s.dt;
  args.out[10][b] = s.errn_prev;
  args.out[11][b] = s.nsteps;
}

inline void unpack_hi(ArgsHi& args, ConstsHi& c, const void* in_ptrs, const void* out_ptrs,
                      const void* consts) {
  std::memcpy(args.in, in_ptrs, sizeof(args.in));
  std::memcpy(args.out, out_ptrs, sizeof(args.out));
  std::memcpy(&c, consts, sizeof(ConstsHi));
}

}  // namespace
