// The f32 step of K6 (interval form step_bd.cu, attempt form
// step_bd_attempt.cu): one adaptive attempt of the BLOCKDIAG TS0 fixedpoint
// solver, one IVP lane per thread, the lane's d channels in sequence.
//
// Replaces odecheckpts_tpu/batched_blockdiag.py:481 and :488,
// _pallas_interval / _pallas_step of make_step_bd_ll (:55-261).  The plain
// PyTorch twin is odecheckpts_torch/batched_blockdiag.py:StepBD.
//
// The blockdiag backend keeps one (n, n) covariance factor and one output
// scale per ODE dimension.  Per channel the covariance arithmetic is the
// isotropic step's (step_ll.cuh) with that channel's own scale: the
// (2n, 2n) revert QR, the gain solve, the rank-1 correction and the (2n, n)
// fixedpoint QR.  The channels meet in three places only: the vector field,
// the error norm (summed over d in the order 0..d-1) and the lane's dt and
// accept.
//
// Layout chosen: one thread per lane with a runtime loop over the channels,
// not one thread per (lane, channel).  The per-channel body then is K1's
// code at K1's sizes, on lanes.cuh's helpers, with the twin's order of
// operations; the interval loop needs no block-wide agreement on when to
// stop, so every lane still leaves as soon as it is done; and dt, accept
// and the error norm need no exchange through shared memory.  The price:
// the d channels of a lane run one after the other, and the lane's state
// (4 n d + 6 n n d + 2 d + 5 floats, 521 at nu = 4, d = 3) lives in local
// memory, because the channel index is a runtime value (ptxas reports it as
// stack, see PERF.md).  Covariance work runs on accepted attempts only: a
// rejected attempt changes nothing but dt, which depends on the means alone.
//
// Device memory layout: lanes-last; element (i, k, ch) of lane b of an
// (n, n, d, B) array sits at x[((i * n + k) * d + ch) * B + b].
//
// Bit for bit with the twin, as K1: -fmad=false, no fast math, maxima and
// clips that propagate NaN, the eps^2 zeroing of the gain solve, FLT_MIN
// addends, sums over rows in the order 0..n-1 (the reference's jnp.sum over
// the observation row is written out in that order in the twin too).

#pragma once

#include "step_ll.cuh"

namespace {

// Host side: a functor from the C interface's four float parameters.
template <class VF>
VF make_functor(float p1, float p2, float p3, float p4);
template <>
inline RigidBody make_functor<RigidBody>(float p1, float p2, float p3, float /*p4*/) {
  return RigidBody{p1, p2, p3};
}
template <>
inline RigidBodyAniso make_functor<RigidBodyAniso>(float p1, float p2, float p3, float p4) {
  return RigidBodyAniso{p1, p2, p3, p4};
}

template <int N, int D>
struct LaneBD {
  float t, t_prev, dt, errn_prev, nsteps;
  float scale[D], mle[D];
  float mean[N][D], bwd_m[N][D], mean_prev[N][D], bwd_m_prev[N][D];
  // factors and gains channel-major: x[ch] is that channel's (n, n) matrix
  float chol[D][N][N], bwdG[D][N][N], bwd_L[D][N][N];
  float chol_prev[D][N][N], bwdG_prev[D][N][N], bwd_L_prev[D][N][N];
};

template <int N, int D>
__device__ __forceinline__ void load_channels(float (&x)[D][N][N], const float* src, int64_t b,
                                              int64_t B) {
#pragma unroll 1
  for (int ch = 0; ch < D; ++ch)
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) x[ch][i][k] = src[((i * N + k) * D + ch) * B + b];
}

template <int N, int D>
__device__ __forceinline__ void store_channels(const float (&x)[D][N][N], float* dst, int64_t b,
                                               int64_t B) {
#pragma unroll 1
  for (int ch = 0; ch < D; ++ch)
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) dst[((i * N + k) * D + ch) * B + b] = x[ch][i][k];
}

// The covariance part of an accepted attempt for channel ch, in place:
// the previous values move to the *_prev arrays, then the channel's mean
// column, factor, backward conditional, scale and mle take their new values.
template <int NU, int D>
__device__ __forceinline__ void accept_channel(LaneBD<NU + 1, D>& s, int ch, const Consts& c,
                                               const float (&p)[NU + 1],
                                               const float (&m_pred)[NU + 1][D], float z,
                                               float sigma, float tiny_scale) {
  constexpr int N = NU + 1;
  constexpr int M = 2 * N;
  float(&chol)[N][N] = s.chol[ch];
  float(&bwdG)[N][N] = s.bwdG[ch];
  float(&bwd_L)[N][N] = s.bwd_L[ch];

  const float sigma_safe = isfinite(sigma) ? sigma : c.big;
  const float new_scale = minp(maxp(sigma_safe, tiny_scale), c.big);

  // -- extrapolate the covariance with reversal, preconditioned coordinates
  float l_bar[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) l_bar[i][k] = minp(maxp(chol[i][k] / p[i], -c.clip), c.clip);
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

  float cols[M][M];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = -0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (c.a[i * NMAX + j] != 0.0f) acc = acc + c.a[i * NMAX + j] * l_bar[j][k];
      cols[i][k] = acc;
      cols[i][N + k] = lq_s * c.lq[i * NMAX + k];
      cols[N + i][k] = l_bar[i][k];
      cols[N + i][N + k] = 0.0f;
    }
  qr_r_cols<M, M>(cols);  // R[r][col] = cols[col][r]

  float x[N][N];  // X = R_yy^-1 R_yx
  tri_solve_upper<N, M>(cols, x);
  float l_pred[N][N], gain[N][N], bwd_L_step[N][N], bwd_m_step[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      l_pred[i][k] = p[i] * (cols[i][k] * mag);
      gain[i][k] = p[i] * x[k][i] / p[k];
      bwd_L_step[i][k] = p[i] * (cols[N + i][N + k] * mag);
    }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = gain[i][0] * m_pred[0][ch];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + gain[i][j] * m_pred[j][ch];
    bwd_m_step[i] = s.mean[i][ch] - acc;
  }

  // -- TS0 correction (rank-1 update on the observation row)
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

  // -- fixedpoint accumulation
  float bwdG_new[N][N], bwd_m_new[N], m1[N][N], bl_g[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = bwdG[i][0] * gain[0][k];
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + bwdG[i][j] * gain[j][k];
      bwdG_new[i][k] = acc;
    }
    float acc = bwdG[i][0] * bwd_m_step[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + bwdG[i][j] * bwd_m_step[j];
    bwd_m_new[i] = acc + s.bwd_m[i][ch];
  }
  float mag_g = tiny_scale;
#pragma unroll
  for (int i = 0; i < N; ++i) mag_g = maxp(mag_g, row_absmax(bwdG[i]));
  const float inv_g = 1.0f / mag_g;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = (bwdG[i][0] * inv_g) * bwd_L_step[0][k];
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + (bwdG[i][j] * inv_g) * bwd_L_step[j][k];
      m1[i][k] = acc;
      bl_g[i][k] = bwd_L[i][k] * inv_g;
    }
  float t3 = tiny_scale;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t3 = maxp(t3, row_absmax(m1[i]));
    t3 = maxp(t3, row_absmax(bl_g[i]));
  }
  const float inv3 = 1.0f / t3;
  float cols2[N][M];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      cols2[i][k] = m1[i][k] * inv3;
      cols2[i][N + k] = bl_g[i][k] * inv3;
    }
  qr_r_cols<M, N>(cols2);

  // -- the channel's part of the accepted state
  copy_to(s.chol_prev[ch], chol);
  copy_to(s.bwdG_prev[ch], bwdG);
  copy_to(s.bwd_L_prev[ch], bwd_L);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.mean_prev[i][ch] = s.mean[i][ch];
    s.bwd_m_prev[i][ch] = s.bwd_m[i][ch];
    s.mean[i][ch] = m_pred[i][ch] - g_corr[i] * z;
    s.bwd_m[i][ch] = bwd_m_new[i];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      chol[i][k] = l_pred[i][k] - gc[i] * l_obs_n[k];
      bwd_L[i][k] = (cols2[i][k] * t3) * mag_g;
    }
  }
  copy_to(bwdG, bwdG_new);
  s.scale[ch] = new_scale;
  s.mle[ch] = s.mle[ch] + sigma * sigma;
}

// One accept/reject attempt (make_step_bd_ll's `step`), updating s in place.
template <int NU, class VF>
__device__ __forceinline__ void attempt_bd(LaneBD<NU + 1, VF::D>& s, const Consts& c,
                                           const VF& vf, const LaneInputs& in) {
  const float t_next = in.t_next, atol = in.atol, rtol = in.rtol, dt_max = in.dt_max,
              dt_floor = in.dt_floor, tiny_scale = in.tiny_scale;
  constexpr int N = NU + 1;
  constexpr int D = VF::D;

  const float dt = minp(maxp(s.dt, dt_floor), dt_max);
  float pows[N];
  pows[NU] = 1.0f;
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) pows[i] = pows[i + 1] * dt;
  const float sq = sqrtf(dt);
  float p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = sq * pows[i] * c.inv_fact[i];
  const float t_new = s.t + dt;

  // -- extrapolate the mean: m_pred = P A P^-1 m
  float m_bar[N][D], m_pred[N][D];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < D; ++k) m_bar[i][k] = s.mean[i][k] / p[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float acc = -0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (c.a[i * NMAX + j] != 0.0f) acc = acc + c.a[i * NMAX + j] * m_bar[j][k];
      m_pred[i][k] = p[i] * acc;
    }

  // -- TS0 residual, per-dimension sigma, one error norm per lane
  float fx[D], z[D], sigma[D];
  vf(m_pred[0], t_new, fx);
  const float s_unit = p[1] * c.lq_norm[1];
  const float u_unit = p[0] * c.lq_norm[0];
  float e2 = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    z[k] = m_pred[1][k] - fx[k];
    sigma[k] = fabsf(z[k]) / s_unit;
    const float q = (sigma[k] * u_unit) / (atol + rtol * fabsf(m_pred[0][k]));
    e2 = k == 0 ? q * q : e2 + q * q;
  }
  const float errn = c.kappa * sqrtf(e2 / static_cast<float>(D));

  // -- PI control and accept (the means alone decide them)
  const float errn_s = maxp(errn, FLT_MIN);
  float factor = c.safety * expf(c.neg_n1 * logf(errn_s) +
                                 c.n2 * (logf(s.errn_prev) - logf(errn_s)));
  if (!isfinite(factor)) factor = c.factor_min;
  const float dt_next = minp(dt * minp(maxp(factor, c.factor_min), c.factor_max), dt_max);
  const float dt_stall = (4.0f * FLT_EPSILON) * maxp(fabsf(s.t), 1.0f);
  const bool frozen = s.t >= t_next;
  const bool accept = ((errn <= 1.0f) || (dt <= dt_stall)) && !frozen;

  if (!frozen) s.dt = dt_next;
  if (!accept) return;
#pragma unroll 1
  for (int ch = 0; ch < D; ++ch)
    accept_channel<NU, D>(s, ch, c, p, m_pred, z[ch], sigma[ch], tiny_scale);
  s.t_prev = s.t;
  s.t = t_new;
  s.errn_prev = errn_s;
  s.nsteps = s.nsteps + 1.0f;
}

template <int N, int D>
__device__ __forceinline__ LaneInputs load_lane_bd(LaneBD<N, D>& s, const Args& args, int64_t b,
                                                   int64_t B) {
  s.t = args.in[0][b];
  load(s.mean, args.in[1], b, B);
  load_channels(s.chol, args.in[2], b, B);
  load_channels(s.bwdG, args.in[3], b, B);
  load(s.bwd_m, args.in[4], b, B);
  load_channels(s.bwd_L, args.in[5], b, B);
  s.t_prev = args.in[7][b];
  load(s.mean_prev, args.in[8], b, B);
  load_channels(s.chol_prev, args.in[9], b, B);
  load_channels(s.bwdG_prev, args.in[10], b, B);
  load(s.bwd_m_prev, args.in[11], b, B);
  load_channels(s.bwd_L_prev, args.in[12], b, B);
  s.dt = args.in[13][b];
  s.errn_prev = args.in[14][b];
  s.nsteps = args.in[15][b];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    s.scale[k] = args.in[6][k * B + b];
    s.mle[k] = args.in[16][k * B + b];
  }
  return LaneInputs{args.in[17][b], args.in[18][b], args.in[19][b],
                    args.in[20][b], args.in[21][b], args.in[22][b]};
}

template <int N, int D>
__device__ __forceinline__ void store_lane_bd(const LaneBD<N, D>& s, const Args& args, int64_t b,
                                              int64_t B) {
  args.out[0][b] = s.t;
  store(s.mean, args.out[1], b, B);
  store_channels(s.chol, args.out[2], b, B);
  store_channels(s.bwdG, args.out[3], b, B);
  store(s.bwd_m, args.out[4], b, B);
  store_channels(s.bwd_L, args.out[5], b, B);
  args.out[7][b] = s.t_prev;
  store(s.mean_prev, args.out[8], b, B);
  store_channels(s.chol_prev, args.out[9], b, B);
  store_channels(s.bwdG_prev, args.out[10], b, B);
  store(s.bwd_m_prev, args.out[11], b, B);
  store_channels(s.bwd_L_prev, args.out[12], b, B);
  args.out[13][b] = s.dt;
  args.out[14][b] = s.errn_prev;
  args.out[15][b] = s.nsteps;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    args.out[6][k * B + b] = s.scale[k];
    args.out[16][k * B + b] = s.mle[k];
  }
}

}  // namespace
