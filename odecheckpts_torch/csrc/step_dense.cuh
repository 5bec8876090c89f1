// The f32 step of K5 (step_dense.cu, step_dense_attempt.cu): one adaptive
// attempt of the dense-covariance TS1 / TS0 fixedpoint solver, one IVP lane
// per thread.  The plain PyTorch twin is
// odecheckpts_torch/batched_dense.py:StepDense; the reference is
// odecheckpts_tpu/batched_dense.py:make_step_dense_ll (114-484).
//
// The arithmetic follows the reference operation by operation and in the
// same order (sums in row or column order as the twin's loops take them),
// including:
//   * the column-list Householder QR without scaling or sign normalization
//     at (2nd, 2nd) (revert), (nd, d + nd) (correction; min(d + nd, nd - 1)
//     = nd - 1 reflections) and (2nd, nd) (fixedpoint);
//   * TWO different eps guards, kept apart: the whitening solve floors its
//     diagonal at FLT_MIN (batched_dense.py:257-266), the gain solves zero a
//     direction whose diagonal is below eps^2 (batched.py:113-141);
//   * the kron(Lq, I_d) rows of the revert QR built in place from the
//     constant bank, never materialized per lane;
//   * the transposes of the reference (swapaxes at 328-330, 391, 398-402,
//     436) as index swaps, and the d zero columns of the corrected factor.
// The Jacobian of TS1 comes from the functor's hand-derived jac (the TPU
// kernel took one-hot jvps through the traced vector field, which a CUDA
// kernel cannot); the twin calls the vector field's jac, written in the
// same order of operations.
//
// A lane's state is 17 arrays, 6 (nd, nd) + 4 (nd) + 7 scalars = 2,487
// floats at nd = 20, and an attempt's working arrays (the 40 x 40 revert
// column list, which the correction and fixedpoint column lists reuse,
// l_pred, gain, bwd_L_step) add ~2,900 more: far beyond 255 registers, so
// all of it lives in per-thread local memory, which the hardware interleaves
// by thread (a warp's accesses to one element coalesce).  A rejected or
// frozen attempt needs only its error estimate, so the covariance work runs
// only on accepted attempts; the outputs are those of the reference's
// compute-then-select.

#pragma once

#include "step_ll.cuh"

namespace {

// The Brusselator of problems.brusselator(NB) (laplacian="slices"), state
// (u_1..u_NB, v_1..v_NB); c = (NB + 1)^2 / 50 rounded to f32 on the host.
template <int NB>
struct Brusselator {
  static constexpr int D = 2 * NB;
  float c;
  __device__ void operator()(const float* y, float /*t*/, float* out) const {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float u = y[i], v = y[NB + i];
      const float ul = i == 0 ? 1.0f : y[i - 1], ur = i == NB - 1 ? 1.0f : y[i + 1];
      const float vl = i == 0 ? 3.0f : y[NB + i - 1], vr = i == NB - 1 ? 3.0f : y[NB + i + 1];
      const float conv_u = ul - 2.0f * u + ur;
      const float conv_v = vl - 2.0f * v + vr;
      out[i] = 1.0f + u * u * v - 4.0f * u + c * conv_u;
      out[NB + i] = 3.0f * u - u * u * v + c * conv_v;
    }
  }
  // the terms of forward-mode differentiation of operator(), in its order
  __device__ void jac(const float* y, float /*t*/, float (*J)[D]) const {
#pragma unroll
    for (int r = 0; r < D; ++r)
#pragma unroll
      for (int k = 0; k < D; ++k) J[r][k] = 0.0f;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float u = y[i], v = y[NB + i];
      const float two_uv = (2.0f * u) * v;
      const float uu = u * u;
      J[i][i] = (two_uv - 4.0f) - 2.0f * c;
      J[i][NB + i] = uu;
      J[NB + i][i] = 3.0f - two_uv;
      J[NB + i][NB + i] = -uu - 2.0f * c;
      if (i > 0) {
        J[i][i - 1] = c;
        J[NB + i][NB + i - 1] = c;
      }
      if (i < NB - 1) {
        J[i][i + 1] = c;
        J[NB + i][NB + i + 1] = c;
      }
    }
  }
};

template <int ND>
struct LaneDense {
  float t, scale, t_prev, dt, errn_prev, nsteps, mle;
  float mean[ND], chol[ND][ND], bwdG[ND][ND], bwd_m[ND], bwd_L[ND][ND];
  float mean_prev[ND], chol_prev[ND][ND], bwdG_prev[ND][ND], bwd_m_prev[ND], bwd_L_prev[ND][ND];
};

// An attempt's working arrays; the three QR column lists share storage.
template <int ND, int D>
struct WorkDense {
  union {
    float rev[2 * ND][2 * ND];  // revert QR: cols[c][r] = R[r][c]
    float cor[D + ND][ND];      // correction QR
    float fp[ND][2 * ND];       // fixedpoint QR
  };
  float l_pred[ND][ND], gain[ND][ND], bwd_L_step[ND][ND];
};

template <int ND>
__device__ __forceinline__ LaneInputs load_lane_dense(LaneDense<ND>& s, const Args& args,
                                                      int64_t b, int64_t B) {
  constexpr int V = ND, Q = ND * ND;
  s.t = args.in[0][b];
  load_flat<V>(s.mean, args.in[1], b, B);
  load_flat<Q>(&s.chol[0][0], args.in[2], b, B);
  load_flat<Q>(&s.bwdG[0][0], args.in[3], b, B);
  load_flat<V>(s.bwd_m, args.in[4], b, B);
  load_flat<Q>(&s.bwd_L[0][0], args.in[5], b, B);
  s.scale = args.in[6][b];
  s.t_prev = args.in[7][b];
  load_flat<V>(s.mean_prev, args.in[8], b, B);
  load_flat<Q>(&s.chol_prev[0][0], args.in[9], b, B);
  load_flat<Q>(&s.bwdG_prev[0][0], args.in[10], b, B);
  load_flat<V>(s.bwd_m_prev, args.in[11], b, B);
  load_flat<Q>(&s.bwd_L_prev[0][0], args.in[12], b, B);
  s.dt = args.in[13][b];
  s.errn_prev = args.in[14][b];
  s.nsteps = args.in[15][b];
  s.mle = args.in[16][b];
  return LaneInputs{args.in[17][b], args.in[18][b], args.in[19][b],
                    args.in[20][b], args.in[21][b], args.in[22][b]};
}

template <int ND>
__device__ __forceinline__ void store_lane_dense(const LaneDense<ND>& s, const Args& args,
                                                 int64_t b, int64_t B) {
  constexpr int V = ND, Q = ND * ND;
  args.out[0][b] = s.t;
  store_flat<V>(s.mean, args.out[1], b, B);
  store_flat<Q>(&s.chol[0][0], args.out[2], b, B);
  store_flat<Q>(&s.bwdG[0][0], args.out[3], b, B);
  store_flat<V>(s.bwd_m, args.out[4], b, B);
  store_flat<Q>(&s.bwd_L[0][0], args.out[5], b, B);
  args.out[6][b] = s.scale;
  args.out[7][b] = s.t_prev;
  store_flat<V>(s.mean_prev, args.out[8], b, B);
  store_flat<Q>(&s.chol_prev[0][0], args.out[9], b, B);
  store_flat<Q>(&s.bwdG_prev[0][0], args.out[10], b, B);
  store_flat<V>(s.bwd_m_prev, args.out[11], b, B);
  store_flat<Q>(&s.bwd_L_prev[0][0], args.out[12], b, B);
  args.out[13][b] = s.dt;
  args.out[14][b] = s.errn_prev;
  args.out[15][b] = s.nsteps;
  args.out[16][b] = s.mle;
}

template <int E>
__device__ __forceinline__ void copy_flat(float* dst, const float* src) {
#pragma unroll 4
  for (int e = 0; e < E; ++e) dst[e] = src[e];
}

// One accept/reject attempt (make_step_dense_ll's `step`), updating s in place.
template <int NU, bool TS1, class VF>
__device__ __forceinline__ void attempt_dense(LaneDense<(NU + 1) * VF::D>& s,
                                              WorkDense<(NU + 1) * VF::D, VF::D>& w,
                                              const Consts& c, const VF& vf,
                                              const LaneInputs& in) {
  constexpr int N = NU + 1;
  constexpr int D = VF::D;
  constexpr int ND = N * D;
  constexpr int M = 2 * ND;
  const float tiny_scale = in.tiny_scale;

  const float dt = minp(maxp(s.dt, in.dt_floor), in.dt_max);
  float pows[N];
  pows[NU] = 1.0f;
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) pows[i] = pows[i + 1] * dt;
  const float sq = sqrtf(dt);
  float p[N], p_inv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[i] = sq * pows[i] * c.inv_fact[i];
    p_inv[i] = 1.0f / p[i];
  }
  const float t_new = s.t + dt;

  // -- extrapolate the mean: m_pred = P (A kron I) P^-1 m
  float m_bar[ND], m_pred[ND];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < D; ++k) m_bar[i * D + k] = s.mean[i * D + k] * p_inv[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float acc = -0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (c.a[i * NMAX + j] != 0.0f) acc = acc + c.a[i * NMAX + j] * m_bar[j * D + k];
      m_pred[i * D + k] = acc * p[i];
    }

  // -- linearize at the predicted mean
  float fx[D], z[D], J[D][D];
  vf(m_pred, t_new, fx);
#pragma unroll
  for (int k = 0; k < D; ++k) z[k] = m_pred[D + k] - fx[k];
  if (TS1) vf.jac(m_pred, t_new, J);

  // -- sigma and the error: rows of H Q_unit^{1/2}, jointly row-normalized
  // with z, as the column list of a (nd, d) QR
  float rs[D][ND], zn[D];
#pragma unroll 1
  for (int r = 0; r < D; ++r) {
#pragma unroll
    for (int kk = 0; kk < N; ++kk) {
      const float base = p[1] * c.lq[NMAX + kk];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        bool has = j == r;
        float acc = has ? base : 0.0f;
        if (TS1 && c.lq[kk] != 0.0f) {
          const float term = (p[0] * c.lq[kk]) * J[r][j];
          acc = has ? acc - term : -term;
          has = true;
        }
        rs[r][kk * D + j] = has ? acc : 0.0f;
      }
    }
    const float mag_r = maxp(row_absmax(rs[r]), tiny_scale);
#pragma unroll
    for (int q = 0; q < ND; ++q) rs[r][q] = rs[r][q] / mag_r;
    zn[r] = z[r] / mag_r;
  }
  qr_r_cols_loop<ND, D>(rs);  // R_s[i][j] = rs[j][i]
  float white[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {  // R_s^T w = z_n
    float acc = zn[i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc = acc - rs[i][j] * white[j];
    float diag = rs[i][i];
    diag = fabsf(diag) > FLT_MIN ? diag : FLT_MIN;
    white[i] = acc / diag;
  }
  float ww = white[0] * white[0];
#pragma unroll
  for (int i = 1; i < D; ++i) ww = ww + white[i] * white[i];
  const float sigma = sqrtf(ww) / c.sqrt_d;
  const float err_u = sigma * (p[0] * c.lq_norm[0]);
  float qe = err_u / (in.atol + in.rtol * fabsf(m_pred[0]));
  float e2 = qe * qe;
#pragma unroll
  for (int r = 1; r < D; ++r) {
    qe = err_u / (in.atol + in.rtol * fabsf(m_pred[r]));
    e2 = e2 + qe * qe;
  }
  const float errn = c.kappa * sqrtf(e2 / static_cast<float>(D));
  const float sigma_safe = isfinite(sigma) ? sigma : c.big;
  const float new_scale = minp(maxp(sigma_safe, tiny_scale), c.big);

  // -- PI control and the decision (nothing below changes either)
  const float errn_s = maxp(errn, FLT_MIN);
  float factor = c.safety * expf(c.neg_n1 * logf(errn_s) +
                                 c.n2 * (logf(s.errn_prev) - logf(errn_s)));
  if (!isfinite(factor)) factor = c.factor_min;
  const float dt_next = minp(dt * minp(maxp(factor, c.factor_min), c.factor_max), in.dt_max);
  const float dt_stall = (4.0f * FLT_EPSILON) * maxp(fabsf(s.t), 1.0f);
  const bool frozen = s.t >= in.t_next;
  const bool accept = ((errn <= 1.0f) || (dt <= dt_stall)) && !frozen;
  if (!frozen) s.dt = dt_next;
  if (!accept) return;

  // accepted: the current state becomes the previous one, and everything
  // below reads the previous arrays and writes the current ones
  s.t_prev = s.t;
  copy_flat<ND>(s.mean_prev, s.mean);
  copy_flat<ND * ND>(&s.chol_prev[0][0], &s.chol[0][0]);
  copy_flat<ND * ND>(&s.bwdG_prev[0][0], &s.bwdG[0][0]);
  copy_flat<ND>(s.bwd_m_prev, s.bwd_m);
  copy_flat<ND * ND>(&s.bwd_L_prev[0][0], &s.bwd_L[0][0]);
  s.t = t_new;
  s.scale = new_scale;
  s.errn_prev = errn_s;
  s.nsteps = s.nsteps + 1.0f;
  s.mle = s.mle + sigma * sigma;

  // -- extrapolate the covariance (preconditioned, jointly normalized).
  // Revert-QR column c < nd is [row c of (A kron I) l_bar_n; row c of
  // kron(Lq, I) lq_s], column nd + c is [row c of l_bar_n; 0]
  float (&rev)[M][M] = w.rev;
  float mag = new_scale * c.max_lq;
#pragma unroll 1
  for (int i = 0; i < ND; ++i)
#pragma unroll 4
    for (int k = 0; k < ND; ++k) {
      const float lb = minp(maxp(s.chol_prev[i][k] * p_inv[i / D], -c.clip), c.clip);
      rev[ND + i][k] = lb;
      mag = maxp(mag, fabsf(lb));
    }
  mag = maxp(mag * c.a_inf_norm, tiny_scale);
  const float inv_mag = 1.0f / mag;
  const float lq_s = new_scale * inv_mag;
#pragma unroll 1
  for (int i = 0; i < ND; ++i)
#pragma unroll 4
    for (int k = 0; k < ND; ++k) {
      rev[ND + i][k] = rev[ND + i][k] * inv_mag;
      rev[ND + i][ND + k] = 0.0f;
    }
#pragma unroll 1
  for (int i = 0; i < N; ++i)
#pragma unroll 1
    for (int a = 0; a < D; ++a) {
      const int r = i * D + a;
#pragma unroll 4
      for (int k = 0; k < ND; ++k) {
        float acc = -0.0f;
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (c.a[i * NMAX + j] != 0.0f) acc = acc + c.a[i * NMAX + j] * rev[ND + j * D + a][k];
        rev[r][k] = acc;
      }
#pragma unroll
      for (int kk = 0; kk < N; ++kk)
#pragma unroll
        for (int jj = 0; jj < D; ++jj) {
          const float l = c.lq[i * NMAX + kk];
          rev[r][ND + kk * D + jj] = (jj == a && l != 0.0f) ? l * lq_s : 0.0f;
        }
    }
  qr_r_cols_loop<M, M>(rev);
  // gain[r][k] = X[k][r] for X = R_yy^-1 R_yx, then the preconditioner
  tri_solve_upper_t<ND, ND>(rev, w.gain);
  float bwd_m_step[ND];
#pragma unroll 1
  for (int r = 0; r < ND; ++r) {
    const float pr = p[r / D];
#pragma unroll 4
    for (int k = 0; k < ND; ++k) {
      w.l_pred[r][k] = (rev[r][k] * mag) * pr;
      w.gain[r][k] = (w.gain[r][k] * pr) * p_inv[k / D];
      w.bwd_L_step[r][k] = (rev[ND + r][ND + k] * mag) * pr;
    }
    float acc = w.gain[r][0] * m_pred[0];
#pragma unroll 4
    for (int j = 1; j < ND; ++j) acc = acc + w.gain[r][j] * m_pred[j];
    bwd_m_step[r] = s.mean_prev[r] - acc;
  }

  // -- TS0 / TS1 correction: one QR revert on (nd, d + nd); column r < d is
  // row r of H L (H = E_1 - J E_0), column d + c is row c of L
  float (&cor)[D + ND][ND] = w.cor;
  float lmag = tiny_scale;
#pragma unroll 1
  for (int i = 0; i < ND; ++i)
#pragma unroll 4
    for (int k = 0; k < ND; ++k) lmag = maxp(lmag, fabsf(w.l_pred[i][k]));
  const float inv_l = 1.0f / lmag;
  float zc[D];
#pragma unroll 1
  for (int r = 0; r < D; ++r) {
#pragma unroll 4
    for (int q = 0; q < ND; ++q) {
      float acc = w.l_pred[D + r][q];
      if (TS1) {
#pragma unroll
        for (int cc = 0; cc < D; ++cc) acc = acc - J[r][cc] * w.l_pred[cc][q];
      }
      cor[r][q] = acc;
    }
    const float hl_mag = maxp(row_absmax(cor[r]), tiny_scale);
#pragma unroll 4
    for (int q = 0; q < ND; ++q) cor[r][q] = (cor[r][q] / hl_mag) * inv_l;
    zc[r] = z[r] / hl_mag;
  }
#pragma unroll 1
  for (int i = 0; i < ND; ++i)
#pragma unroll 4
    for (int k = 0; k < ND; ++k) cor[D + i][k] = w.l_pred[i][k] * inv_l;
  qr_r_cols_loop<ND, D + ND>(cor);
  float gain_c[ND][D];  // gain_c[i][r] = X[r][i], X = R_yy^-1 R_yx
  tri_solve_upper_t<D, ND>(cor, gain_c);
#pragma unroll 1
  for (int i = 0; i < ND; ++i) {
    float delta = gain_c[i][0] * zc[0];
#pragma unroll
    for (int r = 1; r < D; ++r) delta = delta + gain_c[i][r] * zc[r];
    s.mean[i] = m_pred[i] - delta;
#pragma unroll 4
    for (int k = 0; k < ND; ++k) s.chol[i][k] = k < ND - D ? cor[D + i][D + k] * lmag : 0.0f;
  }

  // -- fixedpoint accumulation
  float mag_g = tiny_scale;
#pragma unroll 1
  for (int i = 0; i < ND; ++i) {
#pragma unroll 4
    for (int k = 0; k < ND; ++k) {
      float acc = s.bwdG_prev[i][0] * w.gain[0][k];
#pragma unroll 4
      for (int j = 1; j < ND; ++j) acc = acc + s.bwdG_prev[i][j] * w.gain[j][k];
      s.bwdG[i][k] = acc;
      mag_g = maxp(mag_g, fabsf(s.bwdG_prev[i][k]));
    }
    float acc = s.bwdG_prev[i][0] * bwd_m_step[0];
#pragma unroll 4
    for (int j = 1; j < ND; ++j) acc = acc + s.bwdG_prev[i][j] * bwd_m_step[j];
    s.bwd_m[i] = acc + s.bwd_m_prev[i];
  }
  const float inv_g = 1.0f / mag_g;
  // fixedpoint QR column c is [row c of m1; row c of bl_g] / t3
  float (&fp)[ND][M] = w.fp;
  float t3 = tiny_scale;
#pragma unroll 1
  for (int i = 0; i < ND; ++i)
#pragma unroll 1
    for (int k = 0; k < ND; ++k) {
      float acc = (s.bwdG_prev[i][0] * inv_g) * w.bwd_L_step[0][k];
#pragma unroll 4
      for (int j = 1; j < ND; ++j) acc = acc + (s.bwdG_prev[i][j] * inv_g) * w.bwd_L_step[j][k];
      fp[i][k] = acc;
      fp[i][ND + k] = s.bwd_L_prev[i][k] * inv_g;
      t3 = maxp(t3, maxp(fabsf(acc), fabsf(fp[i][ND + k])));
    }
  const float inv3 = 1.0f / t3;
#pragma unroll 1
  for (int i = 0; i < ND; ++i)
#pragma unroll 4
    for (int k = 0; k < M; ++k) fp[i][k] = fp[i][k] * inv3;
  qr_r_cols_loop<M, ND>(fp);
#pragma unroll 1
  for (int i = 0; i < ND; ++i)
#pragma unroll 4
    for (int k = 0; k < ND; ++k) s.bwd_L[i][k] = (fp[i][k] * t3) * mag_g;
}

}  // namespace
