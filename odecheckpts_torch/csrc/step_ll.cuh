// The f32 step of K1 (step_ll.cu), K3 (step_ll_attempt.cu) and K7
// (step_everystep_attempt.cu): one adaptive attempt of the isotropic TS0
// solver, one IVP lane per thread.
//
// K1 replaces odecheckpts_tpu/batched.py:_pallas_interval(make_step_ll), the
// Pallas kernel of the f32 work-precision path; K3 replaces
// batched.py:_pallas_step(make_step_ll), one attempt per launch; both run the
// fixedpoint strategy.  K7 replaces batched_everystep.py:238,
// _pallas_step(make_step_ll) with strategy "smoother" or "filter": the
// strategy is a template parameter of the attempt.  The plain PyTorch twin is
// odecheckpts_torch/batched.py:StepLL.
//
// What bounds it: per-thread registers and latency, not bytes.  A lane's
// state is 4*n*d + 6*n*n + 7 floats (217 at nu=4, d=3), plus the
// (2n) x (2n) = 100-float column list of the revert QR and the step's
// temporaries.  An attempt is a few thousand dependent scalar operations;
// in K1 the lane reads its state once, loops over attempts in registers and
// local memory, and writes the state once: rejected attempts never touch
// device memory.  32,768 lanes are one wave of 1,024 warps, under two a
// scheduler, so each lane's chain runs at its own latency, and what costs
// is whatever lengthens it.  K1 and K3 (run_lane) therefore keep the
// current arrays in registers and move the five previous arrays (written
// once per accepted attempt, read once per launch) to shared memory: at
// nu = 4, where 255 registers do not hold a lane, the spills fall from
// 1,060 to 246 bytes a thread; at nu = 2 the registers from 196 to 153.
// Designs that put the current state in shared memory, or a team of two
// threads on a lane, were slower (PERF.md).  K7 holds only what its
// attempt reads (LaneAttempt).

// Layout: every array is lanes-last in device memory, so thread b reads
// x[i * B + b] and neighbouring threads load neighbouring addresses.
//
// The arithmetic follows odecheckpts_tpu/batched.py:make_step_ll literally,
// operation by operation and in the same order, including:
//   * the column-list Householder QR _qr_r_cols (batched.py:70-103), which
//     has NO power-of-two scaling and NO sign normalization -- unlike
//     linalg.qr_r.  Do not move it towards linalg.qr_r: the difference flips
//     knife-edge accepts;
//   * _tri_solve_upper_ll with its eps^2 zeroing (batched.py:113-141);
//   * the +-1e30 clip of l_bar, the per-lane `mag` normalization, the finite
//     ceiling FLT_MAX^0.4 on the scale, `s2 + FLT_MIN`, the bwdG / t3
//     normalizations of the fixedpoint accumulation;
//   * PI control with non-finite factors mapped to factor_min, the stall
//     bound dt_stall = 4 eps max(|t|, 1), the nsteps / mle updates.
// Maxima and clips propagate NaN as jnp.maximum / torch.maximum do.  Build
// with -fmad=false and without --use_fast_math: every operation rounds on
// its own as in the twin, and the eps^2 / FLT_MIN floors rely on IEEE
// division, square root and subnormals.

#pragma once

#include <cstring>

#include "lanes.cuh"

namespace {

constexpr int NMAX = 5;  // n = nu + 1 for nu <= 4
constexpr int NUM_STATE = 17;
constexpr int NUM_IN = NUM_STATE + 6;  // + t_next, atol, rtol, dt_max, dt_floor, tiny_scale

// Rounded f32 constants, in the order of StepLL.packed_constants().  Passed
// by value, so they sit in the kernel's parameter (constant) bank.
struct Consts {
  float a[NMAX * NMAX];   // Pascal transition A, row-major, stride NMAX
  float lq[NMAX * NMAX];  // chol(Qbar), row-major, stride NMAX
  float lq_norm[NMAX];    // ||Lq[k, :]||
  float inv_fact[NMAX];   // 1 / (nu - i)!
  float max_lq, a_inf_norm, sqrt_d, kappa, neg_n1, n2, safety, factor_min,
      factor_max, big, clip;
};
static_assert(sizeof(Consts) == 71 * sizeof(float), "layout of StepLL.packed_constants");

struct Args {
  const float* in[NUM_IN];
  float* out[NUM_STATE];
};

// Vector fields as functors: D fixes the ODE dimension, the parameters come
// in as kernel arguments.  Each one mirrors the row-wise torch vector field
// of the same name in problems.py.
struct RigidBody {
  static constexpr int D = 3;
  float p1, p2, p3;
  __device__ void operator()(const float* u, float /*t*/, float* out) const {
    out[0] = p1 * u[1] * u[2];
    out[1] = p2 * u[0] * u[2];
    out[2] = p3 * u[0] * u[1];
  }
  // J[r][c] = d out[r] / d u[c] (the dense step's TS1; problems.rigid_body's jac)
  __device__ void jac(const float* u, float /*t*/, float (*J)[D]) const {
    J[0][0] = 0.0f;
    J[0][1] = p1 * u[2];
    J[0][2] = p1 * u[1];
    J[1][0] = p2 * u[2];
    J[1][1] = 0.0f;
    J[1][2] = p2 * u[0];
    J[2][0] = p3 * u[1];
    J[2][1] = p3 * u[0];
    J[2][2] = 0.0f;
  }
};

// The rigid body in rescaled coordinates z = (1, 1, s3) * y
// (problems.rigid_body_anisotropic): p3s = s3 * p3, formed by the host.
struct RigidBodyAniso {
  static constexpr int D = 3;
  float p1, p2, p3s, s3;
  __device__ void operator()(const float* u, float /*t*/, float* out) const {
    const float w = u[2] / s3;
    out[0] = p1 * u[1] * w;
    out[1] = p2 * u[0] * w;
    out[2] = p3s * u[0] * u[1];
  }
};

// K7's lane: in registers only what an attempt of the smoother or the filter
// reads (mean, chol and the scalars).  The arrays it does not read never
// enter registers: an accepted smoother attempt stores its backward arrays
// straight to the output (put_backward), and store_attempt copies the rest
// from the input after the attempt (K7's first design held all 17 arrays
// and spilled at nu = 4).
template <int N, int D>
struct LaneAttempt {
  float t, scale, t_prev, dt, errn_prev, nsteps, mle;
  float mean[N][D], chol[N][N];
  float* const* out;
  int64_t b, B;
  bool moved;
  // before an accepted attempt replaces the current arrays: they become the
  // previous ones, which store_attempt copies from the input
  __device__ __forceinline__ void keep_previous() { moved = true; }
  __device__ __forceinline__ void put_backward(const float (&g)[N][N], const float (&m)[N][D],
                                               const float (&l)[N][N]) const {
    store(g, out[3], b, B);
    store(m, out[4], b, B);
    store(l, out[5], b, B);
  }
};

// The lane's previous arrays in shared memory: element e of the five at
// prev[e * THREADS], in the order mean, chol, bwdG, bwd_m, bwd_L (K1 and K3:
// out of the registers, where the first design spilled at nu >= 3).
template <int N, int D>
struct LanePrevShared {
  float t, scale, t_prev, dt, errn_prev, nsteps, mle;
  float mean[N][D], chol[N][N], bwdG[N][N], bwd_m[N][D], bwd_L[N][N];
  float* prev;
  bool moved;
  template <int R, int C>
  __device__ __forceinline__ void put(int at, const float (&x)[R][C]) const {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < C; ++k) prev[(at + i * C + k) * THREADS] = x[i][k];
  }
  __device__ __forceinline__ void keep_previous() {
    put(0, mean);
    put(N * D, chol);
    put(N * D + N * N, bwdG);
    put(N * D + 2 * N * N, bwd_m);
    put(2 * N * D + 2 * N * N, bwd_L);
    moved = true;
  }
};

// The per-lane kernel inputs besides the state.
struct LaneInputs {
  float t_next, atol, rtol, dt_max, dt_floor, tiny_scale;
};

// What an attempt leaves in the backward arrays (make_step_ll's `strategy`,
// batched.py:342-371, 398-437): the conditional accumulated since the last
// checkpoint, the attempt's own one-step conditional, or nothing (no
// reversal: the predicted factor comes from a (2n, n) QR and the backward
// arrays pass through).  The codes are kernels.STRATEGY_CODES.
constexpr int FIXEDPOINT = 0;
constexpr int SMOOTHER = 1;
constexpr int FILTER = 2;

// One accept/reject attempt (make_step_ll's `step`), updating s in place
// (a LanePrevShared for the fixedpoint strategy, a LaneAttempt for the
// others).
template <int NU, class VF, int STRATEGY = FIXEDPOINT, class S>
__device__ __forceinline__ void attempt(S& s, const Consts& c, const VF& vf,
                                        const LaneInputs& in) {
  const float t_next = in.t_next, atol = in.atol, rtol = in.rtol, dt_max = in.dt_max,
              dt_floor = in.dt_floor, tiny_scale = in.tiny_scale;
  constexpr int N = NU + 1;
  constexpr int D = VF::D;
  constexpr int M = 2 * N;

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

  // -- extrapolate the mean: m_pred = P A P^-1 m (zero entries of A skipped;
  // -0.0f is the exact identity of +)
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

  // -- TS0 residual on the first derivative
  float fx[D], z[D];
  vf(m_pred[0], t_new, fx);
#pragma unroll
  for (int k = 0; k < D; ++k) z[k] = m_pred[1][k] - fx[k];

  // -- local scale and error (solution units)
  const float s_unit = p[1] * c.lq_norm[1];
  float zz = z[0] * z[0];
  float q = atol + rtol * fabsf(m_pred[0][0]);
  float tol_acc = 1.0f / (q * q);
#pragma unroll
  for (int i = 1; i < D; ++i) {
    zz = zz + z[i] * z[i];
    q = atol + rtol * fabsf(m_pred[0][i]);
    tol_acc = tol_acc + 1.0f / (q * q);
  }
  const float sigma = sqrtf(zz) / (s_unit * c.sqrt_d);
  const float err_u = sigma * (p[0] * c.lq_norm[0]);
  const float errn = c.kappa * err_u * sqrtf(tol_acc / static_cast<float>(D));

  const float sigma_safe = isfinite(sigma) ? sigma : c.big;
  const float new_scale = minp(maxp(sigma_safe, tiny_scale), c.big);

  // -- extrapolate the covariance with reversal, preconditioned coordinates
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

  float l_pred[N][N], gain[N][N], bwd_L_step[N][N], bwd_m_step[N][D];
  if constexpr (STRATEGY == FILTER) {
    // no reversal: the N columns [ (A l_bar_n)[i] ; lq_s Lq[i] ], N reflections
    float cols[N][M];
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
      }
    qr_r_cols<M, N>(cols);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) l_pred[i][k] = (p[i] * cols[i][k]) * mag;
  } else {
    // revert-QR columns: column i < N is [ (A l_bar_n)[i] ; lq_s Lq[i] ],
    // column N + i is [ l_bar_n[i] ; 0 ]
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
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        l_pred[i][k] = p[i] * (cols[i][k] * mag);
        gain[i][k] = p[i] * x[k][i] / p[k];
        bwd_L_step[i][k] = p[i] * (cols[N + i][N + k] * mag);
      }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float acc = gain[i][0] * m_pred[0][k];
#pragma unroll
        for (int j = 1; j < N; ++j) acc = acc + gain[i][j] * m_pred[j][k];
        bwd_m_step[i][k] = s.mean[i][k] - acc;
      }
  }

  // -- TS0 correction (rank-1 update on the observation row)
  float l_obs_n[N];
  float m2 = maxp(row_absmax(l_pred[1]), tiny_scale);
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
  float bwdG_new[N][N], bwd_m_new[N][D], cols2[N][M];
  float mag_g = tiny_scale, t3 = tiny_scale;
  if constexpr (STRATEGY == FIXEDPOINT) {
    float m1[N][N], bl_g[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float acc = s.bwdG[i][0] * gain[0][k];
#pragma unroll
        for (int j = 1; j < N; ++j) acc = acc + s.bwdG[i][j] * gain[j][k];
        bwdG_new[i][k] = acc;
      }
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float acc = s.bwdG[i][0] * bwd_m_step[0][k];
#pragma unroll
        for (int j = 1; j < N; ++j) acc = acc + s.bwdG[i][j] * bwd_m_step[j][k];
        bwd_m_new[i][k] = acc + s.bwd_m[i][k];
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) mag_g = maxp(mag_g, row_absmax(s.bwdG[i]));
    const float inv_g = 1.0f / mag_g;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float acc = (s.bwdG[i][0] * inv_g) * bwd_L_step[0][k];
#pragma unroll
        for (int j = 1; j < N; ++j) acc = acc + (s.bwdG[i][j] * inv_g) * bwd_L_step[j][k];
        m1[i][k] = acc;
        bl_g[i][k] = s.bwd_L[i][k] * inv_g;
      }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      t3 = maxp(t3, row_absmax(m1[i]));
      t3 = maxp(t3, row_absmax(bl_g[i]));
    }
    const float inv3 = 1.0f / t3;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        cols2[i][k] = m1[i][k] * inv3;
        cols2[i][N + k] = bl_g[i][k] * inv3;
      }
    qr_r_cols<M, N>(cols2);
  }

  // -- PI control
  const float errn_s = maxp(errn, FLT_MIN);
  float factor = c.safety * expf(c.neg_n1 * logf(errn_s) +
                                 c.n2 * (logf(s.errn_prev) - logf(errn_s)));
  if (!isfinite(factor)) factor = c.factor_min;
  const float dt_next = minp(dt * minp(maxp(factor, c.factor_min), c.factor_max), dt_max);

  const float dt_stall = (4.0f * FLT_EPSILON) * maxp(fabsf(s.t), 1.0f);
  const bool frozen = s.t >= t_next;
  const bool accept = ((errn <= 1.0f) || (dt <= dt_stall)) && !frozen;

  if (!frozen) s.dt = dt_next;
  if (accept) {
    s.t_prev = s.t;
    s.keep_previous();
    s.t = t_new;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < D; ++k) s.mean[i][k] = m_pred[i][k] - g_corr[i] * z[k];
#pragma unroll
      for (int k = 0; k < N; ++k) s.chol[i][k] = l_pred[i][k] - gc[i] * l_obs_n[k];
    }
    if constexpr (STRATEGY == FIXEDPOINT) {
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int k = 0; k < N; ++k) s.bwd_L[i][k] = (cols2[i][k] * t3) * mag_g;
      copy_to(s.bwdG, bwdG_new);
      copy_to(s.bwd_m, bwd_m_new);
    } else if constexpr (STRATEGY == SMOOTHER) {
      s.put_backward(gain, bwd_m_step, bwd_L_step);
    }
    s.scale = new_scale;
    s.errn_prev = errn_s;
    s.nsteps = s.nsteps + 1.0f;
    s.mle = s.mle + sigma * sigma;
  }
}

// K7's lane in: the scalars, mean and chol; the output pointers for
// put_backward.
template <int N, int D>
__device__ __forceinline__ LaneInputs load_attempt(LaneAttempt<N, D>& s, const Args& args,
                                                   int64_t b, int64_t B) {
  s.t = args.in[0][b];
  load(s.mean, args.in[1], b, B);
  load(s.chol, args.in[2], b, B);
  s.scale = args.in[6][b];
  s.t_prev = args.in[7][b];
  s.dt = args.in[13][b];
  s.errn_prev = args.in[14][b];
  s.nsteps = args.in[15][b];
  s.mle = args.in[16][b];
  s.out = args.out;
  s.b = b;
  s.B = B;
  s.moved = false;
  return LaneInputs{args.in[17][b], args.in[18][b], args.in[19][b],
                    args.in[20][b], args.in[21][b], args.in[22][b]};
}

// The five arrays mean, chol, bwdG, bwd_m, bwd_L of one lane, in registers
// while store_attempt copies them.
template <int N, int D>
struct Five {
  float mean[N][D], chol[N][N], bwdG[N][N], bwd_m[N][D], bwd_L[N][N];
  __device__ __forceinline__ void load_from(const float* const* src, int64_t b, int64_t B) {
    load(mean, src[0], b, B);
    load(chol, src[1], b, B);
    load(bwdG, src[2], b, B);
    load(bwd_m, src[3], b, B);
    load(bwd_L, src[4], b, B);
  }
  __device__ __forceinline__ void store_to(float* const* dst, int64_t b, int64_t B) const {
    store(mean, dst[0], b, B);
    store(chol, dst[1], b, B);
    store(bwdG, dst[2], b, B);
    store(bwd_m, dst[3], b, B);
    store(bwd_L, dst[4], b, B);
  }
};

// K7's lane out, in two rounds of loads then stores (a lane waits for
// device memory twice, whatever it copies):
//   * the five previous arrays: the input's current arrays on an accepted
//     lane, its previous arrays otherwise;
//   * the five current arrays: on an accepted lane mean and chol from the
//     registers and the backward arrays from the input for the filter (the
//     smoother stored its own in put_backward); on a rejected or frozen
//     lane all five from the input.
// The scalars from the registers either way.
template <int STRATEGY, int N, int D>
__device__ __forceinline__ void store_attempt(const LaneAttempt<N, D>& s, const Args& args,
                                              int64_t b, int64_t B) {
  args.out[0][b] = s.t;
  args.out[6][b] = s.scale;
  args.out[7][b] = s.t_prev;
  args.out[13][b] = s.dt;
  args.out[14][b] = s.errn_prev;
  args.out[15][b] = s.nsteps;
  args.out[16][b] = s.mle;
  Five<N, D> x;
  x.load_from(args.in + (s.moved ? 1 : 8), b, B);
  x.store_to(args.out + 8, b, B);
  if (!s.moved) {
    x.load_from(args.in + 1, b, B);
    x.store_to(args.out + 1, b, B);
    return;
  }
  store(s.mean, args.out[1], b, B);
  store(s.chol, args.out[2], b, B);
  if constexpr (STRATEGY == FILTER) {
    load(x.bwdG, args.in[3], b, B);
    load(x.bwd_m, args.in[4], b, B);
    load(x.bwd_L, args.in[5], b, B);
    store(x.bwdG, args.out[3], b, B);
    store(x.bwd_m, args.out[4], b, B);
    store(x.bwd_L, args.out[5], b, B);
  }
}

// The current arrays and scalars of a LanePrevShared in and out; the
// previous arrays go out from shared memory after an accepted attempt, else
// straight from the input.
template <int N, int D>
__device__ __forceinline__ LaneInputs load_current(LanePrevShared<N, D>& s, const Args& args,
                                                   int64_t b, int64_t B) {
  s.t = args.in[0][b];
  load(s.mean, args.in[1], b, B);
  load(s.chol, args.in[2], b, B);
  load(s.bwdG, args.in[3], b, B);
  load(s.bwd_m, args.in[4], b, B);
  load(s.bwd_L, args.in[5], b, B);
  s.scale = args.in[6][b];
  s.t_prev = args.in[7][b];
  s.dt = args.in[13][b];
  s.errn_prev = args.in[14][b];
  s.nsteps = args.in[15][b];
  s.mle = args.in[16][b];
  s.moved = false;
  return LaneInputs{args.in[17][b], args.in[18][b], args.in[19][b],
                    args.in[20][b], args.in[21][b], args.in[22][b]};
}

template <int N, int D>
__device__ __forceinline__ void store_current(const LanePrevShared<N, D>& s, const Args& args,
                                              int64_t b, int64_t B) {
  args.out[0][b] = s.t;
  store(s.mean, args.out[1], b, B);
  store(s.chol, args.out[2], b, B);
  store(s.bwdG, args.out[3], b, B);
  store(s.bwd_m, args.out[4], b, B);
  store(s.bwd_L, args.out[5], b, B);
  args.out[6][b] = s.scale;
  args.out[7][b] = s.t_prev;
  args.out[13][b] = s.dt;
  args.out[14][b] = s.errn_prev;
  args.out[15][b] = s.nsteps;
  args.out[16][b] = s.mle;
  constexpr int size[5] = {N * D, N * N, N * N, N * D, N * N};
  int at = 0;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    float* dst = args.out[8 + r] + b;
#pragma unroll 1
    for (int e = 0; e < size[r]; ++e)
      dst[e * B] = s.moved ? s.prev[(at + e) * THREADS] : args.in[8 + r][e * B + b];
    at += size[r];
  }
}

// Dynamic shared memory of K1's and K3's blocks (see run_lane): a lane's
// five previous arrays.
template <int NU, int D>
constexpr int prev_smem_bytes() {
  constexpr int N = NU + 1;
  return static_cast<int>(sizeof(float)) * (2 * N * D + 3 * N * N) * THREADS;
}

// The attempts of one launch: while k < max_attempts and t < t_next
// (INTERVAL), or one.
template <int NU, class VF, bool INTERVAL, class S>
__device__ __forceinline__ void attempts(S& s, const Consts& c, const VF& vf,
                                         const LaneInputs& in, int max_attempts) {
  if constexpr (INTERVAL) {
    for (int k = 0; k < max_attempts && s.t < in.t_next; ++k) attempt<NU, VF>(s, c, vf, in);
  } else {
    attempt<NU, VF>(s, c, vf, in);
  }
}

// K1's and K3's lane through an interval (INTERVAL) or one attempt, the
// previous arrays in shared memory.
template <int NU, class VF, bool INTERVAL>
__device__ __forceinline__ void run_lane(const Args& args, const Consts& c, const VF& vf,
                                         int64_t B, int max_attempts) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;  // the ragged edge of the last block
  extern __shared__ float ll_prev[];
  LanePrevShared<NU + 1, VF::D> s;
  s.prev = ll_prev + threadIdx.x;
  const LaneInputs in = load_current(s, args, b, B);
  attempts<NU, VF, INTERVAL>(s, c, vf, in, max_attempts);
  store_current(s, args, b, B);
}

// Host side: the kernel arguments from the C interface's host arrays.
inline void unpack(Args& args, Consts& c, const void* in_ptrs, const void* out_ptrs,
                   const void* consts) {
  std::memcpy(args.in, in_ptrs, sizeof(args.in));
  std::memcpy(args.out, out_ptrs, sizeof(args.out));
  std::memcpy(&c, consts, sizeof(Consts));
}

}  // namespace
