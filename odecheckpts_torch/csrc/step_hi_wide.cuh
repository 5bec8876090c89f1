// The df32 step of K2 and K4 for wide states (step_hi_wide.cu,
// step_hi_wide_attempt.cu): one adaptive attempt of the isotropic TS0
// fixedpoint solver, mean, time axis and residual in compensated (hi, lo)
// f32 pairs, as step_hi.cuh's attempt_hi, for an IVP of d = 2 .. 1,024
// components: one block per IVP lane, one thread per component.
//
// K2 wide replaces odecheckpts_tpu/batched_hi.py:_pallas_interval(
// make_step_hi) and K4 wide batched_hi.py:_pallas_step(make_step_hi) at the
// widths of experiments/4_brusselator/batched_tpu.py (the Brusselator method
// of lines, d = 64 and 128, 256 lanes).  The plain PyTorch twin is
// odecheckpts_torch/batched_hi.py:StepHi, as for K2 and K4.
//
// Why not K2's thread per lane: a lane's mean and smoothing arrays alone are
// 4 n d floats (1,280 at nu = 4, d = 64); no thread holds them.  Here thread
// q keeps column q of mean_hi / mean_lo / msp_hi / msp_lo and of the
// extrapolated mean in registers (6 n floats).  The lane's (n, n) arrays
// (chol and G_acc, each twice: the current and the next; the gain), its
// scalars, the two decisions, the next attempt's step scalars (StepWide), a
// copy of the constants A and Lq and warp 0's scratch live in shared memory
// (LaneWide); so do three rows of d floats: the hi words of m_pred[0] (what
// the vector field reads of its neighbours) and each thread's two terms of
// the error sums.
//
// One attempt, three __syncthreads:
//   1. every thread reads the step scalars (remainder flags, dt, the
//      preconditioner, t_new, the extrapolation coefficients: formed once,
//      by the load or by the previous attempt's controller); each
//      extrapolates its column in pairs and writes its m_pred[0] hi word.
//      Barrier.
//   2. each evaluates f_q from that row (VF: a row functor, functors.cuh),
//      forms z_q = m_pred[1]_q - f_q in pairs and writes z_q.hi^2 and
//      1 / (atol + rtol |m_pred[0]_q|)^2.  Barrier.
//   3. warp 0 and the controller's warp (warp 1; warp 0 where the block is
//      one warp) each take the two sums over d in the twin's order (i = 0,
//      1, ..., d - 1; a tree would change the bits), lane 0 the residual's
//      and lane 1 the weights', side by side.  Then, at the same time:
//      warp 0 does the (n, n) covariance work of a full accept (cov_warp),
//      which needs the sums' scale and not the decision, into the next
//      buffers of chol and G_acc, the gain and g_corr; lane 0 of the
//      controller's warp forms the error, the PI controller and the accept
//      / snap / tiny decisions (control_wide), then the next attempt's step
//      scalars (step_scalars).  Barrier.
//   4. every thread reads the decisions (so every branch is uniform across
//      the block) and updates its column: mean_cor = m_pred - g_corr z_q,
//      msp += G_acc_old (gain (-g_corr z_q.hi)); a full accept makes the
//      next chol and G_acc current.
// The twin computes everything and then selects; the covariance work of a
// rejected attempt lands in buffers that stay unread, so the outputs are
// the twin's.
//
// cov_warp splits attempt_hi's serial (n, n) chain across warp 0 by
// independent outputs only, so every output keeps its operations and their
// order: an entry of l_bar a lane, then lane i < n takes row i's largest
// entry; lane c < 2n holds column c of the revert-QR column list in
// registers, and reflection j (j < n) is formed by every lane from column j
// (broadcast by shuffles), then applied by each lane c >= j to its own
// column; entry k of the normalized observation row in lane k; lane k < n
// solves column k of X = R_yy^-1 R_yx and forms row k of the rank-1 update
// and of g_corr; the gain's and G_acc gain's n^2 entries take a lane each.
// A lane's divisions and square roots (IEEE, with a branch to a slow path
// each) run one after the other, so independent ones go to separate lanes.
// The maxima keep one chain each (mag across the rows' maxima in row
// order), so NaNs propagate as in the twin.
//
// What bounds it: the serial chain of one attempt, not bytes or operations:
// a launch holds one lane a block, and 256 lanes are two blocks an SM.  The
// arithmetic is attempt_hi's, operation by operation (the same df32
// operations, the same QR and triangular solve): build with -fmad=false and
// without --use_fast_math.  Blocks of up to WIDE_SMALL_THREADS threads (d <=
// 128) take an instantiation whose launch bound leaves a thread up to 255
// registers; wider blocks one bounded at WIDE_MAX_THREADS (64 registers).

#pragma once

#include "functors.cuh"
#include "step_hi.cuh"

namespace {

// At most this many threads a block: d <= 1,024 (kernels.HI_WIDE_MAX_D).
constexpr int WIDE_MAX_THREADS = 1024;
// Blocks of at most this many threads take the instantiation of this launch
// bound (kernels.HI_WIDE_SMALL_THREADS)
constexpr int WIDE_SMALL_THREADS = 128;
constexpr int WIDE_WARP = 32;
constexpr unsigned WIDE_FULL_MASK = 0xffffffffu;
// The wide body's own order bound: its lane (LaneWide, StepWide) holds n <=
// NMAX_WIDE, so nu <= 5 (kernels.HI_WIDE_NU), whatever orders K2 and K4 take;
// its constants come padded to the same bound (StepHi.packed_constants() of
// a row functor).
constexpr int NMAX_WIDE = 6;
constexpr int NN_WIDE = NMAX_WIDE * NMAX_WIDE;
using ConstsWide = ConstsHiN<NMAX_WIDE>;
static_assert(sizeof(ConstsWide) == 99 * sizeof(float), "layout of StepHi.packed_constants");

// The step scalars of the lane's next attempt (make_step_hi's head: the
// remainder's flags, the clamped dt, the preconditioner, t_new and the
// extrapolation coefficients dt^k / k! as pairs), formed by one thread
// (step_scalars) and read by every thread.
struct StepWide {
  int frozen, clamped, tiny;
  float dt_mean, dt, t_new_hi, t_new_lo;
  float p[NMAX_WIDE], ck_hi[NMAX_WIDE], ck_lo[NMAX_WIDE];
};

// The lane's part of the block's shared memory (dynamic, at its start).
// (n, n) arrays are row-major at stride n; a and lq at stride NMAX_WIDE.
struct LaneWide {
  float t_hi, t_lo, scale, dt, errn_prev, nsteps;
  int accept, tiny;         // the controller's decisions of the attempt
  float chol[2][NN_WIDE];   // the current and the next chol
  float g_acc[2][NN_WIDE];  // the current and the next G_acc
  float gain[NN_WIDE];      // warp 0 also stages X^T there
  float g_corr[NMAX_WIDE];
  float a[NN_WIDE], lq[NN_WIDE];  // the constants A and Lq (ConstsWide's)
  float work[2 * NN_WIDE];  // warp 0: l_bar, then l_bar_n, then rows < n of the QR's columns
  StepWide st;              // the next attempt's step scalars
};
constexpr int WIDE_LANE_FLOATS = 363;  // kernels.HI_WIDE_LANE_FLOATS
static_assert(sizeof(LaneWide) == WIDE_LANE_FLOATS * sizeof(float), "layout of LaneWide");

// Threads of a block for d components: whole warps.
inline int wide_threads(int d) { return (d + WIDE_WARP - 1) / WIDE_WARP * WIDE_WARP; }

// Dynamic shared memory of a block: LaneWide and three rows of d floats.
inline int wide_smem_bytes(int d) {
  return static_cast<int>(sizeof(float)) * (WIDE_LANE_FLOATS + 3 * d);
}

// Thread q's column of the lane's (n, d) pair arrays.
template <int N>
struct ColumnHi {
  float mean_hi[N], mean_lo[N], msp_hi[N], msp_lo[N];
};

// x[i] for the lane's own i (a select over the unrolled indices: a
// register array indexed at run time would go to local memory).
template <int N>
__device__ __forceinline__ float pick(const float (&x)[N], int i) {
  float v = x[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = i == k ? x[k] : v;
  return v;
}

// The step scalars of the attempt that starts from L's time axis and dt
// into L.st (attempt_hi's head, operation by operation).
template <int NU>
__device__ __forceinline__ void step_scalars(LaneWide& L, const ConstsWide& c,
                                             const LaneInputsHi& in) {
  constexpr int N = NU + 1;
  StepWide& st = L.st;
  // remainder to the checkpoint on the compensated time axis
  const float t_hi = L.t_hi, t_lo = L.t_lo;
  const F2 se = two_sum(in.t_next, -t_hi);
  const float rem = maxp(se.hi + (se.lo - t_lo), 0.0f);
  const float dt_prop = minp(maxp(L.dt, in.dt_floor), in.dt_max);
  const bool clamped = rem <= dt_prop;
  const float dt_mean = minp(dt_prop, rem);
  const float dt = maxp(dt_mean, in.dt_floor);
  st.frozen = rem <= 0.0f;
  st.clamped = clamped;
  st.tiny = clamped && (rem <= c.tiny_frac * in.dt_max);
  st.dt_mean = dt_mean;
  st.dt = dt;

  float pows[N];
  pows[NU] = 1.0f;
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) pows[i] = pows[i + 1] * dt;
  const float sq = sqrtf(dt);
#pragma unroll
  for (int i = 0; i < N; ++i) st.p[i] = sq * pows[i] * c.inv_fact[i];
  const F2 t_new = add1(F2{t_hi, t_lo}, dt_mean);
  st.t_new_hi = t_new.hi;
  st.t_new_lo = t_new.lo;
  F2 ck{dt_mean, 0.0f};  // ck[k] = dt_mean^k / k!
  st.ck_hi[1] = ck.hi;
  st.ck_lo[1] = ck.lo;
#pragma unroll
  for (int k = 2; k < N; ++k) {
    ck = div1(mul1(ck, dt_mean), static_cast<float>(k));
    st.ck_hi[k] = ck.hi;
    st.ck_lo[k] = ck.lo;
  }
}

// Warp 0's part of a full accept (module comment): the covariance
// extrapolation with reversal, the first n reflections of the revert QR, the
// gain, the rank-1 update of chol into L.chol[cur ^ 1], g_corr and G_acc
// gain into L.g_acc[cur ^ 1], attempt_hi's arithmetic output by output.  w
// is the thread's lane in warp 0; every lane of the warp calls it.
template <int NU>
__device__ __forceinline__ void cov_warp(LaneWide& L, const ConstsWide& c, const float (&p)[NU + 1],
                                         float new_scale, float tiny_scale, int cur, int w) {
  constexpr int N = NU + 1;
  constexpr int O = 1;
  constexpr int M = 2 * N;
  const float* chol = L.chol[cur];
  const float* g_acc = L.g_acc[cur];
  float* work = L.work;
  const float p_w = pick(p, w);

  // -- extrapolate the covariance (f32) with reversal, preconditioned: an
  // entry of l_bar a lane (a division each, side by side), then row w in
  // lane w < n
  for (int at = w; at < N * N; at += WIDE_WARP)
    work[at] = minp(maxp(chol[at] / pick(p, at / N), -c.clip), c.clip);
  __syncwarp();
  float row[N];
  float row_max = 0.0f;
  if (w < N) {
#pragma unroll
    for (int k = 0; k < N; ++k) row[k] = work[w * N + k];
    row_max = row_absmax(row);
  }
  float mag = new_scale * c.max_lq;
#pragma unroll
  for (int i = 0; i < N; ++i) mag = maxp(mag, __shfl_sync(WIDE_FULL_MASK, row_max, i));
  mag = maxp(mag * c.a_inf_norm, tiny_scale);
  const float inv_mag = 1.0f / mag;
  if (w < N) {
#pragma unroll
    for (int k = 0; k < N; ++k) work[w * N + k] = row[k] * inv_mag;  // l_bar_n
  }
  const float lq_s = new_scale * inv_mag;
  __syncwarp();

  // revert-QR columns, column w in lane w < 2n: column i < n is
  // [ (A l_bar_n)[i] ; lq_s Lq[i] ], column n + i is [ l_bar_n[i] ; 0 ]
  float col[M];
#pragma unroll
  for (int r = 0; r < M; ++r) col[r] = 0.0f;
  if (w < N) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = -0.0f;  // the exact identity of +; zero entries of A skipped
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float a = L.a[w * NMAX_WIDE + j];
        if (a != 0.0f) acc = acc + a * work[j * N + k];
      }
      col[k] = acc;
      col[N + k] = lq_s * L.lq[w * NMAX_WIDE + k];
    }
  } else if (w < M) {
#pragma unroll
    for (int k = 0; k < N; ++k) col[k] = work[(w - N) * N + k];
  }

  // the first n reflections (lanes.cuh's qr_r_cols<M, M, N>): every lane
  // forms reflection j from column j, each lane c >= j applies it to its own
  // column
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float colm[M];
#pragma unroll
    for (int r = 0; r < M; ++r)
      colm[r] = __shfl_sync(WIDE_FULL_MASK, col[r], j) * (r >= j ? 1.0f : 0.0f);
    float norm2 = colm[0] * colm[0];
#pragma unroll
    for (int r = 1; r < M; ++r) norm2 = norm2 + colm[r] * colm[r];
    const float norm = sqrtf(norm2 + FLT_MIN);
    float head = colm[0] * (j == 0 ? 1.0f : 0.0f);
#pragma unroll
    for (int r = 1; r < M; ++r) head = head + colm[r] * (r == j ? 1.0f : 0.0f);
    const float sign = head >= 0.0f ? 1.0f : -1.0f;
    const float alpha = -sign * norm;
    float v[M];
#pragma unroll
    for (int r = 0; r < M; ++r) v[r] = colm[r] - (r == j ? 1.0f : 0.0f) * alpha;
    const float vnorm2 = norm2 + alpha * alpha - 2.0f * head * alpha;
    const float inv = vnorm2 > FLT_MIN ? 2.0f / vnorm2 : 0.0f;
    if (w >= j && w < M) {
      float coeff = v[0] * col[0];
#pragma unroll
      for (int r = 1; r < M; ++r) coeff = coeff + v[r] * col[r];
#pragma unroll
      for (int r = 0; r < M; ++r) col[r] = col[r] - inv * v[r] * coeff;
    }
  }
  // R[r][c] = column c's row r (r < n) to work[c * n + r]; row w of l_pred
  float l_pred[N];
#pragma unroll
  for (int k = 0; k < N; ++k) l_pred[k] = (p_w * col[k]) * mag;
  __syncwarp();  // every lane has read l_bar_n
  if (w < M) {
#pragma unroll
    for (int r = 0; r < N; ++r) work[w * N + r] = col[r];
  }
  float l_obs[N];  // row O of l_pred, from lane O
#pragma unroll
  for (int k = 0; k < N; ++k) l_obs[k] = __shfl_sync(WIDE_FULL_MASK, l_pred[k], O);
  // -- correction (rank-1 update on the observation row l_pred[O]): its
  // scale in every lane, entry k of the normalized row in lane k
  const float m2 = maxp(row_absmax(l_obs), tiny_scale);
  const float obs_w = pick(l_obs, w) / m2;
  float l_obs_n[N];
#pragma unroll
  for (int k = 0; k < N; ++k) l_obs_n[k] = __shfl_sync(WIDE_FULL_MASK, obs_w, k);
  __syncwarp();

  if (w < N) {
    // X = R_yy^-1 R_yx (lanes.cuh's tri_solve_upper), column w, its
    // operands loaded first; X^T's row w to the gain's place
    float r_yx[N], r_yy[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      r_yx[i] = work[(N + w) * N + i];
#pragma unroll
      for (int j = i; j < N; ++j) r_yy[i][j] = work[j * N + i];
    }
    const float eps2 = FLT_EPSILON * FLT_EPSILON;
    float x[N];
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      const float dd = r_yy[i][i];
      const bool ok = fabsf(dd) > eps2;
      float acc = r_yx[i];
#pragma unroll
      for (int j = i + 1; j < N; ++j) acc = acc - r_yy[i][j] * x[j];
      x[i] = ok ? acc / dd : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) L.gain[w * N + k] = x[k];
    // row w of the rank-1 update and g_corr
    float s2 = l_obs_n[0] * l_obs_n[0];
#pragma unroll
    for (int k = 1; k < N; ++k) s2 = s2 + l_obs_n[k] * l_obs_n[k];
    s2 = s2 + FLT_MIN;
    float acc = l_pred[0] * l_obs_n[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + l_pred[j] * l_obs_n[j];
    const float gc = acc / s2;
    L.g_corr[w] = gc / m2;
    float* chol_next = L.chol[cur ^ 1];
#pragma unroll
    for (int k = 0; k < N; ++k) chol_next[w * N + k] = l_pred[k] - gc * l_obs_n[k];
  }
  __syncwarp();
  // the gain, an entry a lane: gain[i][k] = p[i] X[k][i] / p[k]
  for (int at = w; at < N * N; at += WIDE_WARP) {
    const int i = at / N, k = at - i * N;
    L.gain[at] = pick(p, i) * L.gain[at] / pick(p, k);
  }
  __syncwarp();

  // -- fixedpoint accumulation: G_acc gain, an output a lane, into the next
  // buffer
  float* g_next = L.g_acc[cur ^ 1];
  for (int at = w; at < N * N; at += WIDE_WARP) {
    const int i = at / N, k = at - i * N;
    float acc = g_acc[i * N + 0] * L.gain[0 * N + k];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + g_acc[i * N + j] * L.gain[j * N + k];
    g_next[at] = acc;
  }
}

// The controller's lane: the error from the two sums, the PI controller and
// the decisions into L (accept, tiny, dt, the time axis and errn memory; on
// a full accept scale and nsteps).
template <int NU>
__device__ __forceinline__ void control_wide(LaneWide& L, const ConstsWide& c,
                                             const LaneInputsHi& in, int d,
                                             const float (&p)[NU + 1], F2 t_new, float dt,
                                             bool frozen, bool clamped, bool tiny, float sigma,
                                             float tol_acc, float new_scale) {
  constexpr int O = 1;
  const float s_unit = p[O] * c.lq_norm[O];
  const float err_u = c.residual != 0.0f ? sigma * s_unit : sigma * (p[0] * c.lq_norm[0]);
  const float errn = c.kappa * err_u * sqrtf(tol_acc / static_cast<float>(d));
  const float errn_s = maxp(errn, FLT_MIN);
  float factor = c.safety * expf(c.neg_n1 * logf(errn_s) +
                                 c.n2 * (logf(L.errn_prev) - logf(errn_s)));
  if (!isfinite(factor)) factor = c.factor_min;
  const float dt_next = minp(dt * minp(maxp(factor, c.factor_min), c.factor_max), in.dt_max);
  const float dt_stall = c.stall * maxp(fabsf(L.t_hi), 1.0f);
  const bool accept = ((errn <= 1.0f) || (dt <= dt_stall) || tiny) && !frozen;
  const bool snap = accept && clamped;
  L.accept = accept;
  L.tiny = tiny;
  if (!(frozen || snap)) L.dt = dt_next;
  if (!accept) return;
  if (snap) {
    L.t_hi = in.t_next;
    L.t_lo = 0.0f;
  } else {
    L.t_hi = t_new.hi;
    L.t_lo = t_new.lo;
    L.errn_prev = errn_s;
  }
  if (tiny) return;  // extrapolation only; covariance and accumulation frozen
  L.scale = new_scale;
  L.nsteps = L.nsteps + 1.0f;
}

// One accept/reject attempt of the lane (make_step_hi's `step`) by the
// whole block: thread q < d holds column q in s; `cur` (the same in every
// thread) names the current chol and G_acc buffers.  `sh` holds the three
// rows of d floats.  Every thread of the block calls it: it holds three
// barriers.
template <int NU, class VF>
__device__ __forceinline__ void attempt_wide(LaneWide& L, float* sh, ColumnHi<NU + 1>& s,
                                             const ConstsWide& c, const VF& vf,
                                             const LaneInputsHi& in, int d, int& cur) {
  constexpr int N = NU + 1;
  constexpr int O = VF::O;
  static_assert(O == 1, "the wide df32 step runs vector fields of order 1");
  static_assert(N <= NMAX_WIDE, "the wide lane is built for nu <= 5");
  const int q = static_cast<int>(threadIdx.x);
  const int warp = q / WIDE_WARP, w = q % WIDE_WARP;
  const int control_warp = blockDim.x > WIDE_WARP ? 1 : 0;
  const bool mine = q < d;
  float* row = sh;
  float* zsq = sh + d;
  float* qinv = sh + 2 * d;

  // the step scalars, formed by the previous attempt's controller or at the
  // load (L.st)
  const bool frozen = L.st.frozen, clamped = L.st.clamped, tiny = L.st.tiny;
  const float dt_mean = L.st.dt_mean, dt = L.st.dt;
  const F2 t_new{L.st.t_new_hi, L.st.t_new_lo};
  float p[N];
  F2 ck[N];  // ck[k] = dt_mean^k / k!; ck[0] unused
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = L.st.p[i];
#pragma unroll
  for (int k = 1; k < N; ++k) ck[k] = F2{L.st.ck_hi[k], L.st.ck_lo[k]};

  // -- extrapolate the column in pairs, real coordinates: m_i + sum_k c_k m_{i+k}
  F2 m_pred[N];
  if (mine) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      F2 acc{s.mean_hi[i], s.mean_lo[i]};
#pragma unroll
      for (int k = 1; k < N - i; ++k)
        acc = add(acc, mul(F2{s.mean_hi[i + k], s.mean_lo[i + k]}, ck[k]));
      m_pred[i] = acc;
    }
    row[q] = m_pred[0].hi;
  }
  __syncthreads();

  // -- the residual on derivative O in pairs, f on the hi words of the row
  F2 z{0.0f, 0.0f};
  if (mine) {
    z = sub(m_pred[O], F2{vf(row, q, d), 0.0f});
    zsq[q] = z.hi * z.hi;
    const float qq = in.atol + in.rtol * fabsf(m_pred[0].hi);
    qinv[q] = 1.0f / (qq * qq);
  }
  __syncthreads();

  if (warp == 0 || warp == control_warp) {
    // -- local scale and error (f32: they only steer the controller), the
    // two sums in the twin's order, lane 0's and lane 1's side by side
    const float* terms = (w & 1) ? qinv : zsq;
    float acc = terms[0];
    for (int i = 1; i < d; ++i) acc = acc + terms[i];
    const float zz = __shfl_sync(WIDE_FULL_MASK, acc, 0);
    const float tol_acc = __shfl_sync(WIDE_FULL_MASK, acc, 1);
    const float sigma = sqrtf(zz) / ((p[O] * c.lq_norm[O]) * c.sqrt_d);
    const float sigma_safe = isfinite(sigma) ? sigma : c.big;
    const float new_scale = minp(maxp(sigma_safe, in.tiny_scale), c.big);
    if (warp == 0 && !(frozen || tiny)) cov_warp<NU>(L, c, p, new_scale, in.tiny_scale, cur, w);
    if (warp == control_warp && w == 0) {
      control_wide<NU>(L, c, in, d, p, t_new, dt, frozen, clamped, tiny, sigma, tol_acc,
                       new_scale);
      step_scalars<NU>(L, c, in);  // the next attempt's, while warp 0 works
    }
  }
  __syncthreads();

  // -- the column's update, on the controller's decisions
  if (!L.accept) return;
  if (L.tiny) {
    if (mine) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s.mean_hi[i] = m_pred[i].hi;
        s.mean_lo[i] = m_pred[i].lo;
      }
    }
    return;
  }
  if (mine) {
    const float* g_acc = L.g_acc[cur];
    float gd[N];  // gain @ diff, diff[j] = -(g_corr[j] z.hi)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = L.gain[i * N + 0] * -(L.g_corr[0] * z.hi);
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + L.gain[i * N + j] * -(L.g_corr[j] * z.hi);
      gd[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const F2 cor = sub(m_pred[i], mul1(z, L.g_corr[i]));
      s.mean_hi[i] = cor.hi;
      s.mean_lo[i] = cor.lo;
      float incr = g_acc[i * N + 0] * gd[0];
#pragma unroll
      for (int j = 1; j < N; ++j) incr = incr + g_acc[i * N + j] * gd[j];
      const F2 msp = add1(F2{s.msp_hi[i], s.msp_lo[i]}, incr);
      s.msp_hi[i] = msp.hi;
      s.msp_lo[i] = msp.lo;
    }
  }
  cur ^= 1;
}

// The block's lane b: its column, (n, n) arrays and scalars from the 12
// lanes-last input arrays into s and L, the constants A and Lq and the first
// attempt's step scalars into L, its inputs into every thread's registers.
// Ends with a barrier.
template <int N>
__device__ __forceinline__ LaneInputsHi load_lane_wide(LaneWide& L, ColumnHi<N>& s,
                                                       const ArgsHi& args, const ConstsWide& c,
                                                       int64_t b, int64_t B, int d) {
  const int q = static_cast<int>(threadIdx.x);
  const LaneInputsHi in{args.in[12][b], args.in[13][b], args.in[14][b],
                        args.in[15][b], args.in[16][b], args.in[17][b]};
  if (q < d) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int64_t at = (static_cast<int64_t>(i) * d + q) * B + b;
      s.mean_hi[i] = args.in[2][at];
      s.mean_lo[i] = args.in[3][at];
      s.msp_hi[i] = args.in[7][at];
      s.msp_lo[i] = args.in[8][at];
    }
  }
  for (int k = q; k < N * N; k += static_cast<int>(blockDim.x)) {
    L.chol[0][k] = args.in[4][k * B + b];
    L.g_acc[0][k] = args.in[6][k * B + b];
  }
  if (q == 0) {
#pragma unroll
    for (int k = 0; k < NN_WIDE; ++k) {  // unrolled: no run-time index into the parameters
      L.a[k] = c.a[k];
      L.lq[k] = c.lq[k];
    }
    L.t_hi = args.in[0][b];
    L.t_lo = args.in[1][b];
    L.scale = args.in[5][b];
    L.dt = args.in[9][b];
    L.errn_prev = args.in[10][b];
    L.nsteps = args.in[11][b];
    step_scalars<N - 1>(L, c, in);
  }
  __syncthreads();
  return in;
}

// The lane back to the 12 lanes-last output arrays (chol and G_acc from
// buffer cur).  Reads only what the last barrier published.
template <int N>
__device__ __forceinline__ void store_lane_wide(const LaneWide& L, const ColumnHi<N>& s,
                                                const ArgsHi& args, int64_t b, int64_t B, int d,
                                                int cur) {
  const int q = static_cast<int>(threadIdx.x);
  if (q < d) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int64_t at = (static_cast<int64_t>(i) * d + q) * B + b;
      args.out[2][at] = s.mean_hi[i];
      args.out[3][at] = s.mean_lo[i];
      args.out[7][at] = s.msp_hi[i];
      args.out[8][at] = s.msp_lo[i];
    }
  }
  for (int k = q; k < N * N; k += static_cast<int>(blockDim.x)) {
    args.out[4][k * B + b] = L.chol[cur][k];
    args.out[6][k * B + b] = L.g_acc[cur][k];
  }
  if (q == 0) {
    args.out[0][b] = L.t_hi;
    args.out[1][b] = L.t_lo;
    args.out[5][b] = L.scale;
    args.out[9][b] = L.dt;
    args.out[10][b] = L.errn_prev;
    args.out[11][b] = L.nsteps;
  }
}

// The launch bound of the instantiation that runs d components: blocks of
// at most WIDE_SMALL_THREADS threads take the small one.
inline int wide_bound(int d) {
  return wide_threads(d) <= WIDE_SMALL_THREADS ? WIDE_SMALL_THREADS : WIDE_MAX_THREADS;
}

// The geometry entries' report for a block of wide_threads(d) threads and
// wide_smem_bytes(d) bytes of dynamic shared memory on `kernel`, the
// instantiation of launch bound wide_bound(d): out = threads per lane (d),
// lanes per block (1), threads per block, shared-memory bytes per block,
// resident blocks per SM (occupancy API), registers per thread, local bytes
// per thread, the launch bound.
template <class Kernel>
int wide_report(Kernel kernel, int d, int* out) {
  if (d < 1 || d > WIDE_MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = wide_threads(d), smem = wide_smem_bytes(d);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = d;
  out[1] = 1;
  out[2] = threads;
  out[3] = static_cast<int>(attr.sharedSizeBytes) + smem;
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  out[7] = wide_bound(d);
  return static_cast<int>(err);
}

}  // namespace
