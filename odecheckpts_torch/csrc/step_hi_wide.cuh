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
// (chol, G_acc twice, the gain), its scalars and the two decisions live in
// shared memory (LaneWide); so do three rows of d floats: the hi words of
// m_pred[0] (what the vector field reads of its neighbours) and each
// thread's two terms of the error sums.
//
// One attempt, three __syncthreads:
//   1. every thread forms the lane's step scalars (remainder, dt, the
//      preconditioner, t_new, the extrapolation coefficients) from the
//      shared scalars, redundantly and identically; each extrapolates its
//      column in pairs and writes its m_pred[0] hi word.  Barrier.
//   2. each evaluates f_q from that row (VF: a row functor, functors.cuh),
//      forms z_q = m_pred[1]_q - f_q in pairs and writes z_q.hi^2 and
//      1 / (atol + rtol |m_pred[0]_q|)^2.  Barrier.
//   3. thread 0 alone: the two sums over d in the twin's order (i = 0, 1,
//      ..., d - 1; a tree would change the bits), the error, the PI
//      controller and the accept / snap / tiny decisions; on a full accept
//      the (n, n) work of attempt_hi (the first n reflections of the revert
//      QR, the gain, the rank-1 update of chol, G_acc G) into shared memory,
//      G_acc's new value into the other of its two buffers.  Barrier.
//   4. every thread reads the decisions (so every branch is uniform across
//      the block) and updates its column: mean_cor = m_pred - g_corr z_q,
//      msp += G_acc_old (gain (-g_corr z_q.hi)).
// A rejected or frozen attempt skips the covariance work: the outputs are
// those of the twin's compute-then-select.
//
// What bounds it: the serial chain of one attempt, not bytes or operations.
// Thread 0's (n, n) work and two ordered sums of d terms run while the other
// threads wait at a barrier, and a launch holds one lane a block: 256 lanes
// are two blocks an SM.  The arithmetic is attempt_hi's, operation by
// operation (the same df32 operations, the same QR and triangular solve):
// build with -fmad=false and without --use_fast_math.  Making it fast (a
// warp-split QR, fewer barriers) is later work.

#pragma once

#include "functors.cuh"
#include "step_hi.cuh"

namespace {

// At most this many threads a block: d <= 1,024 (kernels.HI_WIDE_MAX_D).
constexpr int WIDE_MAX_THREADS = 1024;
constexpr int WIDE_WARP = 32;

// The lane's part of the block's shared memory (dynamic, at its start).
struct LaneWide {
  float t_hi, t_lo, scale, dt, errn_prev, nsteps;
  int accept, tiny;  // thread 0's decisions of the attempt
  float chol[NMAX_HI * NMAX_HI];
  float g_acc[2][NMAX_HI * NMAX_HI];  // the current and the next G_acc
  float gain[NMAX_HI * NMAX_HI];
  float g_corr[NMAX_HI];
};
constexpr int WIDE_LANE_FLOATS = 158;  // kernels.HI_WIDE_LANE_FLOATS
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

// Thread 0's part of one attempt: the error sums, the controller and the
// decisions, and on a full accept the (n, n) covariance work of attempt_hi
// (TS0, fixedpoint) into L.  g_acc is the current G_acc, g_next its new
// value.  The decisions go to L.accept and L.tiny.
template <int NU>
__device__ __forceinline__ void lane_work_wide(LaneWide& L, const float* zsq, const float* qinv,
                                               const ConstsHi& c, const LaneInputsHi& in, int d,
                                               const float (&p)[NU + 1], F2 t_new, float dt,
                                               bool frozen, bool clamped, bool tiny,
                                               const float* g_acc, float* g_next) {
  constexpr int N = NU + 1;
  constexpr int O = 1;
  constexpr int M = 2 * N;
  const float tiny_scale = in.tiny_scale;

  // -- local scale and error (f32: they only steer the controller), the
  // sums in the twin's order
  const float s_unit = p[O] * c.lq_norm[O];
  float zz = zsq[0];
  float tol_acc = qinv[0];
  for (int i = 1; i < d; ++i) {
    zz = zz + zsq[i];
    tol_acc = tol_acc + qinv[i];
  }
  const float sigma = sqrtf(zz) / (s_unit * c.sqrt_d);
  const float err_u = c.residual != 0.0f ? sigma * s_unit : sigma * (p[0] * c.lq_norm[0]);
  const float errn = c.kappa * err_u * sqrtf(tol_acc / static_cast<float>(d));
  const float sigma_safe = isfinite(sigma) ? sigma : c.big;
  const float new_scale = minp(maxp(sigma_safe, tiny_scale), c.big);

  // -- PI control and the decisions
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

  // -- extrapolate the covariance (f32) with reversal, preconditioned
  float l_bar[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k)
      l_bar[i][k] = minp(maxp(L.chol[i * N + k] / p[i], -c.clip), c.clip);
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

  float l_pred[N][N], x[N][N];  // X = R_yy^-1 R_yx
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) l_pred[i][k] = (p[i] * cols[i][k]) * mag;
  tri_solve_upper<N, M>(cols, x);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) L.gain[i * N + k] = p[i] * x[k][i] / p[k];

  // -- correction (rank-1 update on the observation row l_pred[O])
  float l_obs_n[N];
  const float m2 = maxp(row_absmax(l_pred[O]), tiny_scale);
#pragma unroll
  for (int k = 0; k < N; ++k) l_obs_n[k] = l_pred[O][k] / m2;
  float s2 = l_obs_n[0] * l_obs_n[0];
#pragma unroll
  for (int k = 1; k < N; ++k) s2 = s2 + l_obs_n[k] * l_obs_n[k];
  s2 = s2 + FLT_MIN;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = l_pred[i][0] * l_obs_n[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + l_pred[i][j] * l_obs_n[j];
    const float gc = acc / s2;
    L.g_corr[i] = gc / m2;
#pragma unroll
    for (int k = 0; k < N; ++k) L.chol[i * N + k] = l_pred[i][k] - gc * l_obs_n[k];
  }

  // -- fixedpoint accumulation: G_acc gain, into the other buffer
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = g_acc[i * N + 0] * L.gain[0 * N + k];
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + g_acc[i * N + j] * L.gain[j * N + k];
      g_next[i * N + k] = acc;
    }
  L.scale = new_scale;
  L.nsteps = L.nsteps + 1.0f;
}

// One accept/reject attempt of the lane (make_step_hi's `step`) by the
// whole block: thread q < d holds column q in s; `cur` (the same in every
// thread) names the current G_acc buffer.  `sh` holds the three rows of d
// floats.  Every thread of the block calls it: it holds three barriers.
template <int NU, class VF>
__device__ __forceinline__ void attempt_wide(LaneWide& L, float* sh, ColumnHi<NU + 1>& s,
                                             const ConstsHi& c, const VF& vf,
                                             const LaneInputsHi& in, int d, int& cur) {
  constexpr int N = NU + 1;
  constexpr int O = VF::O;
  static_assert(O == 1, "the wide df32 step runs vector fields of order 1");
  const int q = static_cast<int>(threadIdx.x);
  const bool mine = q < d;
  float* row = sh;
  float* zsq = sh + d;
  float* qinv = sh + 2 * d;

  // remainder to the checkpoint on the compensated time axis, every thread
  const float t_hi = L.t_hi, t_lo = L.t_lo;
  const F2 se = two_sum(in.t_next, -t_hi);
  const float rem = maxp(se.hi + (se.lo - t_lo), 0.0f);
  const bool frozen = rem <= 0.0f;
  const float dt_prop = minp(maxp(L.dt, in.dt_floor), in.dt_max);
  const bool clamped = rem <= dt_prop;
  const float dt_mean = minp(dt_prop, rem);
  const bool tiny = clamped && (rem <= c.tiny_frac * in.dt_max);
  const float dt = maxp(dt_mean, in.dt_floor);

  float pows[N];
  pows[NU] = 1.0f;
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) pows[i] = pows[i + 1] * dt;
  const float sq = sqrtf(dt);
  float p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = sq * pows[i] * c.inv_fact[i];
  const F2 t_new = add1(F2{t_hi, t_lo}, dt_mean);

  // -- extrapolate the column in pairs, real coordinates: m_i + sum_k c_k m_{i+k}
  F2 ck[N];  // ck[k] = dt_mean^k / k!; ck[0] unused
  ck[1] = F2{dt_mean, 0.0f};
#pragma unroll
  for (int k = 2; k < N; ++k) ck[k] = div1(mul1(ck[k - 1], dt_mean), static_cast<float>(k));
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

  if (q == 0)
    lane_work_wide<NU>(L, zsq, qinv, c, in, d, p, t_new, dt, frozen, clamped, tiny,
                       L.g_acc[cur], L.g_acc[cur ^ 1]);
  __syncthreads();

  // -- the column's update, on the decisions of thread 0
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
// lanes-last input arrays into s and L, its inputs into every thread's
// registers.  Ends with a barrier.
template <int N>
__device__ __forceinline__ LaneInputsHi load_lane_wide(LaneWide& L, ColumnHi<N>& s,
                                                       const ArgsHi& args, int64_t b, int64_t B,
                                                       int d) {
  const int q = static_cast<int>(threadIdx.x);
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
    L.chol[k] = args.in[4][k * B + b];
    L.g_acc[0][k] = args.in[6][k * B + b];
  }
  if (q == 0) {
    L.t_hi = args.in[0][b];
    L.t_lo = args.in[1][b];
    L.scale = args.in[5][b];
    L.dt = args.in[9][b];
    L.errn_prev = args.in[10][b];
    L.nsteps = args.in[11][b];
  }
  __syncthreads();
  return LaneInputsHi{args.in[12][b], args.in[13][b], args.in[14][b],
                      args.in[15][b], args.in[16][b], args.in[17][b]};
}

// The lane back to the 12 lanes-last output arrays (G_acc from buffer cur).
// Reads only what the last barrier published.
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
    args.out[4][k * B + b] = L.chol[k];
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

// The geometry entries' report for a block of wide_threads(d) threads and
// wide_smem_bytes(d) bytes of dynamic shared memory: out = threads per lane
// (d), lanes per block (1), threads per block, shared-memory bytes per
// block, resident blocks per SM (occupancy API), registers per thread,
// local bytes per thread.
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
  return static_cast<int>(err);
}

}  // namespace
