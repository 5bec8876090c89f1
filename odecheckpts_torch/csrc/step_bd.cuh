// The f32 step of K6 (interval form step_bd.cu, attempt form
// step_bd_attempt.cu): one adaptive attempt of the BLOCKDIAG TS0 fixedpoint
// solver, one thread per (IVP lane, channel).
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
// Layout: the d channels of a lane run side by side, one thread each, and
// the channel index comes from the thread's position, so no array is
// indexed by a runtime value and nothing lives on a thread's stack (the
// first design ran one thread per lane over its channels in a runtime loop,
// which put the lane's 521 floats on the stack; PERF.md).  A block is a
// tile of 32 consecutive lanes in D warps, warp = channel, warp lane = IVP
// lane: every load and store of a warp is one 128-byte line.  A thread
// keeps the lane's scalars (t, t_prev, dt, errn_prev, nsteps; all threads
// of the lane keep them alike) and its channel's scale and mle in
// registers.  Its channel's mean, chol, bwdG, bwd_m and bwd_L (2n + 3n^2
// floats, the "slots") sit in shared memory, [element][thread] (no bank
// conflicts), with the lane's inputs beside them.  An accepted attempt first
// stores the values it is about to replace as the previous values (output
// arrays 8..12), to device memory: only the last accepted attempt's
// survive, and no second copy takes shared memory.  The registers go to an
// accepted attempt's working arrays, above all the (2n, 2n) column list of
// the revert QR, under a launch bound of four tiles an SM (168 registers a
// thread).
//
// The lane's channels meet once per attempt: through shared memory and one
// block barrier, each thread gives rows 0 and 1 of its predicted mean
// (m_pred[0], m_pred[1]) and reads those of all D channels.  Then EVERY
// thread of the lane evaluates the vector field on the same m_pred[0],
// forms all D residuals, sigmas and error terms and sums e2 in the order
// 0..D-1, exactly as the twin and the first design did, and keeps its own
// channel's z and sigma: errn, the PI factor, dt and accept come out
// bit-identical in all threads of a lane, so they always take the same
// branch.  No sum is split across threads, so the kernel stays bit for bit
// with the twin.
//
// Covariance work runs on accepted attempts only: a rejected attempt
// changes nothing but dt, which depends on the means alone.
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

// Launch geometry (kernels.bd_geometry mirrors it): a tile of BD_WARP lanes
// a block, D warps.  The launch bounds' resident tiles an SM: 12 warps at
// D = 3, which caps a thread at 168 registers (a scheduler holds 16,384, so
// three warps a scheduler leave 170).
constexpr int BD_WARP = 32;
constexpr int BD_MIN_BLOCKS = 4;
constexpr unsigned BD_FULL = 0xffffffffu;

__host__ __device__ constexpr int bd_threads_per_block(int d) { return BD_WARP * d; }

// The channel's slots, r = 0..4 for state arrays 1..5 (mean, chol, bwdG,
// bwd_m, bwd_L; their previous values are arrays 8..12): size and offset in
// floats.
template <int N>
__host__ __device__ constexpr int slot_size(int r) {
  return r == 0 || r == 3 ? N : N * N;
}
template <int N>
__host__ __device__ constexpr int slot_offset(int r) {
  return r == 0 ? 0 : slot_offset<N>(r - 1) + slot_size<N>(r - 1);
}
template <int N>
__host__ __device__ constexpr int bd_slot_floats() {
  return slot_offset<N>(5);
}

// What stays in registers across attempts: the lane's scalars, alike in
// all its threads, and the channel's scale and mle.
struct ChannelBD {
  float t, t_prev, dt, errn_prev, nsteps;
  float scale, mle;
};

// The lane's inputs besides the state (input arrays 17..22: t_next, atol,
// rtol, dt_max, dt_floor, tiny_scale), in shared memory after the slots:
// read where they are used, they hold no registers across an attempt.
constexpr int BD_INPUTS = 6;
struct InputsBD {
  const float* p;  // the thread's first input
  int stride;      // threads per block
  __device__ __forceinline__ float operator[](int k) const { return p[k * stride]; }
};

// Where a thread sits: the lane and channel it computes (a thread past the
// batch computes the last lane again) and whether it stores them.
struct PlaceBD {
  int64_t b;
  int ch;
  bool on;
};

__device__ __forceinline__ PlaceBD place_bd(int64_t B) {
  const int t = static_cast<int>(threadIdx.x);
  const int64_t b = static_cast<int64_t>(blockIdx.x) * BD_WARP + t % BD_WARP;
  return PlaceBD{b < B ? b : B - 1, t / BD_WARP, b < B};
}

// The exchange of an attempt: every thread gives its channel's m_pred[0]
// and m_pred[1] and receives those of all D channels of its lane.
template <int D>
struct ExchangeBD {
  float (*buf)[2][D][BD_WARP];  // [parity][row][channel][warp lane], shared
  int parity;
  __device__ __forceinline__ void operator()(int ch, float a0, float a1, float (&u0)[D],
                                             float (&u1)[D]) {
    const int l = static_cast<int>(threadIdx.x) % BD_WARP;
    buf[parity][0][ch][l] = a0;
    buf[parity][1][ch][l] = a1;
    // a block is one tile, and its D warps run the same attempts: each
    // reaches this barrier once per attempt.  Two parities: a warp writes
    // the next attempt's values only after every warp has passed this one's
    // barrier, so no value is overwritten before it is read.
    __syncthreads();
#pragma unroll
    for (int k = 0; k < D; ++k) {
      u0[k] = buf[parity][0][k][l];
      u1[k] = buf[parity][1][k][l];
    }
    parity ^= 1;
  }
};

// n floats from src (stride ss) to dst (stride ds) in a loop that stays
// rolled: unrolled, the compiler keeps every element's 64-bit address in
// registers across the interval's loop, and the step body spills (measured
// on the H100: PERF.md).
__device__ __forceinline__ void copy_strided(const float* src, int64_t ss, float* dst,
                                             int64_t ds, int n) {
#pragma unroll 1
  for (int e = 0; e < n; ++e) {
    *dst = *src;
    src += ss;
    dst += ds;
  }
}

// The thread's channel's slots in shared memory, read and written in place;
// `keep_previous` stores them, before an accepted attempt replaces them, as
// the output's previous values.  `moved`: an attempt was accepted, so the
// output's previous values are written.
template <int N>
struct SlotsBD {
  float* p;    // the thread's first element
  int stride;  // threads per block
  const Args& args;
  int64_t at, step;  // element e of the thread's channel at e * step + at
  bool on, moved;
  __device__ __forceinline__ float get(int r, int e) const {
    return p[(slot_offset<N>(r) + e) * stride];
  }
  __device__ __forceinline__ void set(int r, int e, float v) const {
    p[(slot_offset<N>(r) + e) * stride] = v;
  }
  __device__ __forceinline__ void keep_previous() {
    if (on) {
#pragma unroll
      for (int r = 0; r < 5; ++r)
        copy_strided(p + slot_offset<N>(r) * stride, stride, args.out[8 + r] + at, step,
                     slot_size<N>(r));
    }
    moved = true;
  }
};

// The covariance part of an accepted attempt for the thread's channel: the
// channel's new mean column, factor and backward conditional replace its
// slots' values (every element of a slot is read before it is written), its
// scale and mle go to s.
template <int NU>
__device__ __forceinline__ void accept_channel(ChannelBD& s, const SlotsBD<NU + 1>& sl,
                                               const Consts& c, const float (&p)[NU + 1],
                                               const float (&m_pred)[NU + 1], float z,
                                               float sigma, const InputsBD& in) {
  constexpr int N = NU + 1;
  constexpr int M = 2 * N;
  float chol[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) chol[i][k] = sl.get(1, i * N + k);

  const float sigma_safe = isfinite(sigma) ? sigma : c.big;
  const float new_scale = minp(maxp(sigma_safe, in[5]), c.big);

  // -- extrapolate the covariance with reversal, preconditioned coordinates
  float l_bar[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) l_bar[i][k] = minp(maxp(chol[i][k] / p[i], -c.clip), c.clip);
  float mag = new_scale * c.max_lq;
#pragma unroll
  for (int i = 0; i < N; ++i) mag = maxp(mag, row_absmax(l_bar[i]));
  mag = maxp(mag * c.a_inf_norm, in[5]);
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
  float l_pred[N][N], gain[N][N], bwd_L_step[N][N], bwd_m_step[N], mean[N];
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
    mean[i] = sl.get(0, i);
    float acc = gain[i][0] * m_pred[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + gain[i][j] * m_pred[j];
    bwd_m_step[i] = mean[i] - acc;
  }

  // -- TS0 correction (rank-1 update on the observation row)
  float l_obs_n[N];
  const float m2 = maxp(row_absmax(l_pred[1]), in[5]);
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
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sl.set(0, i, m_pred[i] - g_corr[i] * z);
#pragma unroll
    for (int k = 0; k < N; ++k) sl.set(1, i * N + k, l_pred[i][k] - gc[i] * l_obs_n[k]);
  }

  // -- fixedpoint accumulation
  float bwdG[N][N], bwd_m[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    bwd_m[i] = sl.get(3, i);
#pragma unroll
    for (int k = 0; k < N; ++k) bwdG[i][k] = sl.get(2, i * N + k);
  }
  float m1[N][N], bl_g[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = bwdG[i][0] * gain[0][k];
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + bwdG[i][j] * gain[j][k];
      sl.set(2, i * N + k, acc);
    }
    float acc = bwdG[i][0] * bwd_m_step[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + bwdG[i][j] * bwd_m_step[j];
    sl.set(3, i, acc + bwd_m[i]);
  }
  float mag_g = in[5];
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
      bl_g[i][k] = sl.get(4, i * N + k) * inv_g;
    }
  float t3 = in[5];
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

  // -- the channel's new bwd_L
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) sl.set(4, i * N + k, (cols2[i][k] * t3) * mag_g);
  s.scale = new_scale;
  s.mle = s.mle + sigma * sigma;
}

// One accept/reject attempt (make_step_bd_ll's `step`) for channel ch of
// the thread's lane, updating s and the slots in place (an accepted attempt
// first keeps the values it replaces as the previous values).  A lane that is not `live` changes nothing (the
// attempt form passes "not frozen", the interval form's loop t < t_next,
// false on NaN too), but its threads still take part in the exchange.
template <int NU, class VF>
__device__ __forceinline__ void attempt_bd(ChannelBD& s, SlotsBD<NU + 1>& sl, int ch,
                                           const Consts& c, const VF& vf, const InputsBD& in,
                                           bool live, ExchangeBD<VF::D>& exchange) {
  constexpr int N = NU + 1;
  constexpr int D = VF::D;

  const float dt = minp(maxp(s.dt, in[4]), in[3]);
  float pows[N];
  pows[NU] = 1.0f;
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) pows[i] = pows[i + 1] * dt;
  const float sq = sqrtf(dt);
  float p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = sq * pows[i] * c.inv_fact[i];
  const float t_new = s.t + dt;

  // -- extrapolate the mean column: m_pred = P A P^-1 m
  float m_bar[N], m_pred[N];
#pragma unroll
  for (int i = 0; i < N; ++i) m_bar[i] = sl.get(0, i) / p[i];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = -0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (c.a[i * NMAX + j] != 0.0f) acc = acc + c.a[i * NMAX + j] * m_bar[j];
    m_pred[i] = p[i] * acc;
  }

  // -- TS0 residual, per-dimension sigma, one error norm per lane: every
  // thread of the lane forms all D terms from the exchanged rows
  float u0[D], u1[D], fx[D];
  exchange(ch, m_pred[0], m_pred[1], u0, u1);
  vf(u0, t_new, fx);
  const float s_unit = p[1] * c.lq_norm[1];
  const float u_unit = p[0] * c.lq_norm[0];
  float e2 = 0.0f, z = 0.0f, sigma = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float zk = u1[k] - fx[k];
    const float sk = fabsf(zk) / s_unit;
    const float q = (sk * u_unit) / (in[1] + in[2] * fabsf(u0[k]));
    e2 = k == 0 ? q * q : e2 + q * q;
    if (k == ch) {
      z = zk;
      sigma = sk;
    }
  }
  const float errn = c.kappa * sqrtf(e2 / static_cast<float>(D));

  // -- PI control and accept (the means alone decide them)
  const float errn_s = maxp(errn, FLT_MIN);
  float factor = c.safety * expf(c.neg_n1 * logf(errn_s) +
                                 c.n2 * (logf(s.errn_prev) - logf(errn_s)));
  if (!isfinite(factor)) factor = c.factor_min;
  const float dt_next = minp(dt * minp(maxp(factor, c.factor_min), c.factor_max), in[3]);
  const float dt_stall = (4.0f * FLT_EPSILON) * maxp(fabsf(s.t), 1.0f);
  const bool accept = ((errn <= 1.0f) || (dt <= dt_stall)) && live;

  if (live) s.dt = dt_next;
  if (!accept) return;
  sl.keep_previous();
  accept_channel<NU>(s, sl, c, p, m_pred, z, sigma, in);
  s.t_prev = s.t;
  s.t = t_new;
  s.errn_prev = errn_s;
  s.nsteps = s.nsteps + 1.0f;
}

// The thread's lane and channel through one attempt or an interval's loop:
// the state in, the attempts, the state out.  INTERVAL: loop while
// k < max_attempts and a lane of the warp has t < t_next (the lanes of a
// tile's D warps are the same, so all its warps agree); else one attempt on
// every lane, lanes at the checkpoint frozen inside the step.
template <int NU, class VF, bool INTERVAL>
__device__ __forceinline__ void run_bd(const Args& args, const Consts& c, const VF& vf,
                                       int64_t B, int max_attempts) {
  constexpr int N = NU + 1, D = VF::D, T = bd_threads_per_block(D);
  constexpr int SLOTS = bd_slot_floats<N>();
  // a thread: SLOTS floats, then BD_INPUTS; [element][thread]
  extern __shared__ float bd_slots[];
  __shared__ float buf[2][2][D][BD_WARP];
  const PlaceBD pl = place_bd(B);
  const int64_t b = pl.b, at = pl.ch * B + b, step = D * B;
  float* mine = bd_slots + threadIdx.x;
#pragma unroll
  for (int r = 0; r < 5; ++r)
    copy_strided(args.in[1 + r] + at, step, mine + slot_offset<N>(r) * T, T, slot_size<N>(r));
#pragma unroll
  for (int k = 0; k < BD_INPUTS; ++k) mine[(SLOTS + k) * T] = args.in[17 + k][b];
  SlotsBD<N> sl{mine, T, args, at, step, pl.on, false};
  const InputsBD in{mine + SLOTS * T, T};
  ChannelBD s{args.in[0][b], args.in[7][b], args.in[13][b], args.in[14][b], args.in[15][b],
              args.in[6][at], args.in[16][at]};
  ExchangeBD<D> exchange{buf, 0};
  if constexpr (INTERVAL) {
    for (int k = 0; k < max_attempts && __any_sync(BD_FULL, s.t < in[0]); ++k)
      attempt_bd<NU>(s, sl, pl.ch, c, vf, in, s.t < in[0], exchange);
  } else {
    attempt_bd<NU>(s, sl, pl.ch, c, vf, in, !(s.t >= in[0]), exchange);
  }
  if (!pl.on) return;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    copy_strided(mine + slot_offset<N>(r) * T, T, args.out[1 + r] + at, step, slot_size<N>(r));
    if (!sl.moved)
      copy_strided(args.in[8 + r] + at, step, args.out[8 + r] + at, step, slot_size<N>(r));
  }
  args.out[6][at] = s.scale;
  args.out[16][at] = s.mle;
  if (pl.ch == 0) {
    args.out[0][b] = s.t;
    args.out[7][b] = s.t_prev;
    args.out[13][b] = s.dt;
    args.out[14][b] = s.errn_prev;
    args.out[15][b] = s.nsteps;
  }
}

// Dynamic shared-memory bytes of a launch: a thread's slots and inputs.
template <int NU, int D>
constexpr int bd_smem_bytes() {
  return static_cast<int>(sizeof(float)) * (bd_slot_floats<NU + 1>() + BD_INPUTS) *
         bd_threads_per_block(D);
}

// One launch of `kernel` with `smem` bytes of dynamic shared memory, one
// tile of BD_WARP lanes a block.
template <class Kernel, class... A>
cudaError_t launch_bd(Kernel kernel, int d, int smem, long long batch, cudaStream_t st,
                      A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((batch + BD_WARP - 1) / BD_WARP));
  const dim3 block(bd_threads_per_block(d));
  kernel<<<grid, block, smem, st>>>(args...);
  return cudaGetLastError();
}

// The geometry entries' report of `kernel` with `smem` bytes of dynamic
// shared memory (see odeckpt_step_bd_interval_geometry): out = threads per
// lane, lanes per block, threads per block, shared-memory bytes per block
// (static and dynamic), resident blocks per SM, registers per thread, local
// bytes per thread.
template <class VF, class Kernel>
int bd_report(Kernel kernel, int smem, int* out) {
  const int threads = bd_threads_per_block(VF::D);
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = VF::D;
  out[1] = BD_WARP;
  out[2] = threads;
  out[3] = static_cast<int>(attr.sharedSizeBytes) + smem;
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

}  // namespace
