// The f32 step of K5 (step_dense.cu, step_dense_attempt.cu): one adaptive
// attempt of the dense-covariance TS1 / TS0 fixedpoint solver, one warp per
// IVP lane, the lane's state and working arrays in shared memory.  The plain
// PyTorch twin is odecheckpts_torch/batched_dense.py:StepDense; the
// reference is odecheckpts_tpu/batched_dense.py:make_step_dense_ll
// (114-484).
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
// What bounds it, and the design.  A lane's state is 17 arrays, 2,487 floats
// at nd = 20, and an accepted attempt works on a (40, 40) column list: far
// beyond a thread's registers.  Held per thread (the first design), all of
// it lived in local memory and streamed through L2 and device memory at
// every pass of a QR.  Here the 32 threads of a warp share one lane, whose
// arrays sit in shared memory (DenseLayout, 18,272 bytes at nd = 20), and a block
// holds a tile of consecutive lanes, which it loads and stores cooperatively
// (each element of the tile's lanes is one run of consecutive words).  The
// work is split only across independent outputs, so every sum keeps the
// twin's order and the kernel stays bit for bit with it:
//   * QR: every thread computes reflection j's vector from column j
//     (broadcast reads, identical arithmetic), then each thread updates whole
//     columns c >= j, its dot product in row order;
//   * triangular solves: one thread per right-hand side;
//   * products and elementwise passes: one thread per output element;
//   * maxima (exact in any order): per-thread partials and warp shuffles;
//   * the per-lane scalar work (extrapolation, vf, jac, sigma, error, PI
//     control, accept / reject): every thread of the warp, redundantly, so
//     every branch is warp-uniform and needs no broadcast.
// The warp synchronizes only with itself (__syncwarp): lanes of one block
// take different numbers of attempts.  What bounds it now is the warp's
// instruction throughput and shared-memory traffic per reflection (the 2nd-term
// norm and each column's 2nd-term dot product stay serial) and the 12 lanes
// an SM's shared memory holds (step_dense.cu).  A rejected
// or frozen attempt needs only its error estimate, so the covariance work
// runs only on accepted attempts; the outputs are those of the reference's
// compute-then-select.  An accepted attempt writes the new arrays into the
// lane's second copy and flips which copy is current, instead of copying the
// current state into the previous one.

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

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
// Launch geometry (kernels.dense_geometry mirrors it): a block is a tile of
// a form's default number of lanes (step_dense.cu, step_dense_attempt.cu),
// one warp each, or fewer if SMEM_PER_BLOCK does not hold them after the
// constants.  A launch takes at most DENSE_LANES_MAX (the launch bounds).
constexpr int DENSE_LANES_MAX = 12;
constexpr int SMEM_PER_BLOCK = 232448;
constexpr int CONST_FLOATS = 64;  // Consts::a and Consts::lq, per block

// The stride of a QR column list of M rows: whole float4s, an odd number of
// them, so that a column is read and written 16 bytes at a time and the
// eight threads of a quarter warp, one column each, hit distinct banks.
__host__ __device__ constexpr int col_stride(int m) {
  return (m + 3) / 4 % 2 == 1 ? (m + 3) / 4 * 4 : (m + 3) / 4 * 4 + 4;
}
__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Where a lane's arrays sit in its slice of shared memory (floats).  The QR
// column lists (one region: revert and fixedpoint with 2nd rows of stride
// LDR, sigma and correction with nd rows of stride LDC, and the correction's
// gain; the revert's gain replaces R_yx in its right half and outlives the
// correction and fixedpoint lists, which use the left half), the QR's
// Householder vector, its squares and inv * vector, two copies of the five
// arrays that an accepted attempt replaces (the current and the previous
// state), and the lane's small vectors and scalars.  (nd, nd) matrices have rows of odd stride LDS, so that threads
// walking one row each hit distinct banks.
template <int ND, int D>
struct DenseLayout {
  static constexpr int M = 2 * ND, MP = round4(M);
  static constexpr int LDS = ND | 1, LDR = col_stride(M), LDC = col_stride(ND);
  static constexpr int MAT = ND * LDS;
  static constexpr int MEAN = 0, CHOL = ND, BWDG = ND + MAT, BWDM = ND + 2 * MAT,
                       BWDL = 2 * ND + 2 * MAT, BUF = 2 * ND + 3 * MAT;
  static constexpr int WORK = 0, VEC = WORK + M * LDR, STATE = VEC + 3 * MP,
                       GAIN = WORK + ND * LDR, MPRED = STATE + 2 * BUF, BMSTEP = MPRED + ND,
                       Z = BMSTEP + ND, ZN = Z + D, ZC = ZN + D, JAC = ZC + D, P = JAC + D * D,
                       PINV = P + NMAX, SCAL = PINV + NMAX;
  static constexpr int FLOATS = round4(SCAL + 8);
  static constexpr int LDGC = D | 1;                   // rows of the correction gain
  static constexpr int GAINC = WORK + (D + ND) * LDC;  // after the correction list
  static_assert((D + ND) * LDC + ND * LDGC <= ND * LDR, "correction list and gain fit");
  static_assert(ND <= WARP, "one thread per row of the gains");
};

template <int ND, int D>
constexpr int dense_lanes_fit(int lanes) {
  constexpr int fit = (SMEM_PER_BLOCK - CONST_FLOATS * 4) / (DenseLayout<ND, D>::FLOATS * 4);
  return fit < lanes ? fit : lanes;
}

template <int ND, int D>
constexpr int dense_smem_bytes(int lanes) {
  return (CONST_FLOATS + lanes * DenseLayout<ND, D>::FLOATS) * 4;
}

// The lane's scalars, held by every thread of its warp.
struct DenseScalars {
  float t, scale, t_prev, dt, errn_prev, nsteps, mle;
  int cur;  // which copy holds the current state
};

// The largest of the warp's values, NaN-propagating (maxima are exact in any
// order; a NaN anywhere gives a NaN everywhere).
__device__ __forceinline__ float warp_maxp(float m) {
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) m = maxp(m, __shfl_xor_sync(FULL, m, off));
  return m;
}

template <int M>
__device__ __forceinline__ float col_absmax(const float* x) {
  float m = fabsf(x[0]);
#pragma unroll
  for (int k = 1; k < M; ++k) m = maxp(m, fabsf(x[k]));
  return m;
}

// M floats at p (16-byte aligned) to registers and back, 16 bytes at a time.
template <int M>
__device__ __forceinline__ void load_vec(float (&x)[M], const float* p) {
#pragma unroll
  for (int q = 0; q < M / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(p)[q];
    x[4 * q] = t.x;
    x[4 * q + 1] = t.y;
    x[4 * q + 2] = t.z;
    x[4 * q + 3] = t.w;
  }
#pragma unroll
  for (int r = M / 4 * 4; r < M; ++r) x[r] = p[r];
}

template <int M>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[M]) {
#pragma unroll
  for (int q = 0; q < M / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
#pragma unroll
  for (int r = M / 4 * 4; r < M; ++r) p[r] = x[r];
}

// lanes.cuh's column-list Householder QR on the warp: column c of M rows at
// cols[c * ld] (ld from col_stride); `vec` holds 3 round4(M) floats of
// scratch.  Reflection j: thread `lane` forms rows lane, lane + 32, ... of
// the masked column j and their squares; every thread sums the squares in
// row order (the twin's norm); the owners form the Householder vector v and
// inv * v; then thread `lane` updates columns j + lane, j + lane + 32, ...,
// its dot product in row order.
template <int M, int NC, int NR = NC>
__device__ __forceinline__ void qr_cols_warp(float* cols, int ld, float* vec, int lane) {
  constexpr int J = NR < M - 1 ? NR : M - 1;
  constexpr int Q = (M + WARP - 1) / WARP;  // rows a thread forms
  float* sq = vec + round4(M);
  float* ivec = sq + round4(M);
#pragma unroll 1
  for (int j = 0; j < J; ++j) {
    const float* cj = cols + j * ld;
    float colm[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = lane + q * WARP;
      if (r < M) {
        colm[q] = cj[r] * (r >= j ? 1.0f : 0.0f);
        sq[r] = colm[q] * colm[q];
      }
    }
    __syncwarp();
    float s2[M];
    load_vec<M>(s2, sq);
    float norm2 = s2[0];
#pragma unroll
    for (int r = 1; r < M; ++r) norm2 = norm2 + s2[r];
    const float norm = sqrtf(norm2 + FLT_MIN);
    // The twin's head is the row-order sum of colm[r] * [r == j]: colm[j]
    // plus signed zeros, or a NaN where colm holds a non-finite entry (and
    // then norm2, alpha, vnorm2 and the vector are NaN or inv is 0 either
    // way).  A zero's sign moves neither `sign` nor vnorm2 (norm2 + alpha^2
    // >= FLT_MIN), so colm[j] gives every bit of what follows.
    const float head = cj[j];
    const float sign = head >= 0.0f ? 1.0f : -1.0f;
    const float alpha = -sign * norm;
    const float vnorm2 = norm2 + alpha * alpha - 2.0f * head * alpha;
    const float inv = vnorm2 > FLT_MIN ? 2.0f / vnorm2 : 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = lane + q * WARP;
      if (r < M) {
        const float vr = colm[q] - (r == j ? 1.0f : 0.0f) * alpha;
        vec[r] = vr;
        ivec[r] = inv * vr;  // the twin's inv * v[r] * coeff is (inv * v[r]) * coeff
      }
    }
    __syncwarp();  // column j is read by all before its owner changes it
#pragma unroll 1
    for (int c = j + lane; c < NC; c += WARP) {
      float* cc = cols + c * ld;
      float x[M], v[M];
      load_vec<M>(x, cc);
      load_vec<M>(v, vec);
      float coeff = v[0] * x[0];
#pragma unroll
      for (int r = 1; r < M; ++r) coeff = coeff + v[r] * x[r];
      load_vec<M>(v, ivec);
#pragma unroll
      for (int r = 0; r < M; ++r) x[r] = x[r] - v[r] * coeff;
      store_vec<M>(cc, x);
    }
    __syncwarp();
  }
}

// X = R_yy^-1 R_yx from a reverted column list (column c at cols[c * ld]),
// stored transposed: xt[k * ldx + i] = X[i][k] (batched.py:
// _tri_solve_upper_ll).  One thread per right-hand side k, which reads only
// its own row of xt; that row may be its right-hand side, column N + k
// (step i reads row i of it before it writes X[i][k] there).  A diagonal
// below eps^2 zeroes its row of X.
template <int N, int K>
__device__ __forceinline__ void tri_solve_warp(const float* cols, int ld, float* xt, int ldx,
                                               int lane) {
  const float eps2 = FLT_EPSILON * FLT_EPSILON;
  for (int k = lane; k < K; k += WARP) {
    float* x = xt + k * ldx;
    const float* rhs = cols + (N + k) * ld;
#pragma unroll 1
    for (int i = N - 1; i >= 0; --i) {
      const float dd = cols[i * ld + i];
      const bool ok = fabsf(dd) > eps2;
      float acc = rhs[i];
      for (int j = i + 1; j < N; ++j) acc = acc - cols[j * ld + i] * x[j];
      x[i] = ok ? acc / dd : 0.0f;
    }
  }
  __syncwarp();
}

// One accept/reject attempt (make_step_dense_ll's `step`) of the lane whose
// arrays are at sm, run by all 32 threads of its warp; ca and clq are the
// block's copies of c.a and c.lq.
template <int NU, bool TS1, class VF>
__device__ __forceinline__ void attempt_warp(float* sm, const float* ca, const float* clq,
                                             DenseScalars& s, const Consts& c, const VF& vf,
                                             const LaneInputs& in, int lane) {
  constexpr int N = NU + 1;
  constexpr int D = VF::D;
  constexpr int ND = N * D;
  constexpr int M = 2 * ND;
  using Lay = DenseLayout<ND, D>;
  constexpr int LDS = Lay::LDS, LDR = Lay::LDR;
  const float tiny_scale = in.tiny_scale;
  const float* old = sm + Lay::STATE + s.cur * Lay::BUF;  // the state before the attempt
  float* m_pred = sm + Lay::MPRED;
  float* z_s = sm + Lay::Z;
  float* jac_s = sm + Lay::JAC;
  float* p_s = sm + Lay::P;
  float* pinv_s = sm + Lay::PINV;
  float* work = sm + Lay::WORK;
  float* vec = sm + Lay::VEC;
  __syncwarp();  // the previous attempt's reads are done

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
  float mp[ND];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float acc = -0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (c.a[i * NMAX + j] != 0.0f) acc = acc + c.a[i * NMAX + j] * (old[j * D + k] * p_inv[j]);
      mp[i * D + k] = acc * p[i];
    }

  // -- linearize at the predicted mean
  float fx[D], z[D], J[D][D];
  vf(mp, t_new, fx);
#pragma unroll
  for (int k = 0; k < D; ++k) z[k] = mp[D + k] - fx[k];
  if (TS1) vf.jac(mp, t_new, J);
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < ND; ++e) m_pred[e] = mp[e];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      z_s[r] = z[r];
#pragma unroll
      for (int k = 0; k < D; ++k) jac_s[r * D + k] = TS1 ? J[r][k] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      p_s[i] = p[i];
      pinv_s[i] = p_inv[i];
    }
  }
  __syncwarp();

  // -- sigma and the error: rows of H Q_unit^{1/2}, jointly row-normalized
  // with z, as the column list of a (nd, d) QR (column r by thread r)
  float* rs = work;
  if (lane < D) {
    const int r = lane;
    float* col = rs + r * Lay::LDC;
#pragma unroll
    for (int kk = 0; kk < N; ++kk) {
      const float base = p[1] * c.lq[NMAX + kk];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        bool has = j == r;
        float acc = has ? base : 0.0f;
        if (TS1 && c.lq[kk] != 0.0f) {
          const float term = (p[0] * c.lq[kk]) * jac_s[r * D + j];
          acc = has ? acc - term : -term;
          has = true;
        }
        col[kk * D + j] = has ? acc : 0.0f;
      }
    }
    const float mag_r = maxp(col_absmax<ND>(col), tiny_scale);
#pragma unroll
    for (int q = 0; q < ND; ++q) col[q] = col[q] / mag_r;
    sm[Lay::ZN + r] = z_s[r] / mag_r;
  }
  __syncwarp();
  qr_cols_warp<ND, D>(rs, Lay::LDC, vec, lane);  // R_s[i][j] = rs[j * LDC + i]
  float white[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {  // R_s^T w = z_n
    float acc = sm[Lay::ZN + i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc = acc - rs[i * Lay::LDC + j] * white[j];
    float diag = rs[i * Lay::LDC + i];
    diag = fabsf(diag) > FLT_MIN ? diag : FLT_MIN;
    white[i] = acc / diag;
  }
  float ww = white[0] * white[0];
#pragma unroll
  for (int i = 1; i < D; ++i) ww = ww + white[i] * white[i];
  const float sigma = sqrtf(ww) / c.sqrt_d;
  const float err_u = sigma * (p[0] * c.lq_norm[0]);
  float qe = err_u / (in.atol + in.rtol * fabsf(mp[0]));
  float e2 = qe * qe;
#pragma unroll
  for (int r = 1; r < D; ++r) {
    qe = err_u / (in.atol + in.rtol * fabsf(mp[r]));
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

  // accepted: the current copy becomes the previous one; everything below
  // reads `old` and writes the other copy, `nw`
  float* nw = sm + Lay::STATE + (1 - s.cur) * Lay::BUF;
  s.cur = 1 - s.cur;
  s.t_prev = s.t;
  s.t = t_new;
  s.scale = new_scale;
  s.errn_prev = errn_s;
  s.nsteps = s.nsteps + 1.0f;
  s.mle = s.mle + sigma * sigma;

  // -- extrapolate the covariance (preconditioned, jointly normalized).
  // Revert-QR column c < nd is [row c of (A kron I) l_bar_n; row c of
  // kron(Lq, I) lq_s], column nd + c is [row c of l_bar_n; 0]
  float* rev = work;
  float mag = new_scale * c.max_lq;
  for (int e = lane; e < ND * ND; e += WARP) {
    const int i = e / ND, k = e % ND;
    const float lb = minp(maxp(old[Lay::CHOL + i * LDS + k] * pinv_s[i / D], -c.clip), c.clip);
    rev[(ND + i) * LDR + k] = lb;
    mag = maxp(mag, fabsf(lb));
  }
  mag = maxp(warp_maxp(mag) * c.a_inf_norm, tiny_scale);
  const float inv_mag = 1.0f / mag;
  const float lq_s = new_scale * inv_mag;
  for (int e = lane; e < ND * ND; e += WARP) {  // the same elements as above
    const int i = e / ND, k = e % ND;
    rev[(ND + i) * LDR + k] = rev[(ND + i) * LDR + k] * inv_mag;
    rev[(ND + i) * LDR + ND + k] = 0.0f;
  }
  __syncwarp();
  for (int e = lane; e < ND * ND; e += WARP) {
    const int r = e / ND, k = e % ND, i = r / D, a = r % D;
    float acc = -0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float aij = ca[i * NMAX + j];
      if (aij != 0.0f) acc = acc + aij * rev[(ND + j * D + a) * LDR + k];
    }
    rev[r * LDR + k] = acc;
    const int kk = k / D, jj = k % D;
    const float l = clq[i * NMAX + kk];
    rev[r * LDR + ND + k] = (jj == a && l != 0.0f) ? l * lq_s : 0.0f;
  }
  __syncwarp();
  qr_cols_warp<M, M>(rev, LDR, vec, lane);
  // gain[r][k] = X[k][r] for X = R_yy^-1 R_yx (in place of R_yx: row r of
  // the gain is column nd + r of the list), then the preconditioner; l_pred
  // and bwd_L_step go into the new copy's chol and bwd_L, which nothing
  // reads before they are replaced
  float* gain = sm + Lay::GAIN;
  float* l_pred = nw + Lay::CHOL;
  float* bwd_L_step = nw + Lay::BWDL;
  tri_solve_warp<ND, ND>(rev, LDR, gain, LDR, lane);
  for (int e = lane; e < ND * ND; e += WARP) {
    const int r = e / ND, k = e % ND;
    const float pr = p_s[r / D];
    l_pred[r * LDS + k] = (rev[r * LDR + k] * mag) * pr;
    gain[r * LDR + k] = (gain[r * LDR + k] * pr) * pinv_s[k / D];
    bwd_L_step[r * LDS + k] = (rev[(ND + r) * LDR + ND + k] * mag) * pr;
  }
  __syncwarp();
  float* bwd_m_step = sm + Lay::BMSTEP;
  if (lane < ND) {
    const float* g = gain + lane * LDR;
    float acc = g[0] * m_pred[0];
#pragma unroll
    for (int j = 1; j < ND; ++j) acc = acc + g[j] * m_pred[j];
    bwd_m_step[lane] = old[Lay::MEAN + lane] - acc;
  }

  // -- TS0 / TS1 correction: one QR revert on (nd, d + nd); column r < d is
  // row r of H L (H = E_1 - J E_0), column d + c is row c of L
  float* cor = work;
  float lmag = tiny_scale;
  for (int e = lane; e < ND * ND; e += WARP)
    lmag = maxp(lmag, fabsf(l_pred[(e / ND) * LDS + e % ND]));
  lmag = warp_maxp(lmag);
  const float inv_l = 1.0f / lmag;
  if (lane < D) {
    const int r = lane;
    float* col = cor + r * Lay::LDC;
#pragma unroll 4
    for (int q = 0; q < ND; ++q) {
      float acc = l_pred[(D + r) * LDS + q];
      if (TS1) {
#pragma unroll
        for (int cc = 0; cc < D; ++cc) acc = acc - jac_s[r * D + cc] * l_pred[cc * LDS + q];
      }
      col[q] = acc;
    }
    const float hl_mag = maxp(col_absmax<ND>(col), tiny_scale);
#pragma unroll 4
    for (int q = 0; q < ND; ++q) col[q] = (col[q] / hl_mag) * inv_l;
    sm[Lay::ZC + r] = z_s[r] / hl_mag;
  }
  for (int e = lane; e < ND * ND; e += WARP) {
    const int i = e / ND, k = e % ND;
    cor[(D + i) * Lay::LDC + k] = l_pred[i * LDS + k] * inv_l;
  }
  __syncwarp();
  qr_cols_warp<ND, D + ND>(cor, Lay::LDC, vec, lane);
  float* gain_c = sm + Lay::GAINC;  // gain_c[i][r] = X[r][i], X = R_yy^-1 R_yx
  tri_solve_warp<D, ND>(cor, Lay::LDC, gain_c, Lay::LDGC, lane);
  if (lane < ND) {
    const float* g = gain_c + lane * Lay::LDGC;
    float delta = g[0] * sm[Lay::ZC];
#pragma unroll
    for (int r = 1; r < D; ++r) delta = delta + g[r] * sm[Lay::ZC + r];
    nw[Lay::MEAN + lane] = m_pred[lane] - delta;
  }
  for (int e = lane; e < ND * ND; e += WARP) {
    const int i = e / ND, k = e % ND;
    nw[Lay::CHOL + i * LDS + k] = k < ND - D ? cor[(D + i) * Lay::LDC + D + k] * lmag : 0.0f;
  }

  // -- fixedpoint accumulation
  const float* bwdG_prev = old + Lay::BWDG;
  float mag_g = tiny_scale;
  for (int e = lane; e < ND * ND; e += WARP) {
    const int i = e / ND, k = e % ND;
    const float* gi = bwdG_prev + i * LDS;
    float acc = gi[0] * gain[k];
#pragma unroll 4
    for (int j = 1; j < ND; ++j) acc = acc + gi[j] * gain[j * LDR + k];
    nw[Lay::BWDG + i * LDS + k] = acc;
    mag_g = maxp(mag_g, fabsf(gi[k]));
  }
  if (lane < ND) {
    const float* gi = bwdG_prev + lane * LDS;
    float acc = gi[0] * bwd_m_step[0];
#pragma unroll
    for (int j = 1; j < ND; ++j) acc = acc + gi[j] * bwd_m_step[j];
    nw[Lay::BWDM + lane] = acc + old[Lay::BWDM + lane];
  }
  mag_g = warp_maxp(mag_g);
  const float inv_g = 1.0f / mag_g;
  __syncwarp();  // the correction's lists are read; the region takes fp
  // fixedpoint QR column c is [row c of m1; row c of bl_g] / t3
  float* fp = work;
  float t3 = tiny_scale;
  for (int e = lane; e < ND * ND; e += WARP) {
    const int i = e / ND, k = e % ND;
    const float* gi = bwdG_prev + i * LDS;
    float acc = (gi[0] * inv_g) * bwd_L_step[k];
#pragma unroll 4
    for (int j = 1; j < ND; ++j) acc = acc + (gi[j] * inv_g) * bwd_L_step[j * LDS + k];
    const float bl = old[Lay::BWDL + i * LDS + k] * inv_g;
    fp[i * LDR + k] = acc;
    fp[i * LDR + ND + k] = bl;
    t3 = maxp(t3, maxp(fabsf(acc), fabsf(bl)));
  }
  t3 = warp_maxp(t3);
  const float inv3 = 1.0f / t3;
  for (int e = lane; e < ND * ND; e += WARP) {  // the same elements as above
    const int i = e / ND, k = e % ND;
    fp[i * LDR + k] = fp[i * LDR + k] * inv3;
    fp[i * LDR + ND + k] = fp[i * LDR + ND + k] * inv3;
  }
  __syncwarp();
  qr_cols_warp<M, ND>(fp, LDR, vec, lane);
  for (int e = lane; e < ND * ND; e += WARP) {
    const int i = e / ND, k = e % ND;
    nw[Lay::BWDL + i * LDS + k] = (fp[i * LDR + k] * t3) * mag_g;
  }
}

// Element e of lane b of a lanes-last array sits at x[e * B + b].  A tile of
// T consecutive lanes is loaded and stored by the whole block: thread
// (e0, l) = (threadIdx.x / T, threadIdx.x % T) moves elements e0, e0 + 32,
// ... of lane l, so consecutive threads touch consecutive words.
template <int R, int C, int LD>
__device__ __forceinline__ void tile_load(float* dst, const float* src, int64_t B, int64_t b,
                                          int e0) {
  for (int e = e0; e < R * C; e += WARP) dst[(e / C) * LD + e % C] = src[e * B + b];
}

template <int R, int C, int LD>
__device__ __forceinline__ void tile_store(const float* src, float* dst, int64_t B, int64_t b,
                                           int e0) {
  for (int e = e0; e < R * C; e += WARP) dst[e * B + b] = src[(e / C) * LD + e % C];
}

// The 17 state arrays of the block's tile into shared memory (copy 0 the
// current state, copy 1 the previous one), and the constants the warps
// index at run time.  `nl` lanes of the tile exist (the ragged edge).
template <int ND, int D>
__device__ __forceinline__ void load_tile_dense(float* smem, const Args& args, const Consts& c,
                                                int64_t B, int64_t b0, int nl) {
  using Lay = DenseLayout<ND, D>;
  constexpr int LDS = Lay::LDS;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NMAX * NMAX; ++i) {
      smem[i] = c.a[i];
      smem[NMAX * NMAX + i] = c.lq[i];
    }
  }
  const int T = blockDim.x / WARP, l = threadIdx.x % T, e0 = threadIdx.x / T;
  if (l >= nl) return;
  float* sm = smem + CONST_FLOATS + l * Lay::FLOATS;
  const int64_t b = b0 + l;
  for (int cp = 0; cp < 2; ++cp) {
    float* buf = sm + Lay::STATE + cp * Lay::BUF;
    const int a0 = cp == 0 ? 1 : 8;
    tile_load<1, ND, ND>(buf + Lay::MEAN, args.in[a0], B, b, e0);
    tile_load<ND, ND, LDS>(buf + Lay::CHOL, args.in[a0 + 1], B, b, e0);
    tile_load<ND, ND, LDS>(buf + Lay::BWDG, args.in[a0 + 2], B, b, e0);
    tile_load<1, ND, ND>(buf + Lay::BWDM, args.in[a0 + 3], B, b, e0);
    tile_load<ND, ND, LDS>(buf + Lay::BWDL, args.in[a0 + 4], B, b, e0);
  }
  if (e0 == 0) {
    float* scal = sm + Lay::SCAL;
    scal[0] = args.in[0][b];
    scal[1] = args.in[6][b];
    scal[2] = args.in[7][b];
    scal[3] = args.in[13][b];
    scal[4] = args.in[14][b];
    scal[5] = args.in[15][b];
    scal[6] = args.in[16][b];
    scal[7] = 0.0f;
  }
}

template <int ND, int D>
__device__ __forceinline__ void store_tile_dense(const float* smem, const Args& args, int64_t B,
                                                 int64_t b0, int nl) {
  using Lay = DenseLayout<ND, D>;
  constexpr int LDS = Lay::LDS;
  const int T = blockDim.x / WARP, l = threadIdx.x % T, e0 = threadIdx.x / T;
  if (l >= nl) return;
  const float* sm = smem + CONST_FLOATS + l * Lay::FLOATS;
  const float* scal = sm + Lay::SCAL;
  const int cur = scal[7] != 0.0f;
  const int64_t b = b0 + l;
  for (int cp = 0; cp < 2; ++cp) {
    const float* buf = sm + Lay::STATE + (cp == 0 ? cur : 1 - cur) * Lay::BUF;
    const int a0 = cp == 0 ? 1 : 8;
    tile_store<1, ND, ND>(buf + Lay::MEAN, args.out[a0], B, b, e0);
    tile_store<ND, ND, LDS>(buf + Lay::CHOL, args.out[a0 + 1], B, b, e0);
    tile_store<ND, ND, LDS>(buf + Lay::BWDG, args.out[a0 + 2], B, b, e0);
    tile_store<1, ND, ND>(buf + Lay::BWDM, args.out[a0 + 3], B, b, e0);
    tile_store<ND, ND, LDS>(buf + Lay::BWDL, args.out[a0 + 4], B, b, e0);
  }
  if (e0 == 0) {
    args.out[0][b] = scal[0];
    args.out[6][b] = scal[1];
    args.out[7][b] = scal[2];
    args.out[13][b] = scal[3];
    args.out[14][b] = scal[4];
    args.out[15][b] = scal[5];
    args.out[16][b] = scal[6];
  }
}

// The whole dense kernel, both forms: load the tile, run each lane's
// attempts on its warp (at most max_attempts, while t < t_next), store the
// tile.  Barriers of the whole block come only before and after the loop.
template <int NU, bool TS1, class VF>
__device__ __forceinline__ void run_tile_dense(const Args& args, const Consts& c, const VF& vf,
                                               int64_t B, int max_attempts) {
  constexpr int D = VF::D;
  constexpr int ND = (NU + 1) * D;
  using Lay = DenseLayout<ND, D>;
  extern __shared__ float dense_smem[];
  const int T = blockDim.x / WARP;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * T;
  const int nl = B - b0 < T ? static_cast<int>(B - b0) : T;
  load_tile_dense<ND, D>(dense_smem, args, c, B, b0, nl);
  __syncthreads();
  const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  if (w < nl) {
    float* sm = dense_smem + CONST_FLOATS + w * Lay::FLOATS;
    float* scal = sm + Lay::SCAL;
    DenseScalars s{scal[0], scal[1], scal[2], scal[3], scal[4], scal[5], scal[6], 0};
    const int64_t b = b0 + w;
    const LaneInputs in{args.in[17][b], args.in[18][b], args.in[19][b],
                        args.in[20][b], args.in[21][b], args.in[22][b]};
    for (int k = 0; k < max_attempts && s.t < in.t_next; ++k)
      attempt_warp<NU, TS1, VF>(sm, dense_smem, dense_smem + NMAX * NMAX, s, c, vf, in, lane);
    __syncwarp();
    if (lane == 0) {
      scal[0] = s.t;
      scal[1] = s.scale;
      scal[2] = s.t_prev;
      scal[3] = s.dt;
      scal[4] = s.errn_prev;
      scal[5] = s.nsteps;
      scal[6] = s.mle;
      scal[7] = static_cast<float>(s.cur);
    }
  }
  __syncthreads();
  store_tile_dense<ND, D>(dense_smem, args, B, b0, nl);
}

// The launch geometry of one form: lanes per block (the form's default, or
// the override a caller set for measurement), threads, dynamic shared
// memory, and resident blocks per SM.
struct DenseGeometry {
  int lanes, threads, smem, blocks_per_sm;
};

template <int ND, int D>
DenseGeometry dense_geometry(int lanes_override, int lanes_default) {
  const int lanes = lanes_override > 0 ? lanes_override : dense_lanes_fit<ND, D>(lanes_default);
  return DenseGeometry{lanes, lanes * WARP, dense_smem_bytes<ND, D>(lanes), 0};
}

// Set the kernel's shared-memory limit to the geometry's and launch it on
// ceil(batch / lanes) blocks.
template <class Kernel, class... A>
cudaError_t launch_dense(Kernel kernel, const DenseGeometry& g, long long batch, cudaStream_t st,
                         A... args) {
  if (g.lanes < 1 || g.lanes > DENSE_LANES_MAX || g.smem > SMEM_PER_BLOCK)
    return cudaErrorInvalidConfiguration;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((batch + g.lanes - 1) / g.lanes)), block(g.threads);
  kernel<<<grid, block, g.smem, st>>>(args...);
  return cudaGetLastError();
}

// Resident blocks per SM of `kernel` at geometry g (the occupancy API).
template <class Kernel>
cudaError_t dense_occupancy(Kernel kernel, DenseGeometry& g) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g.blocks_per_sm, kernel, g.threads,
                                                       g.smem);
}

}  // namespace
