// Body of K8: the sqrt combine of one pair of parallel-in-time filtering
// elements, worked by a team of K8_TEAM threads on the pair's matrices in
// shared memory.  It computes pit_fused.combine_sqrt_ll
// (odecheckpts_torch/pit_fused.py) operation by operation in that function's
// order, so kernel and twin round alike: products summed in column order,
// the two Gram factors and the two new factors by the column-list QR of
// lanes.cuh on (2M, M) stacks, the Gram solves and right solves by unrolled
// substitution.
//
// The team splits the work only across independent outputs, so every sum
// keeps the twin's order:
//   * after the operands are in shared memory, the R1 chain (the QR of
//     [M^T; I], then out.a, out.b, out.u) and the R2 chain (the QR of
//     [M; I], then out.eta, out.z) share nothing, and go to the two halves
//     of the team.  Each half forms its own product of U_i and Z_j (the R2
//     half as Z_j^T U_i, which is M^T element for element: the products
//     commute and the sums run over the same k in the same order).  A
//     block's first warp holds the R1 halves of its K8_PAIRS pairs, the
//     second warp their R2 halves, so that the two chains run side by side
//     and no warp's lanes diverge between them;
//   * inside a half, member r of K8_HALF takes the columns c = r (mod
//     K8_HALF) of each product, of each QR's column list (the pivot column's
//     norm, head and Householder vector are formed by every member from the
//     same values) and of each Gram solve's right-hand side, and the rows
//     r (mod K8_HALF) of each right solve.  A chain of products on the left
//     of a column stays with that column's member, in registers; shared
//     memory holds what other members read, and __syncwarp orders it.
//
// T is float or double, M the state dimension (nu + 1), C the number of mean
// columns (the ODE dimension on the isotropic backend).

#pragma once

#include "lanes.cuh"

namespace {

constexpr int K8_HALF = 4;                     // members of a half team
constexpr int K8_TEAM = 2 * K8_HALF;           // threads a pair
constexpr int K8_THREADS = 64;                 // a block: the R1 warp, the R2 warp
constexpr int K8_PAIRS = K8_THREADS / K8_TEAM;  // pairs a block

// A pair's slice of the block's shared memory.  Element [0] is the earlier
// element (i), [1] the later (j): x_k = A x_{k-1} + b + N(0, U U^T), with
// the information pair (eta, Z Z^T) about x_{k-1}.  half[h] is the scratch
// of chain h: `left` the half's product of U_i and Z_j (M for R1, M^T for
// R2), `cols` the (2M, M) column list of the QR at hand, `fin` the final
// first M rows of each column of the Gram factor's QR (the factor R1 or R2:
// R[i][k] = fin[k][i]), `t` the right solve's result.
template <class T, int M, int C>
struct PairShared {
  T a[2][M][M], b[2][M][C], u[2][M][M], eta[2][M][C], z[2][M][M];
  struct Half {
    T left[M][M], cols[M][2 * M], fin[M][M], t[M][M];
  } half[2];
  T aju[M][M];  // A_j U_i (R1)
};

// Scalars between two pairs' slices: K8_HALF more than a multiple of 32, so
// that element k + member of a warp's pairs falls in 32 different banks.
template <class T, int M, int C>
__host__ __device__ constexpr int pair_stride() {
  constexpr int n = static_cast<int>(sizeof(PairShared<T, M, C>) / sizeof(T));
  return n + (K8_HALF - n % 32 + 32) % 32;
}

// x^T y[., l] and friends: out[i] = sum_k X(i, k) v[k], summed in k order
// (the twin's _matmul_ll on one column).
template <class T, int M, class X>
__device__ __forceinline__ void mat_col(T (&out)[M], const X& x, const T (&v)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = x(i, 0) * v[0];
#pragma unroll
    for (int k = 1; k < M; ++k) acc = acc + x(i, k) * v[k];
    out[i] = acc;
  }
}

// Column l of an (M, K) matrix in shared memory.
template <class T, int M, int K>
__device__ __forceinline__ void col_of(T (&v)[M], const T (&x)[M][K], int l) {
#pragma unroll
  for (int k = 0; k < M; ++k) v[k] = x[k][l];
}

// One right-hand-side column of psolve: y = (R^T R)^-1 x for the
// upper-triangular R(i, k) (pit_fused._psolve_ll).
template <class T, int M, class R>
__device__ __forceinline__ void psolve_col(T (&y)[M], const R& r, const T (&x)[M]) {
  T w[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - r(k, i) * w[k];
    w[i] = acc / r(i, i);
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    T acc = w[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) acc = acc - r(i, k) * y[k];
    y[i] = acc / r(i, i);
  }
}

// One row of rsolve_upper: y = x R^-1 for the upper-triangular R(i, k)
// (pit_fused._rsolve_upper_ll), row i of x in, row i of y out.
template <class T, int M, class R>
__device__ __forceinline__ void rsolve_row(T (&y)[M], const T (&x)[M], const R& r) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    T acc = x[j];
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - y[k] * r(k, j);
    y[j] = acc / r(j, j);
  }
}

// The column-list QR of lanes.cuh (qr_r_cols<2M, M>) on the half's
// cols[c][r], c < M columns of 2M rows, by the half's members: reflection j
// is formed by every member from column j as the last reflection left it,
// and member `member` applies it to its columns c >= j.  Column j is final
// after reflection j: its first M rows go to `sink(j, x)` instead of back
// to cols, so that no member writes the column that the others read.
template <class T, int M, class Sink>
__device__ __forceinline__ void qr_team(T (&cols)[M][2 * M], int member, const Sink& sink) {
  constexpr int R = 2 * M;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    T colm[R];
#pragma unroll
    for (int r = 0; r < R; ++r) colm[r] = cols[j][r] * (r >= j ? T(1) : T(0));
    T norm2 = colm[0] * colm[0];
#pragma unroll
    for (int r = 1; r < R; ++r) norm2 = norm2 + colm[r] * colm[r];
    const T norm = Num<T>::sqrt(norm2 + Num<T>::tiny);
    T head = colm[0] * (j == 0 ? T(1) : T(0));
#pragma unroll
    for (int r = 1; r < R; ++r) head = head + colm[r] * (r == j ? T(1) : T(0));
    const T sign = head >= T(0) ? T(1) : T(-1);
    const T alpha = -sign * norm;
    T v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = colm[r] - (r == j ? T(1) : T(0)) * alpha;
    const T vnorm2 = norm2 + alpha * alpha - T(2) * head * alpha;
    const T inv = vnorm2 > Num<T>::tiny ? T(2) / vnorm2 : T(0);
#pragma unroll 1
    for (int c0 = 0; c0 < M; c0 += K8_HALF) {
      const int c = c0 + member;
      if (c < j || c >= M) continue;
      T x[R];
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = cols[c][r];
      T coeff = v[0] * x[0];
#pragma unroll
      for (int r = 1; r < R; ++r) coeff = coeff + v[r] * x[r];
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = x[r] - inv * v[r] * coeff;
      if (c == j) {
        sink(j, x);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) cols[c][r] = x[r];
      }
    }
    __syncwarp();
  }
}

// The half's first stage: row c of its product P of U_i and Z_j for the
// member's c, into `left` and into column c of the stack [P; I], whose QR
// gives the Gram factor.  R1: P = M = U_i^T Z_j; R2: P = M^T = Z_j^T U_i.
template <class T, int M, int C>
__device__ __forceinline__ void gram_stack(typename PairShared<T, M, C>::Half& h,
                                           const T (&x)[M][M], const T (&y)[M][M], int member) {
#pragma unroll 1
  for (int c0 = 0; c0 < M; c0 += K8_HALF) {
    const int c = c0 + member;
    if (c >= M) continue;
#pragma unroll
    for (int l = 0; l < M; ++l) {
      T acc = x[0][c] * y[0][l];
#pragma unroll
      for (int k = 1; k < M; ++k) acc = acc + x[k][c] * y[k][l];
      h.left[c][l] = acc;
      h.cols[c][l] = acc;
    }
#pragma unroll
    for (int r = 0; r < M; ++r) h.cols[c][M + r] = c == r ? T(1) : T(0);
  }
}

// Column c of the stack [X^T-side product; bottom]: row c of `top(c, l)`
// over l, then row c of `bottom`, for the member's c.
template <class T, int M, class Top>
__device__ __forceinline__ void new_stack(T (&cols)[M][2 * M], const Top& top,
                                          const T (&bottom)[M][M], int member) {
#pragma unroll 1
  for (int c0 = 0; c0 < M; c0 += K8_HALF) {
    const int c = c0 + member;
    if (c >= M) continue;
#pragma unroll
    for (int l = 0; l < M; ++l) {
      cols[c][l] = top(c, l);
      cols[c][M + l] = bottom[c][l];
    }
  }
}

// Lanes-last output of one pair: element (i, k) of an (R, K, P) array.
template <class T, int K>
__device__ __forceinline__ void store_at(T* dst, int i, int k, T x, int64_t pair, int64_t P,
                                         bool live) {
  if (live) dst[(i * K + k) * P + pair] = x;
}

// The R1 chain: R1 from [M^T; I]; then
//   out.a = A_j A_i - (A_j U_i) (R1^T R1)^-1 M (Z_j^T A_i),
//   x = b_i + U_i (U_i^T eta_j),
//   out.b = A_j (x - U_i (R1^T R1)^-1 M (Z_j^T x)) + b_j,
//   out.u = R^T of [(A_j U_i R1^-1)^T; U_j^T].
template <class T, int M, int C>
__device__ __forceinline__ void chain_r1(PairShared<T, M, C>& s, int member, T* const* out,
                                         int64_t pair, int64_t P, bool live) {
  auto& h = s.half[0];
  const auto& ai = s.a[0];
  const auto& aj = s.a[1];
  const auto& ui = s.u[0];
  const auto& zj = s.z[1];
  gram_stack<T, M, C>(h, ui, zj, member);
#pragma unroll 1
  for (int c0 = 0; c0 < M; c0 += K8_HALF) {  // rows of A_j U_i
    const int c = c0 + member;
    if (c >= M) continue;
#pragma unroll
    for (int l = 0; l < M; ++l) {
      T acc = aj[c][0] * ui[0][l];
#pragma unroll
      for (int k = 1; k < M; ++k) acc = acc + aj[c][k] * ui[k][l];
      s.aju[c][l] = acc;
    }
  }
  __syncwarp();
  qr_team<T, M>(h.cols, member, [&](int j, const T (&x)[2 * M]) {
#pragma unroll
    for (int r = 0; r < M; ++r) h.fin[j][r] = x[r];
  });
  const auto r1 = [&](int i, int k) { return h.fin[k][i]; };
  const auto mm = [&](int i, int k) { return h.left[i][k]; };
  const auto zj_t = [&](int i, int k) { return zj[k][i]; };
  const auto ui_t = [&](int i, int k) { return ui[k][i]; };
  const auto aju = [&](int i, int k) { return s.aju[i][k]; };
  const auto a_j = [&](int i, int k) { return aj[i][k]; };
  const auto u_i = [&](int i, int k) { return ui[i][k]; };
#pragma unroll 1
  for (int l0 = 0; l0 < M; l0 += K8_HALF) {  // column l of out.a
    const int l = l0 + member;
    if (l >= M) continue;
    T v[M], t[M], w[M];
    col_of(v, ai, l);
    mat_col(t, zj_t, v);  // Z_j^T A_i
    mat_col(w, mm, t);    // M Z_j^T A_i
    psolve_col(t, r1, w);
    mat_col(w, aju, t);
    mat_col(t, a_j, v);  // A_j A_i
#pragma unroll
    for (int i = 0; i < M; ++i) store_at<T, M>(out[0], i, l, t[i] - w[i], pair, P, live);
  }
#pragma unroll 1
  for (int l0 = 0; l0 < C; l0 += K8_HALF) {  // column l of out.b
    const int l = l0 + member;
    if (l >= C) continue;
    T v[M], t[M], w[M], x[M];
    col_of(v, s.eta[1], l);
    mat_col(t, ui_t, v);
    mat_col(w, u_i, t);
#pragma unroll
    for (int i = 0; i < M; ++i) x[i] = s.b[0][i][l] + w[i];
    mat_col(t, zj_t, x);
    mat_col(w, mm, t);
    psolve_col(t, r1, w);
    mat_col(w, u_i, t);
#pragma unroll
    for (int i = 0; i < M; ++i) t[i] = x[i] - w[i];
    mat_col(w, a_j, t);
#pragma unroll
    for (int i = 0; i < M; ++i) store_at<T, C>(out[1], i, l, w[i] + s.b[1][i][l], pair, P, live);
  }
#pragma unroll 1
  for (int i0 = 0; i0 < M; i0 += K8_HALF) {  // row i of U_i R1^-1
    const int i = i0 + member;
    if (i >= M) continue;
    T x[M], y[M];
#pragma unroll
    for (int k = 0; k < M; ++k) x[k] = ui[i][k];
    rsolve_row(y, x, r1);
#pragma unroll
    for (int k = 0; k < M; ++k) h.t[i][k] = y[k];
  }
  __syncwarp();
  new_stack<T, M>(h.cols, [&](int c, int l) {  // row c of A_j (U_i R1^-1)
    T acc = aj[c][0] * h.t[0][l];
#pragma unroll
    for (int k = 1; k < M; ++k) acc = acc + aj[c][k] * h.t[k][l];
    return acc;
  }, s.u[1], member);
  __syncwarp();
  qr_team<T, M>(h.cols, member, [&](int j, const T (&x)[2 * M]) {
#pragma unroll
    for (int k = 0; k < M; ++k) store_at<T, M>(out[2], j, k, x[k], pair, P, live);
  });
}

// The R2 chain: R2 from [M; I]; then
//   y0 = eta_j - Z_j (Z_j^T b_i),
//   out.eta = A_i^T (y0 - Z_j (R2^T R2)^-1 M^T (U_i^T y0)) + eta_i,
//   out.z = R^T of [(A_i^T Z_j R2^-1)^T; Z_i^T].
template <class T, int M, int C>
__device__ __forceinline__ void chain_r2(PairShared<T, M, C>& s, int member, T* const* out,
                                         int64_t pair, int64_t P, bool live) {
  auto& h = s.half[1];
  const auto& ai = s.a[0];
  const auto& ui = s.u[0];
  const auto& zj = s.z[1];
  gram_stack<T, M, C>(h, zj, ui, member);
  __syncwarp();
  qr_team<T, M>(h.cols, member, [&](int j, const T (&x)[2 * M]) {
#pragma unroll
    for (int r = 0; r < M; ++r) h.fin[j][r] = x[r];
  });
  const auto r2 = [&](int i, int k) { return h.fin[k][i]; };
  const auto mm_t = [&](int i, int k) { return h.left[i][k]; };
  const auto zj_t = [&](int i, int k) { return zj[k][i]; };
  const auto ui_t = [&](int i, int k) { return ui[k][i]; };
  const auto z_j = [&](int i, int k) { return zj[i][k]; };
  const auto ai_t = [&](int i, int k) { return ai[k][i]; };
#pragma unroll 1
  for (int l0 = 0; l0 < C; l0 += K8_HALF) {  // column l of out.eta
    const int l = l0 + member;
    if (l >= C) continue;
    T v[M], t[M], w[M], y0[M];
    col_of(v, s.b[0], l);
    mat_col(t, zj_t, v);
    mat_col(w, z_j, t);
#pragma unroll
    for (int i = 0; i < M; ++i) y0[i] = s.eta[1][i][l] - w[i];
    mat_col(t, ui_t, y0);
    mat_col(w, mm_t, t);
    psolve_col(t, r2, w);
    mat_col(w, z_j, t);
#pragma unroll
    for (int i = 0; i < M; ++i) t[i] = y0[i] - w[i];
    mat_col(w, ai_t, t);
#pragma unroll
    for (int i = 0; i < M; ++i)
      store_at<T, C>(out[3], i, l, w[i] + s.eta[0][i][l], pair, P, live);
  }
#pragma unroll 1
  for (int i0 = 0; i0 < M; i0 += K8_HALF) {  // row i of Z_j R2^-1
    const int i = i0 + member;
    if (i >= M) continue;
    T x[M], y[M];
#pragma unroll
    for (int k = 0; k < M; ++k) x[k] = zj[i][k];
    rsolve_row(y, x, r2);
#pragma unroll
    for (int k = 0; k < M; ++k) h.t[i][k] = y[k];
  }
  __syncwarp();
  new_stack<T, M>(h.cols, [&](int c, int l) {  // row c of A_i^T (Z_j R2^-1)
    T acc = ai[0][c] * h.t[0][l];
#pragma unroll
    for (int k = 1; k < M; ++k) acc = acc + ai[k][c] * h.t[k][l];
    return acc;
  }, s.z[0], member);
  __syncwarp();
  qr_team<T, M>(h.cols, member, [&](int j, const T (&x)[2 * M]) {
#pragma unroll
    for (int k = 0; k < M; ++k) store_at<T, M>(out[4], j, k, x[k], pair, P, live);
  });
}

}  // namespace
