// Body of K8: the sqrt combine of one pair of parallel-in-time filtering
// elements, on one lane's private matrices.  It computes
// pit_fused.combine_sqrt_ll (odecheckpts_torch/pit_fused.py) operation by
// operation in that function's order, so kernel and twin round alike:
// products summed in column order, the two Gram factors and the two new
// factors by the column-list QR of lanes.cuh on (2M, M) stacks, the Gram
// solves and right solves by unrolled substitution.
//
// T is float or double, M the state dimension (nu + 1), C the number of mean
// columns (the ODE dimension on the isotropic backend).

#pragma once

#include "lanes.cuh"

namespace {

// One filtering element: x_k = A x_{k-1} + b + N(0, U U^T), with the
// information pair (eta, Z Z^T) about x_{k-1}.
template <class T, int M, int C>
struct Element {
  T a[M][M], b[M][C], u[M][M], eta[M][C], z[M][M];
};

// out = x y, summed in column order (the twin's _matmul_ll).
template <class T, int R, int K, int L>
__device__ __forceinline__ void mat(T (&out)[R][L], const T (&x)[R][K], const T (&y)[K][L]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int l = 0; l < L; ++l) {
      T acc = x[i][0] * y[0][l];
#pragma unroll
      for (int k = 1; k < K; ++k) acc = acc + x[i][k] * y[k][l];
      out[i][l] = acc;
    }
}

template <class T, int R, int K>
__device__ __forceinline__ void transpose(T (&out)[K][R], const T (&x)[R][K]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < K; ++k) out[k][i] = x[i][k];
}

// y = (r^T r)^-1 x for upper-triangular r: forward substitution with r^T,
// then backward with r (pit_fused._psolve_ll).
template <class T, int M, int K>
__device__ __forceinline__ void psolve(T (&y)[M][K], const T (&r)[M][M], const T (&x)[M][K]) {
  T w[M][K];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int l = 0; l < K; ++l) {
      T acc = x[i][l];
#pragma unroll
      for (int k = 0; k < i; ++k) acc = acc - r[k][i] * w[k][l];
      w[i][l] = acc / r[i][i];
    }
#pragma unroll
  for (int i = M - 1; i >= 0; --i)
#pragma unroll
    for (int l = 0; l < K; ++l) {
      T acc = w[i][l];
#pragma unroll
      for (int k = i + 1; k < M; ++k) acc = acc - r[i][k] * y[k][l];
      y[i][l] = acc / r[i][i];
    }
}

// y = x r^-1 for upper-triangular r: forward substitution over the columns
// of r (pit_fused._rsolve_upper_ll).
template <class T, int M>
__device__ __forceinline__ void rsolve_upper(T (&y)[M][M], const T (&x)[M][M], const T (&r)[M][M]) {
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = x[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc = acc - y[i][k] * r[k][j];
      y[i][j] = acc / r[j][j];
    }
}

// The column list of the (2M, M) stack whose column c is [top[c]; bottom[c]],
// reduced by the column-list QR: afterwards R[r][c] = cols[c][r], r < M
// (pit_fused._qr_stacked).
template <class T, int M>
__device__ __forceinline__ void qr_stacked(T (&cols)[M][2 * M], const T (&top)[M][M],
                                           const T (&bottom)[M][M]) {
#pragma unroll
  for (int c = 0; c < M; ++c)
#pragma unroll
    for (int r = 0; r < M; ++r) {
      cols[c][r] = top[c][r];
      cols[c][M + r] = bottom[c][r];
    }
  qr_r_cols<2 * M, M>(cols);
}

// r[i][k] = cols[k][i]: the upper-triangular factor out of a column list.
template <class T, int M>
__device__ __forceinline__ void factor_of(T (&r)[M][M], const T (&cols)[M][2 * M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) r[i][k] = cols[k][i];
}

// out = combine(ei, ej): ei the earlier elements, ej the later ones.
template <class T, int M, int C>
__device__ __forceinline__ void combine_sqrt(Element<T, M, C>& out, const Element<T, M, C>& ei,
                                             const Element<T, M, C>& ej) {
  T ui_t[M][M], zj_t[M][M], mm[M][M], mm_t[M][M], eye[M][M];
  transpose(ui_t, ei.u);
  transpose(zj_t, ej.z);
  mat(mm, ui_t, ej.z);
  transpose(mm_t, mm);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) eye[i][k] = i == k ? T(1) : T(0);

  // R1^T R1 = I + M M^T (QR of [M^T; I]); R2^T R2 = I + M^T M ([M; I])
  T cols[M][2 * M], r1[M][M], r2[M][M];
  qr_stacked(cols, mm, eye);
  factor_of(r1, cols);
  qr_stacked(cols, mm_t, eye);
  factor_of(r2, cols);

  // (I + C_i J_j)^-1 x = x - U_i (R1^T R1)^-1 M Z_j^T x
  T t_mm[M][M], s_mm[M][M], aju[M][M], p_mm[M][M];
  mat(t_mm, zj_t, ei.a);   // zta
  mat(s_mm, mm, t_mm);     // M zta
  psolve(t_mm, r1, s_mm);
  mat(aju, ej.a, ei.u);
  mat(s_mm, aju, t_mm);
  mat(p_mm, ej.a, ei.a);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) out.a[i][k] = p_mm[i][k] - s_mm[i][k];

  T x[M][C], t_mc[M][C], s_mc[M][C];
  mat(t_mc, ui_t, ej.eta);
  mat(s_mc, ei.u, t_mc);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int l = 0; l < C; ++l) x[i][l] = ei.b[i][l] + s_mc[i][l];
  mat(t_mc, zj_t, x);
  mat(s_mc, mm, t_mc);
  psolve(t_mc, r1, s_mc);
  mat(s_mc, ei.u, t_mc);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int l = 0; l < C; ++l) t_mc[i][l] = x[i][l] - s_mc[i][l];
  mat(s_mc, ej.a, t_mc);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int l = 0; l < C; ++l) out.b[i][l] = s_mc[i][l] + ej.b[i][l];

  // (I + C_i J_j)^-1 C_i = (U_i R1^-1)(U_i R1^-1)^T; U = R^T of [(A_j V)^T; U_j^T]
  rsolve_upper(t_mm, ei.u, r1);
  mat(s_mm, ej.a, t_mm);
  qr_stacked(cols, s_mm, ej.u);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) out.u[i][k] = cols[i][k];

  // dual side: (I + J_j C_i)^-1 y = y - Z_j (R2^T R2)^-1 M^T U_i^T y
  T y0[M][C], ai_t[M][M];
  mat(t_mc, zj_t, ei.b);
  mat(s_mc, ej.z, t_mc);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int l = 0; l < C; ++l) y0[i][l] = ej.eta[i][l] - s_mc[i][l];
  transpose(ai_t, ei.a);
  mat(t_mc, ui_t, y0);
  mat(s_mc, mm_t, t_mc);
  psolve(t_mc, r2, s_mc);
  mat(s_mc, ej.z, t_mc);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int l = 0; l < C; ++l) t_mc[i][l] = y0[i][l] - s_mc[i][l];
  mat(s_mc, ai_t, t_mc);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int l = 0; l < C; ++l) out.eta[i][l] = s_mc[i][l] + ei.eta[i][l];

  // (I + J_j C_i)^-1 J_j = (Z_j R2^-1)(Z_j R2^-1)^T; Z = R^T of [Y^T A_i; Z_i^T]
  rsolve_upper(t_mm, ej.z, r2);
  mat(s_mm, ai_t, t_mm);
  qr_stacked(cols, s_mm, ei.z);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < M; ++k) out.z[i][k] = cols[i][k];
}

}  // namespace
