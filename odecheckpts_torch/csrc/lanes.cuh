// Helpers shared by the lanes-last kernels (K1-K8, K10): NaN-propagating
// min/max, lanes-last loads and stores, the column-list Householder QR of
// odecheckpts_tpu/batched.py:_qr_r_cols / batched_hi.py:_qr_r_cols_partial
// (unrolled) and the triangular solve of the reverted blocks.  K5's
// warp-cooperative forms of the QR and the solve are in step_dense.cuh.
//
// Everything here rounds each operation on its own: the sources are built
// with -fmad=false and without --use_fast_math (see kernels.py).  The loads,
// the stores and the unrolled QR take float or double (K8 runs in both); the
// scalar type is deduced from the arrays.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int THREADS = 128;

// The scalar type's smallest normal number and its square root.
template <class T>
struct Num;
template <>
struct Num<float> {
  static constexpr float tiny = FLT_MIN;
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
};
template <>
struct Num<double> {
  static constexpr double tiny = DBL_MIN;
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
};

// Maxima and minima propagate NaN as jnp.maximum / torch.maximum do.
__device__ __forceinline__ float maxp(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float minp(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

// Lanes-last layout: element (i, k) of lane b of an (R, C, B) array sits at
// x[(i * C + k) * B + b], so neighbouring threads touch neighbouring words.
template <class T, int R, int C>
__device__ __forceinline__ void load(T (&x)[R][C], const T* src, int64_t b, int64_t B) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < C; ++k) x[i][k] = src[(i * C + k) * B + b];
}

template <class T, int R, int C>
__device__ __forceinline__ void store(const T (&x)[R][C], T* dst, int64_t b, int64_t B) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < C; ++k) dst[(i * C + k) * B + b] = x[i][k];
}

template <int R, int C>
__device__ __forceinline__ void copy_to(float (&dst)[R][C], const float (&src)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < C; ++k) dst[i][k] = src[i][k];
}

// Householder QR on the column list cols[c][r] (NC columns of M rows): the
// reflections j < min(NR, M - 1), each applied to columns j..NC-1.  NR = NC
// is _qr_r_cols; NR < NC is _qr_r_cols_partial, whose first NR rows of every
// column are final.  No rescaling and no sign normalization.
template <int M, int NC, int NR = NC, class T = float>
__device__ __forceinline__ void qr_r_cols(T (&cols)[NC][M]) {
  constexpr int J = NR < M - 1 ? NR : M - 1;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    T colm[M];
#pragma unroll
    for (int r = 0; r < M; ++r) colm[r] = cols[j][r] * (r >= j ? T(1) : T(0));
    T norm2 = colm[0] * colm[0];
#pragma unroll
    for (int r = 1; r < M; ++r) norm2 = norm2 + colm[r] * colm[r];
    const T norm = Num<T>::sqrt(norm2 + Num<T>::tiny);
    T head = colm[0] * (j == 0 ? T(1) : T(0));
#pragma unroll
    for (int r = 1; r < M; ++r) head = head + colm[r] * (r == j ? T(1) : T(0));
    const T sign = head >= T(0) ? T(1) : T(-1);
    const T alpha = -sign * norm;
    T v[M];
#pragma unroll
    for (int r = 0; r < M; ++r) v[r] = colm[r] - (r == j ? T(1) : T(0)) * alpha;
    const T vnorm2 = norm2 + alpha * alpha - T(2) * head * alpha;
    const T inv = vnorm2 > Num<T>::tiny ? T(2) / vnorm2 : T(0);
#pragma unroll
    for (int c = j; c < NC; ++c) {
      T coeff = v[0] * cols[c][0];
#pragma unroll
      for (int r = 1; r < M; ++r) coeff = coeff + v[r] * cols[c][r];
#pragma unroll
      for (int r = 0; r < M; ++r) cols[c][r] = cols[c][r] - inv * v[r] * coeff;
    }
  }
}

// Largest |x[k]| over one row, NaN-propagating.
template <int C>
__device__ __forceinline__ float row_absmax(const float (&x)[C]) {
  float m = fabsf(x[0]);
#pragma unroll
  for (int k = 1; k < C; ++k) m = maxp(m, fabsf(x[k]));
  return m;
}

// Solve R_yy X = R_yx for the leading blocks of the revert-QR column list:
// R_yy[i][j] = cols[j][i], R_yx[i][k] = cols[N + k][i]
// (batched.py:_tri_solve_upper_ll).  A diagonal below eps^2 zeroes its row.
template <int N, int M>
__device__ __forceinline__ void tri_solve_upper(const float (&cols)[M][M], float (&x)[N][N]) {
  const float eps2 = FLT_EPSILON * FLT_EPSILON;
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    const float dd = cols[i][i];
    const bool ok = fabsf(dd) > eps2;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = cols[N + k][i];
#pragma unroll
      for (int j = i + 1; j < N; ++j) acc = acc - cols[j][i] * x[j][k];
      x[i][k] = ok ? acc / dd : 0.0f;
    }
  }
}

// The geometry entries' report of a kernel that runs a thread per lane in
// blocks of THREADS with `smem` bytes of dynamic shared memory (K1-K4, K7):
// out = threads per lane, lanes per block, threads per block, shared-memory
// bytes per block, resident blocks per SM (occupancy API), registers per
// thread, local bytes per thread.
template <class Kernel>
int lane_report(Kernel kernel, int* out, int smem = 0) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  out[0] = 1;
  out[1] = THREADS;
  out[2] = THREADS;
  out[3] = static_cast<int>(attr.sharedSizeBytes) + smem;
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

// Launch grid of one lane per thread.
inline dim3 lanes_grid(long long batch) {
  return dim3(static_cast<unsigned>((batch + THREADS - 1) / THREADS));
}

}  // namespace
