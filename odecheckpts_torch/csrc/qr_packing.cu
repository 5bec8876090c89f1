// K10 and K11: the layout microbenchmark of the in-kernel Householder QR.
// Replaces experiments/6_tpu_batched_sweep/qr_packing_bench.py:_bench_kernel,
// variant "cols" (K10) and the masked variant (K11); the plain versions are
// odecheckpts_torch/kernels.py:qr_packing_cols_plain / qr_packing_masked_plain.
//
// Each thread holds one lane's (m, n) matrix and runs `iters` QRs in a runtime
// loop, adding 1e-6 k before the k-th (so nothing is hoisted), and stores the
// last.  K10 is the column-list QR of lanes.cuh: reflection j touches columns
// j..n-1.  K11 applies every reflection to all n columns and multiplies the
// coefficient by the `active` mask (c >= j): the wasted work is what is
// measured (built with -fmad=false and without fast math, a product with 0.0 is
// not elided).  On the TPU the question was vector throughput against the
// number of instructions; here a lane's matrix lives in a thread's
// registers, so it is asked where registers are the scarce thing.
//
// What bounds them: 2 m n floats a lane against iters * ~(4/3) n^3 operations:
// operations, by a wide margin at iters = 200.

#include "lanes.cuh"

namespace {

template <int M, int N>
__global__ void __launch_bounds__(THREADS) qr_packing_cols(const float* x_in, float* x_out,
                                                          int iters, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;
  float x[M][N], cols[N][M];
  load(x, x_in, b, B);
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int r = 0; r < M; ++r) cols[c][r] = x[r][c];
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    const float p = 1e-6f * static_cast<float>(k);
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int r = 0; r < M; ++r) cols[c][r] = cols[c][r] + p;
    qr_r_cols<M, N>(cols);
  }
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int r = 0; r < M; ++r) x[r][c] = cols[c][r];
  store(x, x_out, b, B);
}

template <int M, int N>
__global__ void __launch_bounds__(THREADS) qr_packing_masked(const float* x_in, float* x_out,
                                                            int iters, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;
  constexpr int J = N < M - 1 ? N : M - 1;
  float x[M][N];
  load(x, x_in, b, B);
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    const float p = 1e-6f * static_cast<float>(k);
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c) x[r][c] = x[r][c] + p;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float colm[M];
#pragma unroll
      for (int r = 0; r < M; ++r) colm[r] = x[r][j] * (r >= j ? 1.0f : 0.0f);
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
#pragma unroll
      for (int c = 0; c < N; ++c) {
        float coeff = v[0] * x[0][c];
#pragma unroll
        for (int r = 1; r < M; ++r) coeff = coeff + v[r] * x[r][c];
        const float masked = coeff * (c >= j ? 1.0f : 0.0f);
#pragma unroll
        for (int r = 0; r < M; ++r) x[r][c] = x[r][c] - inv * v[r] * masked;
      }
    }
  }
  store(x, x_out, b, B);
}

}  // namespace

#define ODECKPT_PACKING_ENTRY(NAME)                                                              \
  extern "C" int odeckpt_##NAME(int m, int n, int iters, const void* x_ptr, void* out_ptr,       \
                                long long batch, int device, void* stream) {                     \
    cudaError_t err = cudaSetDevice(device);                                                     \
    if (err != cudaSuccess) return static_cast<int>(err);                                        \
    const dim3 grid = lanes_grid(batch), block(THREADS);                                         \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                         \
    const float* x = static_cast<const float*>(x_ptr);                                           \
    float* out = static_cast<float*>(out_ptr);                                                   \
    const int64_t B = batch;                                                                     \
    if (m == 10 && n == 10) NAME<10, 10><<<grid, block, 0, st>>>(x, out, iters, B);              \
    else if (m == 8 && n == 8) NAME<8, 8><<<grid, block, 0, st>>>(x, out, iters, B);             \
    else if (m == 6 && n == 6) NAME<6, 6><<<grid, block, 0, st>>>(x, out, iters, B);             \
    else return static_cast<int>(cudaErrorInvalidValue);                                         \
    return static_cast<int>(cudaGetLastError());                                                 \
  }

// C interface, two entry points: odeckpt_qr_packing_cols (K10) and
// odeckpt_qr_packing_masked (K11).  x and out: (m, n, batch) float32,
// lanes-last, contiguous.  Built for (m, n) in {(10, 10), (8, 8), (6, 6)}.
// Each returns the cudaError_t of the launch.
ODECKPT_PACKING_ENTRY(qr_packing_cols)
ODECKPT_PACKING_ENTRY(qr_packing_masked)
