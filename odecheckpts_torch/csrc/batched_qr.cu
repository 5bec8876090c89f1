// K9: R factors of a batch of small matrices, one matrix per thread on the
// lanes-last (m, n, B) layout.  Replaces
// odecheckpts_tpu/pallas_kernels.py:batched_qr_r (body _qr_r_kernel); the plain
// version is odecheckpts_torch/kernels.py:batched_qr_r_plain.
//
// Masked full-matrix Householder as the TPU kernel runs it: the reflections
// j < min(n, m - 1), each a zero-masked full column applied to every column
// (eliminated ones included), sqrt(norm2 + tiny), no power-of-two scaling, the
// first min(m, n) rows with the diagonal's sign normalized.  The TPU kernel's
// one-hot column extraction is a layout workaround there; here the column is
// indexed directly, the values are the same.  The batch's ragged edge is
// masked, not padded.
//
// What bounds it: (m n + min(m, n) n) floats a matrix against ~4 m n^2
// operations: at (10, 5) that is 300 bytes against ~1,000 operations, so device
// memory bounds a large batch, and the kernel is one coalesced read, the QR in
// registers and one coalesced write.

#include "lanes.cuh"

namespace {

template <int M, int N>
__global__ void __launch_bounds__(THREADS) batched_qr(const float* x_in, float* r_out, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= B) return;
  constexpr int K = M < N ? M : N;
  constexpr int J = N < M - 1 ? N : M - 1;
  float x[M][N];
  load(x, x_in, b, B);
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
#pragma unroll
      for (int r = 0; r < M; ++r) x[r][c] = x[r][c] - inv * v[r] * coeff;
    }
  }
  float r[K][N];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float d = x[i][i] >= 0.0f ? 1.0f : -1.0f;
#pragma unroll
    for (int c = 0; c < N; ++c) r[i][c] = x[i][c] * d;
  }
  store(r, r_out, b, B);
}

}  // namespace

#define ODECKPT_QR_CASE(M, N) \
  if (m == M && n == N) { batched_qr<M, N><<<grid, block, 0, st>>>(x, r, B); launched = true; }

// C interface.  x: (m, n, batch) float32, lanes-last, contiguous; r:
// (min(m, n), n, batch).  Built for (m, n) in {(10, 5), (6, 6), (4, 2), (6, 3),
// (8, 4), (12, 6)}.  Returns the cudaError_t of the launch.
extern "C" int odeckpt_batched_qr(int m, int n, const void* x_ptr, void* r_ptr, long long batch,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = lanes_grid(batch), block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(x_ptr);
  float* r = static_cast<float*>(r_ptr);
  const int64_t B = batch;
  bool launched = false;
  ODECKPT_QR_CASE(10, 5)
  ODECKPT_QR_CASE(6, 6)
  ODECKPT_QR_CASE(4, 2)
  ODECKPT_QR_CASE(6, 3)
  ODECKPT_QR_CASE(8, 4)
  ODECKPT_QR_CASE(12, 6)
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
