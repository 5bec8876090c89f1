// K10 and K11: the layout microbenchmark of the in-kernel Householder QR.
// Replaces experiments/6_tpu_batched_sweep/qr_packing_bench.py:_bench_kernel,
// variant "cols" (K10) and the masked variant (K11); the plain versions are
// odecheckpts_torch/kernels.py:qr_packing_cols_plain / qr_packing_masked_plain.
//
// Each lane's (m, n) matrix runs `iters` QRs in a runtime loop, adding 1e-6 k
// before the k-th (so nothing is hoisted), and the last is stored.  K10 is the
// column-list QR (lanes.cuh's qr_r_cols): reflection j touches columns
// j..n-1.  K11 applies every reflection to all n columns and multiplies the
// coefficient by the `active` mask (c >= j): the wasted work is what is
// measured (built with -fmad=false and without fast math, a product with 0.0
// is not elided).  On the TPU the question was vector throughput against the
// number of instructions; on the GPU a masked column costs the issue slot of
// a column the team has no use for.
//
// What bounds them: 2 m n floats a lane against iters * ~(4/3) n^3
// operations: operations, by a wide margin at iters = 200.  A thread a lane
// (the first design) leaves the reference's 8,192 lanes on 64 of 132 SMs, one
// warp a scheduler stalled on its lane's chains of dependent sums, the IEEE
// root and the division.  So a small batch gives a lane a team of T threads (T a power of two: a team never straddles a
// warp), member t holding the columns c = k T + t (round robin keeps K10's
// shrinking set of active columns balanced).  Reflection j: column j's owner
// (member j mod T) broadcasts its m entries by shuffles within the team;
// every member forms the masked column, norm2, head, alpha, v and inv in the
// plain version's order, so all hold the same bits and the branches on
// head >= 0 and vnorm2 > FLT_MIN agree; then each member updates its own
// columns, in the plain version's row order.  Every member repeats that
// chain, so a warp instruction of it serves 32 / T lanes: once the card is
// full a thread a lane (T = 1, the first design's arithmetic) issues about
// half the instructions a lane and wins.  The caller picks the team from the
// batch and the card's SMs (kernels.qr_packing_team) and passes it.

#include "lanes.cuh"

namespace {

constexpr unsigned PACKING_FULL_MASK = 0xffffffffu;

// The columns a member holds: n / T rounded up (a column past n is zero and
// never stored).
template <int N, int T>
constexpr int team_slots = (N + T - 1) / T;

// Reflection j's vector v and factor inv, formed by every member of the team
// from column j (slot j / T of member j mod T): lanes.cuh's qr_r_cols, term
// for term.
template <int M, int S, int T>
__device__ __forceinline__ void reflection(const float (&cols)[S][M], int j, float (&v)[M],
                                           float& inv) {
  float colm[M];
#pragma unroll
  for (int r = 0; r < M; ++r) {
    float e = cols[j / T][r];
    if (T > 1) e = __shfl_sync(PACKING_FULL_MASK, e, j % T, T);
    colm[r] = e * (r >= j ? 1.0f : 0.0f);
  }
  float norm2 = colm[0] * colm[0];
#pragma unroll
  for (int r = 1; r < M; ++r) norm2 = norm2 + colm[r] * colm[r];
  const float norm = sqrtf(norm2 + FLT_MIN);
  float head = colm[0] * (j == 0 ? 1.0f : 0.0f);
#pragma unroll
  for (int r = 1; r < M; ++r) head = head + colm[r] * (r == j ? 1.0f : 0.0f);
  const float sign = head >= 0.0f ? 1.0f : -1.0f;
  const float alpha = -sign * norm;
#pragma unroll
  for (int r = 0; r < M; ++r) v[r] = colm[r] - (r == j ? 1.0f : 0.0f) * alpha;
  const float vnorm2 = norm2 + alpha * alpha - 2.0f * head * alpha;
  inv = vnorm2 > FLT_MIN ? 2.0f / vnorm2 : 0.0f;
}

// The QRs of one lane's matrix by member t of its team.  MASKED: K11 (every
// slot, the coefficient times c >= j); else K10 (the slots holding a column
// c >= j; in the one slot where members differ, the others keep theirs).
template <int M, int N, int T, bool MASKED>
__device__ __forceinline__ void team_qrs(float (&cols)[team_slots<N, T>][M], int t, int iters) {
  constexpr int S = team_slots<N, T>;
  constexpr int J = N < M - 1 ? N : M - 1;
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    const float p = 1e-6f * static_cast<float>(k);
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int r = 0; r < M; ++r) cols[s][r] = cols[s][r] + p;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float v[M], inv;
      reflection<M, S, T>(cols, j, v, inv);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        // slot s holds columns s T .. s T + T - 1: all >= j, all < j, or split at member j - s T
        const bool all_on = s * T >= j, all_off = s * T + T <= j;
        if (!MASKED && all_off) continue;
        const bool on = all_on || (!all_off && t >= j - s * T);
        float coeff = v[0] * cols[s][0];
#pragma unroll
        for (int r = 1; r < M; ++r) coeff = coeff + v[r] * cols[s][r];
        if (MASKED) {
          const float masked = coeff * (all_on ? 1.0f : (all_off ? 0.0f : (on ? 1.0f : 0.0f)));
#pragma unroll
          for (int r = 0; r < M; ++r) cols[s][r] = cols[s][r] - inv * v[r] * masked;
        } else {
#pragma unroll
          for (int r = 0; r < M; ++r) {
            const float out = cols[s][r] - inv * v[r] * coeff;
            cols[s][r] = on ? out : cols[s][r];
          }
        }
      }
    }
  }
}

// One team a lane, THREADS / T lanes a block.  A team past the batch works on
// the last lane (every thread of a warp takes part in the shuffles) and
// stores nothing.
template <int M, int N, int T, bool MASKED>
__device__ __forceinline__ void team_lane(const float* x_in, float* x_out, int iters, int64_t B) {
  constexpr int S = team_slots<N, T>;
  const int t = static_cast<int>(threadIdx.x) % T;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * (THREADS / T) + threadIdx.x / T;
  const int64_t b = lane < B ? lane : B - 1;
  float cols[S][M];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int c = s * T + t;
#pragma unroll
    for (int r = 0; r < M; ++r) cols[s][r] = c < N ? x_in[(r * N + c) * B + b] : 0.0f;
  }
  team_qrs<M, N, T, MASKED>(cols, t, iters);
  if (lane >= B) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int c = s * T + t;
    if (c < N) {
#pragma unroll
      for (int r = 0; r < M; ++r) x_out[(r * N + c) * B + b] = cols[s][r];
    }
  }
}

template <int M, int N, int T>
__global__ void __launch_bounds__(THREADS) qr_packing_cols(const float* x_in, float* x_out,
                                                          int iters, int64_t B) {
  team_lane<M, N, T, false>(x_in, x_out, iters, B);
}

template <int M, int N, int T>
__global__ void __launch_bounds__(THREADS) qr_packing_masked(const float* x_in, float* x_out,
                                                            int iters, int64_t B) {
  team_lane<M, N, T, true>(x_in, x_out, iters, B);
}

// The team built beside a thread a lane (kernels.QR_PACKING_TEAM; a
// measurement builds another with -DQR_PACKING_TEAM=k).
#ifndef QR_PACKING_TEAM
#define QR_PACKING_TEAM 4
#endif

template <int M, int N, int T>
cudaError_t launch_shape(bool masked, int iters, const float* x, float* out, int64_t B,
                         cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((B + THREADS / T - 1) / (THREADS / T))), block(THREADS);
  if (masked)
    qr_packing_masked<M, N, T><<<grid, block, 0, st>>>(x, out, iters, B);
  else
    qr_packing_cols<M, N, T><<<grid, block, 0, st>>>(x, out, iters, B);
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_team(bool masked, int m, int n, int iters, const float* x, float* out,
                        int64_t B, cudaStream_t st) {
  if (m == 10 && n == 10) return launch_shape<10, 10, T>(masked, iters, x, out, B, st);
  if (m == 8 && n == 8) return launch_shape<8, 8, T>(masked, iters, x, out, B, st);
  if (m == 6 && n == 6) return launch_shape<6, 6, T>(masked, iters, x, out, B, st);
  return cudaErrorInvalidValue;
}

int packing_entry(bool masked, int m, int n, int iters, int team, const void* x_ptr,
                  void* out_ptr, long long batch, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* x = static_cast<const float*>(x_ptr);
  float* out = static_cast<float*>(out_ptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (team == 1) return static_cast<int>(launch_team<1>(masked, m, n, iters, x, out, batch, st));
  if (team == QR_PACKING_TEAM)
    return static_cast<int>(launch_team<QR_PACKING_TEAM>(masked, m, n, iters, x, out, batch, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface: odeckpt_qr_packing_cols (K10) and odeckpt_qr_packing_masked
// (K11).  x and out: (m, n, batch) float32, lanes-last, contiguous.  Built
// for (m, n) in {(10, 10), (8, 8), (6, 6)} and teams of 1 and QR_PACKING_TEAM
// threads a lane.  Each returns the cudaError_t of the launch.
extern "C" int odeckpt_qr_packing_cols(int m, int n, int iters, int team, const void* x, void* out,
                                       long long batch, int device, void* stream) {
  return packing_entry(false, m, n, iters, team, x, out, batch, device, stream);
}

extern "C" int odeckpt_qr_packing_masked(int m, int n, int iters, int team, const void* x,
                                         void* out, long long batch, int device, void* stream) {
  return packing_entry(true, m, n, iters, team, x, out, batch, device, stream);
}
