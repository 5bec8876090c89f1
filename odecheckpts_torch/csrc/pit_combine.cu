// K8: one Kogge-Stone level of the parallel-in-time prefix, the sqrt combine of
// P element pairs, a team of K8_TEAM threads a pair.  Replaces
// odecheckpts_tpu/pit_fused.py:_pallas_combine (body combine_sqrt_ll), the
// per-level Mosaic kernel of combine_engine "pallas"; the twin is
// odecheckpts_torch/pit_fused.py:combine_sqrt_ll.
//
// The ten operands (A, b, U, eta, Z of the earlier and of the later elements)
// are lanes-last, (M, M, P) and (M, C, P); the five outputs likewise.  A block
// holds K8_PAIRS pairs in two warps: its threads load the pairs' operands
// into shared memory together, then the first warp works the R1 chains of
// its pairs and the second warp their R2 chains (pit_combine.cuh), each
// storing its outputs.  The ragged edge is masked: a team past P works on
// the last pair's operands and stores nothing, so every lane reaches every
// __syncwarp.  The shift, the identity fill and the
// select between levels stay in PyTorch (pit_fused.prefix_scan_sqrt_ll).
//
// What bounds it: a pair is 2 (3 M^2 + 2 M C) scalars in and half of that out
// (144 + 72 at M = 4, C = 3) against about 5,000 operations, so the operation
// bound is the larger one; but a window of the fixed-grid solve has P <= 2048
// pairs, and the combine is a chain of four dependent (2M, M) QRs and four
// substitutions: a launch is bound by that chain's latency, with the card
// nearly idle.  The first design ran the chain on one thread a pair (32 warps
// at 1,024 pairs, 255 registers, spilling in f64); the team shortens the
// chain by splitting each stage over independent outputs and running the R1
// and R2 chains at once, puts 8 times the warps on the card and holds the
// pair in shared memory, not registers.

#include "pit_combine.cuh"

namespace {

template <class T>
struct CombineArgs {
  const T* in[10];
  T* out[5];
};

// The block's pairs' operands into their slices: element e of input array
// `a` of pair q from its lanes-last column, the last pair's for a pair past
// P.  Every thread issues all its loads before its first shared store, so
// the block waits for device memory once.
template <class T, int M, int C>
__device__ __forceinline__ void load_pairs(T* buf, const T* const* in, int64_t first,
                                           int64_t P) {
  constexpr int S = pair_stride<T, M, C>();
  constexpr int MM = M * M, MC = M * C;
  constexpr int size[5] = {MM, MC, MM, MC, MM};
  constexpr int ROUNDS_MM = (MM * K8_PAIRS + K8_THREADS - 1) / K8_THREADS;
  constexpr int ROUNDS_MC = (MC * K8_PAIRS + K8_THREADS - 1) / K8_THREADS;
  constexpr int PER_LANE = 2 * (3 * ROUNDS_MM + 2 * ROUNDS_MC);  // loads a lane
  T x[PER_LANE];
  int n = 0;
#pragma unroll
  for (int f = 0; f < 5; ++f)
#pragma unroll
    for (int side = 0; side < 2; ++side)
#pragma unroll
      for (int idx0 = 0; idx0 < size[f] * K8_PAIRS; idx0 += K8_THREADS) {
        const int idx = idx0 + threadIdx.x, e = idx / K8_PAIRS, q = idx % K8_PAIRS;
        const int64_t pair = first + q < P ? first + q : P - 1;
        if (idx < size[f] * K8_PAIRS) x[n] = in[5 * side + f][e * P + pair];
        ++n;
      }
  n = 0;
  int at = 0;  // the offset of (field, side) in PairShared: a[0], a[1], b[0], ...
#pragma unroll
  for (int f = 0; f < 5; ++f)
#pragma unroll
    for (int side = 0; side < 2; ++side) {
#pragma unroll
      for (int idx0 = 0; idx0 < size[f] * K8_PAIRS; idx0 += K8_THREADS) {
        const int idx = idx0 + threadIdx.x, e = idx / K8_PAIRS, q = idx % K8_PAIRS;
        if (idx < size[f] * K8_PAIRS) buf[q * S + at + e] = x[n];
        ++n;
      }
      at += size[f];
    }
}

template <class T, int M, int C>
__global__ void __launch_bounds__(K8_THREADS) pit_combine(CombineArgs<T> args, int64_t P) {
  constexpr int S = pair_stride<T, M, C>();
  __shared__ T buf[K8_PAIRS * S];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * K8_PAIRS;
  load_pairs<T, M, C>(buf, args.in, first, P);
  __syncthreads();
  const int half = threadIdx.x / 32, lane = threadIdx.x % 32;  // warp = half
  const int q = lane / K8_HALF, member = lane % K8_HALF;
  auto& s = *reinterpret_cast<PairShared<T, M, C>*>(buf + q * S);
  const int64_t pair = first + q;
  if (half == 0) {
    chain_r1(s, member, args.out, pair, P, pair < P);
  } else {
    chain_r2(s, member, args.out, pair, P, pair < P);
  }
}

template <class T, int M, int C>
int launch_mc(const CombineArgs<T>& args, long long pairs, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((pairs + K8_PAIRS - 1) / K8_PAIRS)), block(K8_THREADS);
  pit_combine<T, M, C><<<grid, block, 0, st>>>(args, static_cast<int64_t>(pairs));
  return static_cast<int>(cudaGetLastError());
}

template <class T, int M>
int launch_c(int c, const CombineArgs<T>& args, long long pairs, cudaStream_t st) {
  switch (c) {
    case 1: return launch_mc<T, M, 1>(args, pairs, st);
    case 2: return launch_mc<T, M, 2>(args, pairs, st);
    case 3: return launch_mc<T, M, 3>(args, pairs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class T>
int launch(int m, int c, const void* in_ptrs, const void* out_ptrs, long long pairs, int device,
           void* stream) {
  CombineArgs<T> args;
  for (int i = 0; i < 10; ++i) args.in[i] = static_cast<const T* const*>(in_ptrs)[i];
  for (int i = 0; i < 5; ++i) args.out[i] = static_cast<T* const*>(out_ptrs)[i];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 3: return launch_c<T, 3>(c, args, pairs, st);
    case 4: return launch_c<T, 4>(c, args, pairs, st);
    case 5: return launch_c<T, 5>(c, args, pairs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The geometry of one instantiation: out = threads a pair, pairs a block,
// threads a block, shared-memory bytes a block, resident blocks an SM
// (occupancy API), registers a thread, local bytes a thread.
template <class T, int M, int C>
int report_mc(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, pit_combine<T, M, C>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pit_combine<T, M, C>, K8_THREADS,
                                                      0);
  out[0] = K8_TEAM;
  out[1] = K8_PAIRS;
  out[2] = K8_THREADS;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

template <class T, int M>
int report_c(int c, int* out) {
  switch (c) {
    case 1: return report_mc<T, M, 1>(out);
    case 2: return report_mc<T, M, 2>(out);
    case 3: return report_mc<T, M, 3>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class T>
int report(int m, int c, int* out) {
  switch (m) {
    case 3: return report_c<T, 3>(c, out);
    case 4: return report_c<T, 4>(c, out);
    case 5: return report_c<T, 5>(c, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface.  in_ptrs: host array of the 10 device pointers A_i, b_i, U_i,
// eta_i, Z_i, A_j, b_j, U_j, eta_j, Z_j ((m, m, pairs) and (m, c, pairs),
// lanes-last, contiguous); out_ptrs: host array of the 5 output pointers;
// is_double selects float (0) or double (1) operands.  Built for m in
// {3, 4, 5} and c in {1, 2, 3}.  Returns the cudaError_t of the launch.
extern "C" int odeckpt_pit_combine(int m, int c, int is_double, const void* in_ptrs,
                                   const void* out_ptrs, long long pairs, int device,
                                   void* stream) {
  if (is_double) return launch<double>(m, c, in_ptrs, out_ptrs, pairs, device, stream);
  return launch<float>(m, c, in_ptrs, out_ptrs, pairs, device, stream);
}

// The launch geometry of the (m, c, is_double) instantiation on the current
// device, in the order of report_mc.
extern "C" int odeckpt_pit_combine_geometry(int m, int c, int is_double, int* out) {
  if (is_double) return report<double>(m, c, out);
  return report<float>(m, c, out);
}
