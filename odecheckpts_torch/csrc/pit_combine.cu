// K8: one Kogge-Stone level of the parallel-in-time prefix, the sqrt combine of
// P element pairs, one pair per thread.  Replaces
// odecheckpts_tpu/pit_fused.py:_pallas_combine (body combine_sqrt_ll), the
// per-level Mosaic kernel of combine_engine "pallas"; the twin is
// odecheckpts_torch/pit_fused.py:combine_sqrt_ll.
//
// The ten operands (A, b, U, eta, Z of the earlier and of the later elements)
// are lanes-last, (M, M, P) and (M, C, P), so neighbouring threads read
// neighbouring words; the five outputs likewise.  The ragged edge is masked
// (P need not be a multiple of the block).  The shift, the identity fill and
// the select between levels stay in PyTorch (pit_fused.prefix_scan_sqrt_ll).
//
// What bounds it: a pair is 2 (3 M^2 + 2 M C) scalars in and half of that out
// (144 + 72 at M = 4, C = 3) against about 5,000 operations, so the operation
// bound is the larger one; but a window of the fixed-grid solve has P <= 2048
// pairs, 16 blocks on 132 SMs, and each thread runs four dependent (2M, M)
// QRs and four substitutions: a launch is bound by that chain's latency, and
// the card is nearly idle.  One lane per thread keeps the twin's operation
// order, which is what this kernel is held to.

#include "pit_combine.cuh"

namespace {

template <class T>
struct CombineArgs {
  const T* in[10];
  T* out[5];
};

template <class T, int M, int C>
__device__ __forceinline__ void load_element(Element<T, M, C>& e, const T* const* src, int64_t b,
                                             int64_t P) {
  load(e.a, src[0], b, P);
  load(e.b, src[1], b, P);
  load(e.u, src[2], b, P);
  load(e.eta, src[3], b, P);
  load(e.z, src[4], b, P);
}

template <class T, int M, int C>
__global__ void __launch_bounds__(THREADS) pit_combine(CombineArgs<T> args, int64_t P) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= P) return;
  Element<T, M, C> ei, ej, out;
  load_element(ei, args.in, b, P);
  load_element(ej, args.in + 5, b, P);
  combine_sqrt(out, ei, ej);
  store(out.a, args.out[0], b, P);
  store(out.b, args.out[1], b, P);
  store(out.u, args.out[2], b, P);
  store(out.eta, args.out[3], b, P);
  store(out.z, args.out[4], b, P);
}

template <class T, int M>
int launch_c(int c, const CombineArgs<T>& args, long long pairs, cudaStream_t st) {
  const dim3 grid = lanes_grid(pairs), block(THREADS);
  const int64_t P = pairs;
  switch (c) {
    case 1: pit_combine<T, M, 1><<<grid, block, 0, st>>>(args, P); break;
    case 2: pit_combine<T, M, 2><<<grid, block, 0, st>>>(args, P); break;
    case 3: pit_combine<T, M, 3><<<grid, block, 0, st>>>(args, P); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
