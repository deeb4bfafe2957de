// The DP-FedAvg reduction, written by hand for Hopper (sm_90a):
//   out[p] = sum_c w[c] * (x[c, p] * min(1, clip / max(|x_c|, 1e-12))
//                          + noise[c, p]),
// the noise term only when a presampled noise matrix is given.
//
// Replaces: src/repro/kernels/agg_reduce.py::_clip_reduce_kernel and
// _clip_reduce_noise_kernel (the pallas_call in clip_reduce_flat). That
// kernel runs a sequential (2, nb) grid: sweep 0 sums every client's
// squared norm into a (C, 1) scratch, sweep 1 scales, adds the noise and
// reduces. Here (client_rows.cuh):
//   1. row_sumsq_kernel on a (nb, C) grid writes per-chunk partial
//      squared norms to part (nb, C);
//   2. clip_reduce_kernel, a grid over P: each block first finishes the
//      C norms from the partials in a fixed order and turns them into
//      the clip scales (shared memory), then each thread takes 4 columns
//      (strided by the block) and walks the clients 0..C-1 in order.
// No atomics: two calls are bit-equal. Without noise the second kernel
// takes no noise operand (no zero matrix is read).
//
// Inputs x (C, P), noise (C, P) or null, w (C,), all f32 contiguous;
// scratch part (nb, C) and output (P,) f32, allocated by the wrapper.
//
// Bound on the H100: bytes. The function reads x and the noise once and
// writes (P,): 4 (2 C P + P + C) bytes with noise, 44.9 MB at the
// quickstart's (C, P) = (10, 534016), about 13.4 us at 3.35 TB/s; 23.5 MB
// and 7.0 us without. The design reads x twice (norms, then the reduce),
// so it moves 1.5x (with noise) to 1.9x (without) those bytes.
#include <cuda_runtime.h>

#include "client_rows.cuh"

namespace {

using namespace client_rows;

template <bool kNoise>
__global__ void __launch_bounds__(kThreads)
clip_reduce_kernel(const float* __restrict__ x,
                   const float* __restrict__ noise,
                   const float* __restrict__ w,
                   const float* __restrict__ part, int nb, float clip,
                   float* __restrict__ out, int C, long long P) {
  extern __shared__ float scale[];  // [C]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = warp; c < C; c += kWarps) {
    const float sq = finish_sum(part, nb, C, c);
    if (lane == 0) scale[c] = clip_scale(sq, clip);
  }
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * kBlockCols +
                         threadIdx.x;
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float wc = __ldg(w + c), sc = scale[c];
    const long long row = static_cast<long long>(c) * P;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const long long p = base + static_cast<long long>(k) * kThreads;
      if (p < P) {
        float y = __fmul_rn(__ldg(x + row + p), sc);
        if (kNoise) y = __fadd_rn(y, __ldg(noise + row + p));
        acc[k] = fmaf(wc, y, acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const long long p = base + static_cast<long long>(k) * kThreads;
    if (p < P) out[p] = acc[k];
  }
}

}  // namespace

// C entry, bound with ctypes: both launches on `stream` (PyTorch's current
// stream). noise may be null (the clip-only kernel). part holds nb * C
// floats, nb = ceil(P / 8192), which the wrapper computes from the same
// chunk and passes for a check. Allocates nothing, does not synchronise;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a bad size or
// clip <= 0.
extern "C" int clip_reduce_launch(const float* x, const float* noise,
                                  const float* w, float* part, float* out,
                                  float clip, int C, long long P,
                                  long long nb, void* stream) {
  if (C < 1 || C > kMaxRows || P < 1 || nb != num_chunks(P) ||
      !(clip > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  row_sumsq_kernel<<<dim3(static_cast<unsigned>(nb),
                          static_cast<unsigned>(C)),
                     kThreads, 0, st>>>(x, part, C, P);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const unsigned blocks =
      static_cast<unsigned>((P + kBlockCols - 1) / kBlockCols);
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  if (noise != nullptr)
    clip_reduce_kernel<true><<<blocks, kThreads, smem, st>>>(
        x, noise, w, part, static_cast<int>(nb), clip, out, C, P);
  else
    clip_reduce_kernel<false><<<blocks, kThreads, smem, st>>>(
        x, nullptr, w, part, static_cast<int>(nb), clip, out, C, P);
  return static_cast<int>(cudaGetLastError());
}
