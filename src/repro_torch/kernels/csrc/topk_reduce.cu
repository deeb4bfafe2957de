// The top-k transport's mask and weighted reduce, written by hand for
// Hopper (sm_90a): given per-client magnitude thresholds tau (C,),
//   t[c, p] = |x[c, p]| >= tau[c] ? x[c, p] : 0   (threshold ties kept)
//   out[p] = sum_c w[c] t[c, p],  resid'[c, p] = x[c, p] - t[c, p].
//
// Replaces: src/repro/kernels/agg_reduce.py::_topk_kernel (the
// pallas_call in topk_reduce_flat). The thresholds (the k-th largest
// |x_c| per client) are a global selection and stay outside the kernel,
// as in the reference.
//
// One pass, a grid over P: each thread takes 4 columns (strided by the
// block, so each warp's loads stay coalesced) and walks the clients
// 0..C-1 in a fixed order. No atomics: two calls are bit-equal. The
// residual is written only when the wrapper asks for it.
//
// Inputs x (C, P), w (C,), tau (C,), all f32 contiguous; outputs out (P,)
// and resid_out (C, P) or null, allocated by the wrapper.
//
// Bound on the H100: bytes. Each input read once and each output written
// once: 4 (2 C P + P + 2 C) bytes with the residual, 44.9 MB at the
// quickstart's (C, P) = (10, 534016), about 13.4 us at 3.35 TB/s;
// 4 (C P + P + 2 C), 23.5 MB and 7.0 us without. The design moves those
// bytes and no more.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;
constexpr long long kBlockCols = static_cast<long long>(kThreads) * kCols;

template <bool kResid>
__global__ void __launch_bounds__(kThreads)
topk_reduce_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ tau, float* __restrict__ out,
                   float* __restrict__ resid_out, int C, long long P) {
  const long long base = static_cast<long long>(blockIdx.x) * kBlockCols +
                         threadIdx.x;
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float wc = __ldg(w + c), tc = __ldg(tau + c);
    const long long row = static_cast<long long>(c) * P;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const long long p = base + static_cast<long long>(k) * kThreads;
      if (p < P) {
        const float v = __ldg(x + row + p);
        const float t = fabsf(v) >= tc ? v : 0.0f;
        acc[k] = fmaf(wc, t, acc[k]);
        if (kResid) resid_out[row + p] = __fsub_rn(v, t);
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

// C entry, bound with ctypes: one launch on `stream` (PyTorch's current
// stream); resid_out may be null (no residual written). Allocates
// nothing, does not synchronise; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a bad size.
extern "C" int topk_reduce_launch(const float* x, const float* w,
                                  const float* tau, float* out,
                                  float* resid_out, int C, long long P,
                                  void* stream) {
  if (C < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      static_cast<unsigned>((P + kBlockCols - 1) / kBlockCols);
  if (resid_out != nullptr)
    topk_reduce_kernel<true><<<blocks, kThreads, 0, st>>>(x, w, tau, out,
                                                          resid_out, C, P);
  else
    topk_reduce_kernel<false><<<blocks, kThreads, 0, st>>>(x, w, tau, out,
                                                           nullptr, C, P);
  return static_cast<int>(cudaGetLastError());
}
