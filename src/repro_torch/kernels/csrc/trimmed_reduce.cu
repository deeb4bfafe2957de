// Per-coordinate rank-trimmed weighted mean over the client axis, written
// by hand for Hopper (sm_90a): for each coordinate p, client c's stable
// rank is the number of clients j with x[j, p] < x[c, p], or
// x[j, p] == x[c, p] and j < c; the clients ranked in [trim, C - trim)
// survive, and
//   out[p] = sum_surv w[c] x[c, p] / sum_surv w[c].
// trim = (C - 1) / 2 is the coordinate-wise median.
//
// Replaces: src/repro/kernels/agg_reduce.py::_trim_kernel (the
// pallas_call in trimmed_reduce_flat), with its rank predicate exactly
// (agg_reduce.py:486), not a sort with another tie rule.
//
// Inputs x (C, P) f32 contiguous, w (C,) f32; output (P,) f32. The
// wrapper holds 0 <= 2 trim < C and C <= kMaxClients.
//
// Bound on the H100: bytes. 4 (C P + P + C) bytes, 23.5 MB at the
// quickstart's (C, P) = (10, 534016), about 7.0 us at 3.35 TB/s; the
// C^2 compares per coordinate (53 M at that shape) are far under the
// card's rate, if they are plain register compares. Design: one thread
// owns one coordinate and holds its C values in registers (for each
// client, the warp reads 32 consecutive floats). C is a template
// parameter, one instantiation per C in 1..kMaxClients, so every loop
// over the clients unrolls and every client index is a constant: the
// values stay in registers (a runtime index would put them in local
// memory), and the rank predicate splits at compile time into <= for
// lower client indices and < for higher ones. num and den accumulate over
// the survivors in client order 0..C-1. Deterministic: no atomics, one
// thread per output.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// the largest C with an instantiation: 32 values in registers a thread,
// and C^2 = 1024 unrolled compares in the largest one
constexpr int kMaxClients = 32;

template <int C>
__global__ void __launch_bounds__(kThreads)
trimmed_reduce_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, float* __restrict__ out,
                      int trim, long long P) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= P) return;
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    v[c] = __ldg(x + static_cast<long long>(c) * P + p);
  float num = 0.0f;
  float den = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // lower client index: ties count as before; higher: only strictly
    // smaller values do (the same predicate as _trim_kernel, NaN too)
    int rank = 0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < c) rank += v[j] <= v[c];
      if (j > c) rank += v[j] < v[c];
    }
    if (rank >= trim && rank < C - trim) {
      const float wc = __ldg(w + c);
      num = fmaf(wc, v[c], num);
      den += wc;
    }
  }
  out[p] = num / den;
}

template <int C>
void launch(const float* x, const float* w, float* out, int trim,
            long long P, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((P + kThreads - 1) / kThreads);
  trimmed_reduce_kernel<C><<<blocks, kThreads, 0, st>>>(x, w, out, trim, P);
}

// launch<c> for the runtime c, c in [C, kMaxClients]
template <int C>
void dispatch(int c, const float* x, const float* w, float* out, int trim,
              long long P, cudaStream_t st) {
  if (c == C) {
    launch<C>(x, w, out, trim, P, st);
  } else if constexpr (C < kMaxClients) {
    dispatch<C + 1>(c, x, w, out, trim, P, st);
  }
}

}  // namespace

// C entry, bound with ctypes. Launches on `stream` (PyTorch's current
// stream), allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a C above the cap.
extern "C" int trimmed_reduce_launch(const float* x, const float* w,
                                     float* out, int C, int trim,
                                     long long P, void* stream) {
  if (C < 1 || C > kMaxClients || trim < 0 || 2 * trim >= C)
    return static_cast<int>(cudaErrorInvalidValue);
  dispatch<1>(C, x, w, out, trim, P, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
