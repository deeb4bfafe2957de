// FedAvgM server step's fused reduce, written by hand for Hopper
// (sm_90a): in one pass over the client deltas,
//   d[p]  = sum_c w[c] * x[c, p]
//   nm[p] = beta * m[p] + d[p].
//
// Replaces: src/repro/kernels/agg_reduce.py::_moment_kernel (the
// pallas_call in momentum_reduce_flat).
//
// Inputs x (C, P) f32 contiguous (the raveled client deltas), w (C,) f32,
// m (P,) f32 (the server momentum); outputs d (P,) and nm (P,) f32. beta
// is an argument, not a template parameter: one build serves every
// momentum. P is not padded: the grid covers it and the last block masks
// its tail.
//
// Bound on the H100: bytes. Each x value is read once for one FMA, m once,
// d and nm written once: 4 (C P + 3 P + C) bytes, 27.8 MB at the
// quickstart's (C, P) = (10, 534016), about 8.3 us at 3.35 TB/s. The
// design is fedavg_reduce.cu's: a grid over P, each thread owning 4
// consecutive outputs, read as one float4 per client when P is a
// multiple of 4 and every pointer is 16-byte aligned, one float
// otherwise. Clients are walked in the fixed order 0..C-1 (no atomics,
// no split over C), so the result is deterministic. beta * m + d is
// rounded twice, as the plain version computes it (no fused FMA there).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float momentum(float beta, float m, float d) {
  return __fadd_rn(__fmul_rn(beta, m), d);
}

__global__ void __launch_bounds__(kThreads)
momentum_reduce_vec4_kernel(const float4* __restrict__ x,
                            const float* __restrict__ w,
                            const float4* __restrict__ m,
                            float4* __restrict__ d, float4* __restrict__ nm,
                            float beta, int C, long long P4) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= P4) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = 0; c < C; ++c) {
    const float wc = __ldg(w + c);
    const float4 xv = __ldg(x + static_cast<long long>(c) * P4 + i);
    acc.x = fmaf(wc, xv.x, acc.x);
    acc.y = fmaf(wc, xv.y, acc.y);
    acc.z = fmaf(wc, xv.z, acc.z);
    acc.w = fmaf(wc, xv.w, acc.w);
  }
  const float4 mv = __ldg(m + i);
  d[i] = acc;
  nm[i] = make_float4(momentum(beta, mv.x, acc.x),
                      momentum(beta, mv.y, acc.y),
                      momentum(beta, mv.z, acc.z),
                      momentum(beta, mv.w, acc.w));
}

__global__ void __launch_bounds__(kThreads)
momentum_reduce_scalar_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ m,
                              float* __restrict__ d, float* __restrict__ nm,
                              float beta, int C, long long P) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= P) return;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c)
    acc = fmaf(__ldg(w + c), __ldg(x + static_cast<long long>(c) * P + i),
               acc);
  d[i] = acc;
  nm[i] = momentum(beta, __ldg(m + i), acc);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// C entry, bound with ctypes. Launches on `stream` (PyTorch's current
// stream), allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int momentum_reduce_launch(const float* x, const float* w,
                                      const float* m, float* d, float* nm,
                                      float beta, int C, long long P,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P % 4 == 0 && aligned16(x) && aligned16(m) && aligned16(d) &&
      aligned16(nm)) {
    const long long p4 = P / 4;
    const unsigned blocks =
        static_cast<unsigned>((p4 + kThreads - 1) / kThreads);
    momentum_reduce_vec4_kernel<<<blocks, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(x), w,
        reinterpret_cast<const float4*>(m), reinterpret_cast<float4*>(d),
        reinterpret_cast<float4*>(nm), beta, C, p4);
  } else {
    const unsigned blocks =
        static_cast<unsigned>((P + kThreads - 1) / kThreads);
    momentum_reduce_scalar_kernel<<<blocks, kThreads, 0, st>>>(
        x, w, m, d, nm, beta, C, P);
  }
  return static_cast<int>(cudaGetLastError());
}
