// Eq. 3 FedAvg weighted client reduce, written by hand for Hopper
// (sm_90a): out[p] = sum_c w[c] * x[c, p].
//
// Replaces: src/repro/kernels/agg_reduce.py::_fedavg_kernel (the
// pallas_call in fedavg_reduce_flat).
//
// Inputs x (C, P) f32 contiguous (the raveled client deltas), w (C,) f32;
// output (P,) f32. P is not padded: the grid covers it and the last block
// masks its tail.
//
// Bound on the H100: bytes. Each x value is read once and used for one
// FMA, so the kernel moves 4 (C P + P + C) bytes: at the quickstart's
// (C, P) = (10, 534016) that is 23.5 MB, about 7.0 us at 3.35 TB/s. The
// design streams x once: a grid over P, each thread owning 4 consecutive
// outputs and reading them as one float4 per client when P is a multiple
// of 4 and x and out start 16-byte aligned (every row then does), one
// float otherwise.
// Each thread walks the clients in a fixed order 0..C-1, so the sum is
// deterministic: no atomics, no split over C, no dependence on the grid.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fedavg_reduce_vec4_kernel(const float4* __restrict__ x,
                          const float* __restrict__ w,
                          float4* __restrict__ out, int C, long long P4) {
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
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
fedavg_reduce_scalar_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            float* __restrict__ out, int C, long long P) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= P) return;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c)
    acc = fmaf(__ldg(w + c), __ldg(x + static_cast<long long>(c) * P + i),
               acc);
  out[i] = acc;
}

}  // namespace

// C entry, bound with ctypes. Launches on `stream` (PyTorch's current
// stream), allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int fedavg_reduce_launch(const float* x, const float* w,
                                    float* out, int C, long long P,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  if (P % 4 == 0 && aligned) {
    const long long p4 = P / 4;
    const unsigned blocks =
        static_cast<unsigned>((p4 + kThreads - 1) / kThreads);
    fedavg_reduce_vec4_kernel<<<blocks, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(x), w, reinterpret_cast<float4*>(out),
        C, p4);
  } else {
    const unsigned blocks =
        static_cast<unsigned>((P + kThreads - 1) / kThreads);
    fedavg_reduce_scalar_kernel<<<blocks, kThreads, 0, st>>>(x, w, out, C, P);
  }
  return static_cast<int>(cudaGetLastError());
}
