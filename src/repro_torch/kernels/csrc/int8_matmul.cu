// Int8 weight-only inference matmul for the GPO serving path, written by
// hand for Hopper (sm_90a), CUDA cores only.
//
// Replaces: src/repro/kernels/quant_matmul.py::_int8_matmul_kernel
// (the pallas_call in int8_matmul_flat).
//
// Computes out[m, n] = (sum_k x[m, k] * float(q[k, n])) * scale[n]:
// x (M, K) f32 row-major, q (K, N) int8 row-major, scale (N,) f32,
// out (M, N) f32. The scale is applied after the K loop.
//
// Bound on the H100: at serving shapes (M <= 1280, K <= 256, N <= 256) a
// call moves <= ~2 MB and does <= ~84 MFLOP, under 1 us at 3.35 TB/s or
// 67 TFLOP/s f32, so launch latency bounds it. The design is simple and
// right first: 64x64 output tiles, 256 threads of 4x4 outputs each, K
// walked in 32-deep tiles through shared memory (x as f32, q upcast on
// load), so K is unbounded (K = 4098 at the paper's width). All three
// edges are masked here; the wrapper does not pad. No atomics and no
// split-K: an output is one thread's sum in fixed K order, so a row's
// result does not depend on M or on the other rows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // K depth per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTM = kBM / 16;  // rows per thread
constexpr int kTN = kBN / 16;  // columns per thread

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int N, int K) {
  // x tile stored transposed (k-major) with one float of padding, so the
  // k-consecutive stores of a warp fall in distinct banks
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i % kBK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk]
                                    : 0.0f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i % kBN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      ws[r][c] = (gk < K && gn < N)
                     ? static_cast<float>(q[static_cast<size_t>(gk) * N + gn])
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
      float b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j] * scale[gn];
    }
  }
}

}  // namespace

// C entry, bound with ctypes. Launches on `stream` (PyTorch's current
// stream), allocates nothing, does not synchronise; returns
// cudaGetLastError() so a refused launch is reported.
extern "C" int int8_matmul_launch(const float* x, const int8_t* q,
                                  const float* scale, float* out, int M,
                                  int N, int K, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, q, scale, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
