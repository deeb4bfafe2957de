// GPO neural-process attention, forward, written by hand for Hopper
// (sm_90a), CUDA cores only.
//
// Replaces: src/repro/kernels/gpo_attention.py::_gpo_fwd_kernel (the
// pallas_call in _gpo_forward).
//
// Inputs q, k, v (BH, S, HD) f32 contiguous; outputs o (BH, S, HD) and
// lse (BH, S) f32. Key j is allowed for query i iff j < num_ctx (a
// context key) or j == i (a target's own key).
//
// Bound on the H100: at the main path's shapes (BH <= 40, S <= 160,
// HD = 24 or 32) q/k/v are <= 2.5 MB and the band is ~53 MFLOP, both
// near a microsecond of bytes or f32 CUDA-core work, so a call is bound
// by its launch and its per-row latency. The simple design: one block
// per (bh, 64 query rows), one thread per row. The block walks only the
// context keys [0, num_ctx) in tiles of 32, staged in shared memory, and
// keeps the online softmax (m, l, the HD-wide accumulator) in registers.
// After the walk each target row (i >= num_ctx) adds its own key once; a
// context row's own key is already one of the context keys. No S x S
// scores and no target x target key are ever touched: the TPU kernel's
// band as a loop inside the block, independent of grid order.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask value, not -inf
constexpr int kRows = 64;          // query rows (threads) per block
constexpr int kKeys = 32;          // context keys per shared-memory tile

template <int HD>
__global__ void __launch_bounds__(kRows)
gpo_attention_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int num_ctx,
                         float scale) {
  __shared__ float ks[kKeys][HD];
  __shared__ float vs[kKeys][HD];
  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < S;  // dead threads still join every barrier

  float qr[HD];
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = live ? q[base + static_cast<size_t>(row) * HD + d] : 0.0f;
    acc[d] = 0.0f;
  }
  float m = kNegInf;
  float l = 0.0f;

  for (int k0 = 0; k0 < num_ctx; k0 += kKeys) {
    const int n = min(kKeys, num_ctx - k0);  // >= 1 real keys in the tile
    for (int i = threadIdx.x; i < kKeys * HD; i += kRows) {
      const int j = i / HD;
      const int d = i % HD;
      const size_t g = base + static_cast<size_t>(k0 + j) * HD + d;
      ks[j][d] = j < n ? k[g] : 0.0f;
      vs[j][d] = j < n ? v[g] : 0.0f;
    }
    __syncthreads();
    float s[kKeys];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      s[j] = j < n ? dot * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for the masked tail
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
    __syncthreads();
  }

  if (live && row >= num_ctx) {  // a target row: its own key, once
    const float* kr = k + base + static_cast<size_t>(row) * HD;
    const float* vr = v + base + static_cast<size_t>(row) * HD;
    float dot = 0.0f;
#pragma unroll
    for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
    const float sv = dot * scale;
    const float m_new = fmaxf(m, sv);
    const float alpha = expf(m - m_new);
    const float p = expf(sv - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vr[d], acc[d] * alpha);
    m = m_new;
  }

  if (live) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d)
      o[base + static_cast<size_t>(row) * HD + d] = acc[d] / lc;
    lse[static_cast<size_t>(blockIdx.y) * S + row] = m + logf(lc);
  }
}

}  // namespace

// C entry, bound with ctypes. Launches on `stream` (PyTorch's current
// stream), allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head width that is
// not instantiated here.
extern "C" int gpo_attention_fwd_launch(const float* q, const float* k,
                                        const float* v, float* o, float* lse,
                                        int bh, int S, int num_ctx, int hd,
                                        void* stream) {
  const dim3 grid((S + kRows - 1) / kRows, bh);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 24:
      gpo_attention_fwd_kernel<24><<<grid, kRows, 0, st>>>(q, k, v, o, lse, S,
                                                            num_ctx, scale);
      break;
    case 32:
      gpo_attention_fwd_kernel<32><<<grid, kRows, 0, st>>>(q, k, v, o, lse, S,
                                                            num_ctx, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
