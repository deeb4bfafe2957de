// Flash-attention forward (online softmax) for the LM backbones, written
// by hand for Hopper (sm_90a), CUDA cores only.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the
// pallas_call in flash_attention_bhsd).
//
// Inputs q (B, H, S, HD) and k, v (B, KV, S, HD), all float or all
// bf16, contiguous; output o (B, H, S, HD) in the same type. Query head h
// reads kv head h / (H / KV) by index, so repeated KV is never
// materialised (GQA). Key j is allowed for query i iff j < kv_len, and
// j <= i when causal, and i - j < window when window > 0. The scores are
// scale * q.k in f32 from upcast inputs, then cap * tanh(s / cap) when
// cap > 0, then masked to -1e30 (the TPU kernel's order and mask value).
// p is rounded to v's type before the PV product, as the TPU kernel's
// p.astype(v.dtype) does; l sums the unrounded p; o = acc / max(l, 1e-30).
// kv_len is the caller's unpadded length: the wrapper pads S to its block,
// and the padded keys are masked here, so every S and both causal and
// non-causal give ref_attention's result (the TPU wrapper leaves padded
// keys visible when causal is off).
//
// Bound on the H100 SXM at its 700 W limit (data-sheet rates: 3.35 TB/s,
// 989 TFLOP/s bf16 dense, 67 TFLOP/s f32): at qwen2-0.5b's prefill (B 4,
// H 14, KV 2, S 2048, HD 64, bf16, causal) the band is ~30 GFLOP of
// products against 33.6 MB of q/k/v/o, so it is bound by operations:
// ~30 us at the bf16 tensor-core rate, ~450 us at the f32 CUDA-core rate
// this kernel runs at. The simple
// design: one block per (b*h, 64 query rows), two threads per row, each
// owning half of the head's dims (interleaved in pairs, so the two halves
// of a warp hit neighbouring banks). The block walks 32-key tiles of K and
// V staged in shared memory as f32, keeping m, l and the accumulator in
// registers; the TPU kernel's sequential k grid becomes that loop. Tiles
// wholly outside the causal or window band, or past kv_len, are skipped by
// the TPU kernel's relevance rule. The q tiles run heaviest first (the
// last rows of a causal prefill see the most keys). Tensor cores (mma or
// wgmma on bf16 tiles) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr int kRows = 64;          // query rows per block
constexpr int kThreads = 2 * kRows;
constexpr int kKeys = 32;          // keys per shared-memory tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H,
                           int KV, int S, int kv_len, int causal, int window,
                           float cap, float scale) {
  constexpr int kHalf = HD / 2;  // dims a thread owns
  __shared__ __align__(16) float ks[kKeys][HD];
  __shared__ __align__(16) float vs[kKeys][HD];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / KV);
  const size_t q_base = static_cast<size_t>(bh) * S * HD;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S * HD;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kRows;  // heavy first
  const int row = q_start + threadIdx.x / 2;
  const int half = threadIdx.x & 1;
  const bool live = row < S;  // dead threads still join every barrier

  // this thread's dims: pairs 2*half, 2*half+1 of every group of four
  float qr[kHalf];
  float acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf / 2; ++i) {
    const int d = 4 * i + 2 * half;
    const size_t g = q_base + static_cast<size_t>(row) * HD + d;
    qr[2 * i] = live ? to_f32(q[g]) : 0.0f;
    qr[2 * i + 1] = live ? to_f32(q[g + 1]) : 0.0f;
    acc[2 * i] = 0.0f;
    acc[2 * i + 1] = 0.0f;
  }
  float m = kNegInf;
  float l = 0.0f;

  for (int k_start = 0; k_start < S; k_start += kKeys) {
    // the TPU kernel's block relevance rule, and the unpadded length
    bool relevant = k_start < kv_len;
    if (causal) relevant = relevant && k_start <= q_start + kRows - 1;
    if (window > 0)
      relevant = relevant && k_start + kKeys > q_start - window + 1;
    if (!relevant) continue;  // uniform over the block

    const int n = min(kKeys, S - k_start);
    for (int i = threadIdx.x; i < kKeys * HD; i += kThreads) {
      const int j = i / HD;
      const int d = i % HD;
      const size_t g = kv_base + static_cast<size_t>(k_start + j) * HD + d;
      ks[j][d] = j < n ? to_f32(k[g]) : 0.0f;
      vs[j][d] = j < n ? to_f32(v[g]) : 0.0f;
    }
    __syncthreads();

    float s[kKeys];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kHalf / 2; ++i) {
        const float2 kk =
            *reinterpret_cast<const float2*>(&ks[j][4 * i + 2 * half]);
        dot = fmaf(qr[2 * i], kk.x, dot);
        dot = fmaf(qr[2 * i + 1], kk.y, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);  // the row's other half
      float sv = dot * scale;
      if (cap > 0.0f) sv = cap * tanhf(sv / cap);
      const int kpos = k_start + j;
      bool ok = kpos < kv_len;
      if (causal) ok = ok && kpos <= row;
      if (window > 0) ok = ok && row - kpos < window;
      s[j] = ok ? sv : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float pv = to_f32(from_f32<T>(p));  // p.astype(v.dtype)
#pragma unroll
      for (int i = 0; i < kHalf / 2; ++i) {
        const float2 vv =
            *reinterpret_cast<const float2*>(&vs[j][4 * i + 2 * half]);
        acc[2 * i] = fmaf(pv, vv.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(pv, vv.y, acc[2 * i + 1]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (live) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) {
      const size_t g =
          q_base + static_cast<size_t>(row) * HD + 4 * i + 2 * half;
      o[g] = from_f32<T>(acc[2 * i] / lc);
      o[g + 1] = from_f32<T>(acc[2 * i + 1] / lc);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, int kv_len, int hd, int causal, int window,
           float cap, cudaStream_t st) {
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  switch (hd) {
    case 64:
      flash_attention_fwd_kernel<T, 64><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), H, KV, S, kv_len,
          causal, window, cap, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes. dtype 0 is float, 1 is bf16; cap <= 0 means
// no softcap; window <= 0 means global. Launches on `stream` (PyTorch's
// current stream), allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head width or type
// that is not instantiated here, or H not a multiple of KV.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int H, int KV, int S, int kv_len,
                                          int hd, int causal, int window,
                                          float cap, int dtype,
                                          void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, H, KV, S, kv_len, hd, causal, window,
                         cap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, kv_len, hd, causal,
                                 window, cap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
