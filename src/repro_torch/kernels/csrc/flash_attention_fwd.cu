// Flash-attention forward (online softmax) for the LM backbones, written
// by hand for Hopper (sm_90a): bf16 on the tensor cores (mma.sync), f32 on
// the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the
// pallas_call in flash_attention_bhsd).
//
// Inputs q (B, H, S, HD) and k, v (B, KV, S, HD), all float or all
// bf16, contiguous; output o (B, H, S, HD) in the same type; HD 64 or 128.
// Query head h reads kv head h / (H / KV) by index, so repeated KV is never
// materialised (GQA). Key j is allowed for query i iff j < kv_len, and
// j <= i when causal, and i - j < window when window > 0. The scores are
// scale * q.k in f32, then cap * tanh(s / cap) when cap > 0, then masked
// to -1e30 (the TPU kernel's order and mask value). p is rounded to v's
// type before the PV product, as the TPU kernel's p.astype(v.dtype) does;
// l sums the unrounded p; o = acc / max(l, 1e-30). kv_len is the caller's
// unpadded length: the wrapper pads S to its block, and the padded keys
// are masked here, so every S and both causal and non-causal give
// ref_attention's result (the TPU wrapper leaves padded keys visible when
// causal is off). Blocks wholly outside the causal or window band, or past
// kv_len, are skipped by the TPU kernel's relevance rule; no result
// depends on the order the blocks run in.
//
// Bound on the H100 SXM at its 700 W limit (data-sheet rates: 3.35 TB/s,
// 989 TFLOP/s bf16 dense, 67 TFLOP/s f32): at qwen2-0.5b's prefill (B 4,
// H 14, KV 2, S 2048, HD 64, bf16, causal) the band is ~30 GFLOP of
// products against 33.6 MB of q/k/v/o, so operations bound it: ~30 us at
// the bf16 tensor-core rate.
//
// bf16 (flash_attention_fwd_bf16_kernel, FlashAttention-2's scheme on
// mma.sync): a block of 4 warps takes 64 query rows of one (b, h), each
// warp 16 rows, its Q slice held in registers as m16n8k16 A fragments for
// the whole loop. 64-key tiles of K and V are staged in shared memory in
// bf16 by cp.async in a ring of three, so two tiles' copies run under this
// tile's products and one barrier a tile suffices. Rows are padded by 16
// bytes, which puts the 8 rows an ldmatrix reads in 8 distinct 4-bank
// groups (conflict-free). S = Q.K^T and O += P.V are mma.sync.m16n8k16
// bf16 -> f32; m and l live per row in registers, the scores in log2 units
// so each p is one ex2 (MUFU) op, and P is rounded to bf16 in registers
// and fed straight back as the A operand of P.V: that rounding is the
// reference's p.astype(v.dtype). Per-key masks are computed only in tiles
// that cross the band's edge or kv_len. Query tiles run heaviest first
// across the whole grid (blockIdx.y walks the causal rows from the last).
// mma.sync rather than wgmma with TMA: it reaches the tensor cores with a
// warp-local register layout the online softmax works in directly;
// wgmma's warpgroup-wide accumulators, TMA descriptors and mbarrier rings
// are the next step. Tried on the card and dropped: 8 warps a block
// (slower: more warps wait at each barrier) and a register cap for more
// blocks an SM (no gain at the causal prefill).
//
// f32 (flash_attention_fwd_f32_kernel, the first design, CUDA cores; TF32
// mma would not hold the f32 tolerances): one block per (b*h, 64 query
// rows), two threads per row, each owning half of the head's dims
// (interleaved in pairs, so the two halves of a warp hit neighbouring
// banks); 32-key tiles of K and V staged in shared memory, m, l and the
// accumulator in registers; ~450 us at the 67 TFLOP/s f32 rate is its own
// ceiling at the shape above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

// ---- f32: CUDA cores ----------------------------------------------------

constexpr int kRows = 64;  // query rows per block
constexpr int kThreads = 2 * kRows;
constexpr int kKeys = 32;  // keys per shared-memory tile

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, int H, int KV, int S,
                               int kv_len, int causal, int window, float cap,
                               float scale) {
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
    qr[2 * i] = live ? q[g] : 0.0f;
    qr[2 * i + 1] = live ? q[g + 1] : 0.0f;
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
      const float p = expf(s[j] - m_new);  // p.astype(f32) is p
      l += p;
#pragma unroll
      for (int i = 0; i < kHalf / 2; ++i) {
        const float2 vv =
            *reinterpret_cast<const float2*>(&vs[j][4 * i + 2 * half]);
        acc[2 * i] = fmaf(p, vv.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(p, vv.y, acc[2 * i + 1]);
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
      o[g] = acc[2 * i] / lc;
      o[g + 1] = acc[2 * i + 1] / lc;
    }
  }
}

// ---- bf16: tensor cores (mma.sync m16n8k16) -----------------------------

constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;  // query rows per block
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcKeys = 64;   // keys per K/V tile
constexpr int kTcStages = 3;  // K/V tiles in flight
// bf16 elements per shared-memory row: HD plus 16 bytes of padding
template <int HD>
constexpr int kTcStride = HD + 8;
// kTcStages stages of a K tile and a V tile, bytes
template <int HD>
constexpr int kTcSmem = kTcStages * 2 * kTcKeys * kTcStride<HD> * 2;

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o, int H, int KV,
                                int S, int kv_len, int causal, int window,
                                float cap, float scale) {
  constexpr int kStride = kTcStride<HD>;
  constexpr int kTile = kTcKeys * kStride;  // one K or V tile, elements
  constexpr int kChunks = HD / 8;           // 16-byte chunks in a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / KV);
  const size_t q_base = static_cast<size_t>(bh) * S * HD;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S * HD;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heavy first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int tq = lane & 3;  // fragment column pair
  const int w0 = q_start + 16 * warp;  // the warp's first row
  const int r0 = w0 + g;
  const int r1 = r0 + 8;

  // the relevant key tiles, by the TPU kernel's block rule: an interval
  const int n_tiles = (S + kTcKeys - 1) / kTcKeys;
  int t_lo = n_tiles, t_hi = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int ks = t * kTcKeys;
    bool relevant = ks < kv_len;
    if (causal) relevant = relevant && ks <= q_start + kTcRows - 1;
    if (window > 0) relevant = relevant && ks + kTcKeys > q_start - window + 1;
    if (relevant) {
      t_lo = min(t_lo, t);
      t_hi = t + 1;
    }
  }

  auto load_tile = [&](int t, int stage) {
    __nv_bfloat16* sk = smem + stage * 2 * kTile;
    __nv_bfloat16* sv = sk + kTile;
    for (int i = threadIdx.x; i < kTcKeys * kChunks; i += kTcThreads) {
      const int row = i / kChunks;
      const int col = (i % kChunks) * 8;
      const int key = t * kTcKeys + row;
      const bool in = key < S;  // zero rows past S keep V finite
      const size_t src =
          kv_base + static_cast<size_t>(in ? key : 0) * HD + col;
      cp_async16(smem_addr(sk + row * kStride + col), k + src, in);
      cp_async16(smem_addr(sv + row * kStride + col), v + src, in);
    }
  };
  for (int t = t_lo; t < min(t_lo + kTcStages - 1, t_hi); ++t) {
    load_tile(t, (t - t_lo) % kTcStages);
    cp_async_commit();
  }

  // Q as A fragments: rows r0 / r1, columns 2*tq (+1) and 8 + 2*tq (+1)
  uint32_t qf[HD / 16][4];
  {
    const __nv_bfloat16* q0 = q + q_base + static_cast<size_t>(r0) * HD;
    const __nv_bfloat16* q1 = q + q_base + static_cast<size_t>(r1) * HD;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      const int c = 16 * kc + 2 * tq;
      qf[kc][0] = r0 < S ? ld_u32(q0 + c) : 0u;
      qf[kc][1] = r1 < S ? ld_u32(q1 + c) : 0u;
      qf[kc][2] = r0 < S ? ld_u32(q0 + c + 8) : 0u;
      qf[kc][3] = r1 < S ? ld_u32(q1 + c + 8) : 0u;
    }
  }

  float oacc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.0f;
  // scores in log2 units: s * log2(e), so p = 2^(s' - m') = e^(s - m)
  const float scale2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};  // rows r0, r1, log2 units
  float l[2] = {0.0f, 0.0f};        // this thread's share of the row sums

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) % kTcStages;
    if (t + 1 < t_hi)
      cp_async_wait<kTcStages - 2>();
    else
      cp_async_wait<0>();
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage the copy below refills
    __syncthreads();
    if (t + kTcStages - 1 < t_hi) {
      load_tile(t + kTcStages - 1, (stage + kTcStages - 1) % kTcStages);
      cp_async_commit();
    }
    const __nv_bfloat16* sk = smem + stage * 2 * kTile;
    const __nv_bfloat16* sv = sk + kTile;
    const int ks = t * kTcKeys;

    // S = Q.K^T: 16 rows x 64 keys per warp, eight 16x8 tiles
    float sacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        // matrices: keys 16jj + {0, 8}, dims 16kc + {0, 8}
        const int key = 16 * jj + (lane >> 4) * 8 + (lane & 7);
        const int dim = 16 * kc + ((lane >> 3) & 1) * 8;
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(sk + key * kStride + dim));
        mma_bf16(sacc[2 * jj], qf[kc], bk[0], bk[1]);
        mma_bf16(sacc[2 * jj + 1], qf[kc], bk[2], bk[3]);
      }
    }

    // scale, softcap, then the mask where the tile crosses an edge (a
    // masked score is -1e30 in log2 units too: p is exactly 0 beside any
    // live key, and 1 where a row has none yet, as in the TPU kernel)
    bool inside = ks + kTcKeys <= kv_len;
    if (causal) inside = inside && ks + kTcKeys - 1 <= w0;
    if (window > 0) inside = inside && w0 + 15 - ks < window;
    if (cap > 0.0f) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[j][e] = cap * tanhf(sacc[j][e] * scale / cap) * kLog2e;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] *= scale2;
    }
    if (!inside) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = ks + 8 * j + 2 * tq + (e & 1);
          const int row = e < 2 ? r0 : r1;
          bool ok = kpos < kv_len;
          if (causal) ok = ok && kpos <= row;
          if (window > 0) ok = ok && row - kpos < window;
          if (!ok) sacc[j][e] = kNegInf;
        }
      }
    }

    // online softmax: a row's four threads share its max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sacc[j][0], sacc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sacc[j][2], sacc[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = ex2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    // p in f32 for l; rounded to bf16 as the A fragments of P.V (keys
    // 16kc.. of tile 2kc in registers 0/1, of tile 2kc + 1 in 2/3)
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(sacc[j][0] - m[0]);
      const float p1 = ex2(sacc[j][1] - m[0]);
      const float p2 = ex2(sacc[j][2] - m[1]);
      const float p3 = ex2(sacc[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j / 2][2 * (j & 1)] = pack_bf16(p0, p1);
      pf[j / 2][2 * (j & 1) + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      oacc[d][0] *= alpha[0];
      oacc[d][1] *= alpha[0];
      oacc[d][2] *= alpha[1];
      oacc[d][3] *= alpha[1];
    }

    // O += P.V: V read transposed by ldmatrix
#pragma unroll
    for (int kc = 0; kc < kTcKeys / 16; ++kc) {
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        // matrices: keys 16kc + {0, 8}, dims 16dd + {0, 8}
        const int key = 16 * kc + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int dim = 16 * dd + (lane >> 4) * 8;
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(sv + key * kStride + dim));
        mma_bf16(oacc[2 * dd], pf[kc], bv[0], bv[1]);
        mma_bf16(oacc[2 * dd + 1], pf[kc], bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  __nv_bfloat16* o0 = o + q_base + static_cast<size_t>(r0) * HD;
  __nv_bfloat16* o1 = o + q_base + static_cast<size_t>(r1) * HD;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int c = 8 * d + 2 * tq;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o0 + c) =
          pack_bf16(oacc[d][0] / l[0], oacc[d][1] / l[0]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(o1 + c) =
          pack_bf16(oacc[d][2] / l[1], oacc[d][3] / l[1]);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int S, int kv_len, int causal, int window,
               float cap, float scale, cudaStream_t st) {
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_attention_fwd_f32_kernel<HD><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, S, kv_len,
      causal, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int S, int kv_len, int causal, int window,
                float cap, float scale, cudaStream_t st) {
  constexpr int kSmem = kTcSmem<HD>;
  auto* kernel = flash_attention_fwd_bf16_kernel<HD>;
  // above 48 KB only once the attribute is set; it is set for the current
  // device, so set it on every launch (cheap, and allowed under capture)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, KV, S, kv_len, causal, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes. dtype 0 is float (CUDA cores), 1 is bf16
// (tensor cores); cap <= 0 means no softcap; window <= 0 means global.
// One launch on `stream` (PyTorch's current stream); allocates nothing,
// does not synchronise; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head width or type that is not
// instantiated here, or H not a multiple of KV.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int H, int KV, int S, int kv_len,
                                          int hd, int causal, int window,
                                          float cap, int dtype,
                                          void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  if (dtype == 0 && hd == 64)
    return launch_f32<64>(q, k, v, o, B, H, KV, S, kv_len, causal, window,
                          cap, scale, st);
  if (dtype == 0 && hd == 128)
    return launch_f32<128>(q, k, v, o, B, H, KV, S, kv_len, causal, window,
                           cap, scale, st);
  if (dtype == 1 && hd == 64)
    return launch_bf16<64>(q, k, v, o, B, H, KV, S, kv_len, causal, window,
                           cap, scale, st);
  if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, o, B, H, KV, S, kv_len, causal, window,
                            cap, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
