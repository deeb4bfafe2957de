// Flash-attention forward (online softmax) for the LM backbones, written
// by hand for Hopper (sm_90a): bf16 on the tensor cores (mma.sync), f32 on
// the CUDA cores. The kernels, their launches and the C entry's body;
// three sources instantiate them, each at its own head widths
// (FLASH_WIDTHS): flash_attention_fwd.cu, flash_attention_fwd_more.cu and
// flash_attention_fwd_wide.cu, so that their nvcc runs share the build's
// time.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the
// pallas_call in flash_attention_bhsd).
//
// Inputs q (B, H, S, HD) and k, v (B, KV, S, HD), all float or all
// bf16, contiguous; output o (B, H, S, HD) in the same type; HD one of
// the built widths, multiples of 16 from 16 to 256. A head of another
// width reaches the kernel padded with zero columns to the next built
// width (the wrapper's head_width_for): q.k is unchanged, the scale is
// 1/sqrt of the unpadded width (scale_hd), and the padded columns of o,
// zero, are sliced off.
// Query head h reads kv head h / (H / KV) by index, so repeated KV is never
// materialised (GQA). Key j is allowed for query i iff j < kv_len, and
// j <= i when causal, and i - j < window when window > 0. The scores are
// scale * q.k in f32, then cap * tanh(s / cap) when cap > 0, then masked
// to -1e30 (the TPU kernel's order and mask value). p is rounded to v's
// type before the PV product, as the TPU kernel's p.astype(v.dtype) does,
// but at the narrowest width (below); l sums the unrounded p;
// o = acc / max(l, 1e-30). kv_len is the caller's unpadded length: the
// wrapper pads S to its block, and the padded keys
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
// Wide heads (HD > 128): the bf16 kernel's o accumulator alone is HD / 2
// registers a thread (128 at HD 256), so Q's fragments, another HD / 4,
// are read from a shared-memory copy of the block's 64 rows at each key
// tile (ldmatrix) instead of living in registers, and at HD 256 the ring
// holds two K/V tiles, not three (227 KB a block). The f32 kernel takes
// four threads a row, not two (its q and accumulator rows would not fit
// a thread's registers), and its K and V tiles take dynamic shared memory
// past 48 KB (HD > 192). HD <= 128 keeps its design and its bits.
//
// Narrow heads (HD 16, which heads of 1 to 16 columns reach): the bf16
// kernel feeds P.V with p in three bf16 parts (hi, mid, lo: about 24
// bits, f32's precision), the smallest part's product first, not with p
// rounded once. A row of so few numbers has too small a 2-norm for the
// one rounding of the p it sums: with p rounded once an H100 read row
// errors of 1.1e-2 at hd 8 and 6.9 at hd 1 against the f32 plain version
// (at hd 1 a row is one number, a sum that cancels), where the row limit
// is 6.9e-3; the parts leave o's own bf16 rounding, at most 2^-8 of a
// number. It costs the P.V products three times over at that width.
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
// rows), two threads per row (four past HD 128), each owning its share
// of the head's dims (interleaved in pairs, so the threads of a row hit
// neighbouring banks); 32-key tiles of K and V staged in shared memory,
// m, l and the accumulator in registers; ~450 us at the 67 TFLOP/s f32 rate is its own
// ceiling at the shape above.
#pragma once

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
// threads a row: two, four past HD 128
template <int HD>
constexpr int kRowThreads = HD > 128 ? 4 : 2;
template <int HD>
constexpr int kThreads = kRowThreads<HD> * kRows;
constexpr int kKeys = 32;  // keys per shared-memory tile
// the K and V tiles in dynamic shared memory past the 48 KB of static
template <int HD>
constexpr bool kF32Dynamic = 2 * kKeys * HD * sizeof(float) > 48 * 1024;

template <int HD>
__global__ void __launch_bounds__(kThreads<HD>)
flash_attention_fwd_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, int H, int KV, int S,
                               int kv_len, int causal, int window, float cap,
                               float scale) {
  constexpr int kTpr = kRowThreads<HD>;
  constexpr int kThr = kThreads<HD>;
  constexpr int kHalf = HD / kTpr;  // dims a thread owns
  float (*ks)[HD];
  float (*vs)[HD];
  if constexpr (kF32Dynamic<HD>) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    ks = reinterpret_cast<float (*)[HD]>(smem_raw);
    vs = ks + kKeys;
  } else {
    __shared__ __align__(16) float ks_tile[kKeys][HD];
    __shared__ __align__(16) float vs_tile[kKeys][HD];
    ks = ks_tile;
    vs = vs_tile;
  }

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / KV);
  const size_t q_base = static_cast<size_t>(bh) * S * HD;
  const size_t kv_base = (static_cast<size_t>(b) * KV + kvh) * S * HD;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kRows;  // heavy first
  const int row = q_start + threadIdx.x / kTpr;
  const int half = threadIdx.x % kTpr;  // the thread's share of the row
  const bool live = row < S;  // dead threads still join every barrier

  // this thread's dims: pair 2*half, 2*half+1 of every group of 2*kTpr
  float qr[kHalf];
  float acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf / 2; ++i) {
    const int d = 2 * kTpr * i + 2 * half;
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
    for (int i = threadIdx.x; i < kKeys * HD; i += kThr) {
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
        const float2 kk = *reinterpret_cast<const float2*>(
            &ks[j][2 * kTpr * i + 2 * half]);
        dot = fmaf(qr[2 * i], kk.x, dot);
        dot = fmaf(qr[2 * i + 1], kk.y, dot);
      }
      // the row's other shares
#pragma unroll
      for (int off = 1; off < kTpr; off *= 2)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
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
        const float2 vv = *reinterpret_cast<const float2*>(
            &vs[j][2 * kTpr * i + 2 * half]);
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
      const size_t g = q_base + static_cast<size_t>(row) * HD +
                       2 * kTpr * i + 2 * half;
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
// K/V tiles in flight: three, two at HD 256 (three would pass 227 KB)
template <int HD>
constexpr int kTcStages = HD > 192 ? 2 : 3;
// P to the P.V product in three bf16 parts, not rounded once: the
// narrowest width, which heads of 1 to 16 columns reach (see the head)
template <int HD>
constexpr int kPParts = HD <= 16 ? 3 : 1;
// Q's fragments from a shared-memory copy, not registers (wide heads)
template <int HD>
constexpr bool kQShared = HD > 128;
// bf16 elements per shared-memory row: HD plus 16 bytes of padding
template <int HD>
constexpr int kTcStride = HD + 8;
// kTcStages stages of a K tile and a V tile, then Q's copy, bytes
template <int HD>
constexpr int kTcSmem = kTcStages<HD> * 2 * kTcKeys * kTcStride<HD> * 2 +
                        (kQShared<HD> ? kTcRows * kTcStride<HD> * 2 : 0);

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
  constexpr int kStages = kTcStages<HD>;
  constexpr bool kQSmem = kQShared<HD>;
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
  // wide heads: the block's 64 rows of Q into shared memory after the
  // ring, their own commit group ahead of the tiles' (rows past S zero)
  __nv_bfloat16* const sq = smem + kStages * 2 * kTile;
  if constexpr (kQSmem) {
    for (int i = threadIdx.x; i < kTcRows * kChunks; i += kTcThreads) {
      const int row = i / kChunks;
      const int col = (i % kChunks) * 8;
      const bool in = q_start + row < S;
      const size_t src =
          q_base + static_cast<size_t>(in ? q_start + row : 0) * HD + col;
      cp_async16(smem_addr(sq + row * kStride + col), q + src, in);
    }
    cp_async_commit();
  }
  for (int t = t_lo; t < min(t_lo + kStages - 1, t_hi); ++t) {
    load_tile(t, (t - t_lo) % kStages);
    cp_async_commit();
  }

  // Q as A fragments: rows r0 / r1, columns 2*tq (+1) and 8 + 2*tq (+1);
  // wide heads read them from sq at each tile instead
  uint32_t qf[kQSmem ? 1 : HD / 16][4];
  if constexpr (!kQSmem) {
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
    const int stage = (t - t_lo) % kStages;
    if (t + 1 < t_hi)
      cp_async_wait<kStages - 2>();
    else
      cp_async_wait<0>();
    // tile t has landed for every thread (and Q's copy, an older group),
    // and every warp is done with tile t - 1, whose stage the copy below
    // refills
    __syncthreads();
    if (t + kStages - 1 < t_hi) {
      load_tile(t + kStages - 1, (stage + kStages - 1) % kStages);
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
      uint32_t qa[4];
      if constexpr (kQSmem) {
        // the A fragment of rows 16 warp.., columns 16kc..: matrices rows
        // + {0, 8}, columns + {0, 8}
        ldmatrix_x4(qa, smem_addr(sq + (16 * warp + (lane & 15)) * kStride +
                                  16 * kc + (lane >> 4) * 8));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kc][e];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        // matrices: keys 16jj + {0, 8}, dims 16kc + {0, 8}
        const int key = 16 * jj + (lane >> 4) * 8 + (lane & 7);
        const int dim = 16 * kc + ((lane >> 3) & 1) * 8;
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(sk + key * kStride + dim));
        mma_bf16(sacc[2 * jj], qa, bk[0], bk[1]);
        mma_bf16(sacc[2 * jj + 1], qa, bk[2], bk[3]);
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
    // 16kc.. of tile 2kc in registers 0/1, of tile 2kc + 1 in 2/3), or
    // split into kPParts such fragments, the largest part first
    constexpr int kParts = kPParts<HD>;
    uint32_t pf[kParts][4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(sacc[j][0] - m[0]);
      const float p1 = ex2(sacc[j][1] - m[0]);
      const float p2 = ex2(sacc[j][2] - m[1]);
      const float p3 = ex2(sacc[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      const int kc = j / 2, r = 2 * (j & 1);
      if constexpr (kParts == 1) {
        pf[0][kc][r] = pack_bf16(p0, p1);
        pf[0][kc][r + 1] = pack_bf16(p2, p3);
      } else {
        split3_bf16(p0, p1, pf[0][kc][r], pf[1][kc][r], pf[2][kc][r]);
        split3_bf16(p2, p3, pf[0][kc][r + 1], pf[1][kc][r + 1],
                    pf[2][kc][r + 1]);
      }
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
        // the smallest part first
#pragma unroll
        for (int part = kParts - 1; part >= 0; --part) {
          mma_bf16(oacc[2 * dd], pf[part][kc], bv[0], bv[1]);
          mma_bf16(oacc[2 * dd + 1], pf[part][kc], bv[2], bv[3]);
        }
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
  size_t smem = 0;
  if constexpr (kF32Dynamic<HD>) {
    smem = 2 * kKeys * HD * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_fwd_f32_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_attention_fwd_f32_kernel<HD><<<grid, kThreads<HD>, smem, st>>>(
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

// one of the built widths HDs, by the runtime hd and dtype; the scale is
// 1/sqrt(scale_hd), the unpadded width
template <int... HDs>
int flash_entry(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int S, int kv_len, int hd, int scale_hd,
                int causal, int window, float cap, int dtype,
                cudaStream_t st) {
  if (KV <= 0 || H % KV != 0 || scale_hd < 1 || scale_hd > hd ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(scale_hd)));
  int err = static_cast<int>(cudaErrorInvalidValue);
  ((hd == HDs && (err = dtype == 0
                            ? launch_f32<HDs>(q, k, v, o, B, H, KV, S, kv_len,
                                              causal, window, cap, scale, st)
                            : launch_bf16<HDs>(q, k, v, o, B, H, KV, S,
                                               kv_len, causal, window, cap,
                                               scale, st),
                   true)) ||
   ...);
  return err;
}

}  // namespace
