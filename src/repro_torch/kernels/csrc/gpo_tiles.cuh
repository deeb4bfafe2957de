// The tile schedule shared by the GPO attention kernels (sm_90a): the
// forward (gpo_attention_fwd.cu) and the backward's dq and dk/dv
// (gpo_attention_bwd.cu). A block of four warps owns 16 rows (queries or
// keys) held as split 3xTF32 A fragments, and streams the other side's
// rows through shared memory by cp.async, 32 rows a stage, 8 a warp, in
// a ring of four stages with three in flight. Every product is mma.sync
// m16n8k8 TF32 in 3xTF32 (mma_tf32.cuh) in short chains whose results
// are added in f32; the warp partials are summed in warp order. Each
// source builds into its own library, so the helpers are file-local.
#pragma once

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;           // rows a block owns: queries or keys
constexpr int kStage = 8 * kWarps;  // streamed rows a stage, 8 a warp
constexpr int kBufs = 4;            // a ring of stages, 3 ahead in flight
// shared-memory row pitch in floats: fragment reads hit 32 banks
__host__ __device__ constexpr int pitch(int hd) { return hd + 4; }
static_assert(kThreads == 8 * kTile, "8 threads an epilogue row");

// a 16 x HD tile in shared memory (pitch(HD)) as split A fragments, one
// per k-step of 8
template <int HD>
struct TileA {
  uint32_t big[HD / 8][4];
  uint32_t small[HD / 8][4];

  __device__ __forceinline__ void load(const float* tile, int g, int tq) {
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e & 1);
        const int c = 8 * ks + tq + 4 * (e >> 1);
        split_tf32(tile[r * pitch(HD) + c], big[ks][e], small[ks][e]);
      }
    }
  }
};

// d (16 x 8) = a (16 x HD) . u^T, u 8 staged rows of HD. A tensor-core
// sum is coarser than an f32 add (it rounds toward zero), so the small
// terms share one accumulator, where its error is 2^-11 smaller, and
// each k-step's big.big starts from zero and is added in f32
template <int HD>
__device__ __forceinline__ void mma_abt(float (&d)[4], const TileA<HD>& a,
                                        const float* u, int g, int tq) {
  constexpr int P = pitch(HD);
  float lo[4] = {};
  d[0] = d[1] = d[2] = d[3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks) {
    uint32_t bb[2], bs[2];
    split_tf32(u[g * P + 8 * ks + tq], bb[0], bs[0]);
    split_tf32(u[g * P + 8 * ks + tq + 4], bb[1], bs[1]);
    mma_tf32(lo, a.small[ks], bb[0], bb[1]);
    mma_tf32(lo, a.big[ks], bs[0], bs[1]);
    float hi[4] = {};
    mma_tf32(hi, a.big[ks], bb[0], bb[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += hi[e];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += lo[e];
}

// acc (16 x HD, one accumulator per 8 columns) += c . u, c a 16 x 8
// accumulator tile over the 8 staged rows u (HD wide): k = tq reads row
// 2 tq, k = tq + 4 row 2 tq + 1 (a_from_acc). Each product starts from
// zero and is added to acc in f32 (see mma_abt)
template <int HD>
__device__ __forceinline__ void mma_acc_u(float (&acc)[HD / 8][4],
                                          const float (&c)[4], const float* u,
                                          int g, int tq) {
  constexpr int P = pitch(HD);
  uint32_t ab[4], as[4];
  a_from_acc(c, ab, as);
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    uint32_t bb[2], bs[2];
    split_tf32(u[2 * tq * P + 8 * nt + g], bb[0], bs[0]);
    split_tf32(u[(2 * tq + 1) * P + 8 * nt + g], bb[1], bs[1]);
    float t[4] = {};
    mma_3xtf32(t, ab, as, bb, bs);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += t[e];
  }
}

// rows [r0, r0 + ROWS) of one bh's (S, HD) slab into shared memory at
// pitch(HD), 16 bytes a copy, zero-filled from row `end` on
template <int HD, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int r0, int end) {
  constexpr int kVec = HD / 4;
#pragma unroll
  for (int n = 0; n < (ROWS * kVec + kThreads - 1) / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    if (i >= ROWS * kVec) break;
    const int r = i / kVec;
    const int c = 4 * (i % kVec);
    const bool live = r0 + r < end;
    cp_async16(smem_addr(dst + r * pitch(HD) + c),
               src + static_cast<size_t>(live ? r0 + r : 0) * HD + c, live);
  }
}

// the warp partials (kWarps tiles of 16 x HD at pitch(HD)) of
// accumulator tiles, written by each warp
template <int HD>
__device__ __forceinline__ void store_partial(float* part,
                                              const float (&acc)[HD / 8][4],
                                              int w, int g, int tq) {
  constexpr int P = pitch(HD);
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(w * kTile + g + 8 * (e >> 1)) * P + 8 * nt + 2 * tq + (e & 1)] =
          acc[nt][e];
  }
}

// row r, column c of the tile, summed over the warp partials in warp
// order
template <int HD>
__device__ __forceinline__ float sum_partials(const float* part, int r,
                                              int c) {
  float x = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) x += part[(w * kTile + r) * pitch(HD) + c];
  return x;
}

float softmax_scale(int hd) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
}

// cp.async copies 16 bytes: every (S, HD) slab must start 16-byte aligned
bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace
