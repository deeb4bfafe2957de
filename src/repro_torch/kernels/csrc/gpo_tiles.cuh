// The tile schedule shared by the GPO attention kernels (sm_90a): the
// forward (gpo_attention_fwd.cu) and the backward's dq and dk/dv
// (gpo_attention_bwd.cu). A block of four warps owns 16 rows (queries or
// keys) held as split 3xTF32 A fragments, and streams the other side's
// rows through shared memory by cp.async, 32 rows a stage, 8 a warp, in
// a ring of stages (four, three in flight; fewer at the widest heads).
// Every product is mma.sync m16n8k8 TF32 in 3xTF32 (mma_tf32.cuh) in
// short chains whose results are added in f32; the warp partials are
// summed in warp order. Each source builds into its own library, so the
// helpers are file-local.
//
// Head widths: each kernel is instantiated at the built widths HD of
// kWidths (multiples of 8, the mma's k-step; the wrapper pads a head
// with zero columns to the next one, which adds nothing to q.k^T, and
// slices the padded columns off). Up to 64 the A fragments sit in
// registers (TileA); wider heads split them from the block's tile in
// shared memory at each use (TileS), and a block owns a slab of slab(HD)
// output columns: every slab's block recomputes the scores over the
// whole head, so the accumulators stay at 64 columns or fewer. Shared
// memory is dynamic (up to 200 KB at HD 256), the ring's depth bufs(HD).
#pragma once

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;           // rows a block owns: queries or keys
constexpr int kStage = 8 * kWarps;  // streamed rows a stage, 8 a warp
// shared-memory row pitch in floats: fragment reads hit 32 banks
__host__ __device__ constexpr int pitch(int hd) { return hd + 4; }
static_assert(kThreads == 8 * kTile, "8 threads an epilogue row");

// the built head widths; the wrapper's HEAD_WIDTHS lists the same
#define GPO_WIDTHS(X) \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(96) X(128) X(192) X(256)
// the ring's stages: four (three in flight) where they fit the 227 KB a
// block may hold, three at HD 192, two at HD 256
__host__ __device__ constexpr int bufs(int hd) {
  return hd <= 128 ? 4 : hd <= 192 ? 3 : 2;
}
// A fragments in registers (TileA) up to 64 columns, else from shared
// memory (TileS)
__host__ __device__ constexpr bool regs_a(int hd) { return hd <= 64; }
// output columns a block owns: the whole head up to 64, else slabs of 64
// (48 at HD 96)
__host__ __device__ constexpr int slab(int hd) {
  return hd <= 64 ? hd : hd % 64 == 0 ? 64 : 48;
}

// k-step ks of a 16 x HD tile in shared memory (pitch(HD)) as a split
// A fragment
template <int HD>
__device__ __forceinline__ void split_a(const float* tile, int ks, int g,
                                        int tq, uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e & 1);
    const int c = 8 * ks + tq + 4 * (e >> 1);
    split_tf32(tile[r * pitch(HD) + c], big[e], small[e]);
  }
}

// a 16 x HD tile in shared memory as split A fragments in registers, one
// per k-step of 8
template <int HD>
struct TileA {
  uint32_t big[HD / 8][4];
  uint32_t small[HD / 8][4];

  __device__ __forceinline__ void load(const float* tile, int g, int tq) {
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks)
      split_a<HD>(tile, ks, g, tq, big[ks], small[ks]);
  }
  __device__ __forceinline__ void frag(int ks, uint32_t (&b)[4],
                                       uint32_t (&s)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      b[e] = big[ks][e];
      s[e] = small[ks][e];
    }
  }
};

// the same tile left in shared memory, each k-step split where it is
// used: a wide head's fragments would not fit the registers
template <int HD>
struct TileS {
  const float* tile;
  int g, tq;

  __device__ __forceinline__ void load(const float* t, int g_, int tq_) {
    tile = t;
    g = g_;
    tq = tq_;
  }
  __device__ __forceinline__ void frag(int ks, uint32_t (&b)[4],
                                       uint32_t (&s)[4]) const {
    split_a<HD>(tile, ks, g, tq, b, s);
  }
};

template <int HD>
using Tile = typename std::conditional<regs_a(HD), TileA<HD>, TileS<HD>>::type;

// d (16 x 8) = a (16 x HD) . u^T, u 8 staged rows of HD. A tensor-core
// sum is coarser than an f32 add (it rounds toward zero), so the small
// terms share one accumulator, where its error is 2^-11 smaller, and
// each k-step's big.big starts from zero and is added in f32
template <int HD, class A>
__device__ __forceinline__ void mma_abt(float (&d)[4], const A& a,
                                        const float* u, int g, int tq) {
  constexpr int P = pitch(HD);
  float lo[4] = {};
  d[0] = d[1] = d[2] = d[3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks) {
    uint32_t ab[4], as[4], bb[2], bs[2];
    a.frag(ks, ab, as);
    split_tf32(u[g * P + 8 * ks + tq], bb[0], bs[0]);
    split_tf32(u[g * P + 8 * ks + tq + 4], bb[1], bs[1]);
    mma_tf32(lo, as, bb[0], bb[1]);
    mma_tf32(lo, ab, bs[0], bs[1]);
    float hi[4] = {};
    mma_tf32(hi, ab, bb[0], bb[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += hi[e];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += lo[e];
}

// acc (16 x VW, one accumulator per 8 columns) += c . u, c a 16 x 8
// accumulator tile over the 8 staged rows u (rows of pitch(HD), VW
// columns read from u on): k = tq reads row 2 tq, k = tq + 4 row 2 tq + 1
// (a_from_acc). Each product starts from zero and is added to acc in f32
// (see mma_abt)
template <int HD, int VW>
__device__ __forceinline__ void mma_acc_u(float (&acc)[VW / 8][4],
                                          const float (&c)[4], const float* u,
                                          int g, int tq) {
  constexpr int P = pitch(HD);
  uint32_t ab[4], as[4];
  a_from_acc(c, ab, as);
#pragma unroll
  for (int nt = 0; nt < VW / 8; ++nt) {
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

// the warp partials (kWarps tiles of 16 x VW at pitch(HD)) of
// accumulator tiles, written by each warp
template <int HD, int VW>
__device__ __forceinline__ void store_partial(float* part,
                                              const float (&acc)[VW / 8][4],
                                              int w, int g, int tq) {
  constexpr int P = pitch(HD);
#pragma unroll
  for (int nt = 0; nt < VW / 8; ++nt) {
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

// a kernel's dynamic shared memory, allowed past the 48 KB default, then
// the launch; returns cudaGetLastError()
template <class K, class... Args>
int launch_dyn(K kernel, dim3 grid, size_t smem, cudaStream_t st,
               Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// cp.async copies 16 bytes: every (S, HD) slab must start 16-byte aligned
bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace
