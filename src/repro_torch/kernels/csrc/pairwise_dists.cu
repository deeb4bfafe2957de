// Pairwise squared L2 distances between the clients' raveled deltas, the
// Krum / multi-Krum selection metric, written by hand for Hopper
// (sm_90a):
//   out[i, j] = max(G_ii + G_jj - 2 G_ij, 0),  G = X X^T.
//
// Replaces: src/repro/kernels/agg_reduce.py::_pairwise_kernel (the
// pallas_call in pairwise_dists_flat). That kernel accumulates the
// expansion over P tiles, the Gram part as one MXU product jnp.dot(x,
// x.T), into one (C, C) output block that stays resident across a
// sequential grid. CUDA blocks run in no order, so here the work is two
// launches and no atomics (two calls are bit-equal, and Krum's argmin
// cannot flip between runs):
//   1. gram_partial_kernel: block b owns columns [b kChunk, (b + 1)
//      kChunk) (a split that depends on P alone) and writes its partial
//      Gram G_b (upper triangle, diagonal included) to part[b] in f64;
//   2. gram_finish_kernel: one warp per pair i <= j sums part[:, i, j],
//      part[:, i, i] and part[:, j, j] in f64 in one fixed order (lane l
//      takes blocks l, l + 32, ..., all its loads in flight, then a
//      butterfly), forms d from G's own diagonal, clamps at 0 as
//      jnp.maximum(out, 0.0) does and writes (i, j) and (j, i) from one
//      value: the diagonal is exactly 0 and the output exactly
//      symmetric.
//
// Bound on the H100: bytes. The kernel reads x once: 4 C P bytes, 21.4 MB
// at the quickstart's (C, P) = (10, 534016), about 6.4 us at 3.35 TB/s;
// the C (C + 1) / 2 dot products (2.9e7 FMAs) are far under the card's
// rate. Measured times: PERF.md section 6, row 11.
//
// Design: a block's columns stream through a ring of kStages
// shared-memory stages, all C rows (cp.async, 16-byte copies when the
// rows start 16-byte aligned).
// The product G_b = X_b X_b^T runs on the tensor cores, mma.sync m16n8k8
// TF32, the rows padded with zeros (in registers) to R = 16 (C <= 16) or
// 32: A (rows g, g + 8 of a 16-row tile) and B (B[k][n] = X[n][k]) read
// the same row-major tile. Each of the 16 warps takes every 16th k-step
// of 8 columns, kSteps of them a stage (4 at R = 16, 2 at R = 32). The
// split of an f32 value x keeps the sums exact where the tensor cores
// would bias them:
//   big = x rounded to its row's grid over the warp's k-steps of the
//         stage, 2^(e - 9) with 2^e > their max |x| of the row (a quad's
//         max by two shuffles): 10 significant bits at most, a TF32
//         value, and every big of the row a multiple of the same step;
//   small = x - big, exact in f32, which the tensor cores truncate to
//         TF32 (~2^-10 of itself, |small| <= half a step).
// big.big's products are then exact multiples of one quantum, at most
// 2^18 of it, and the warp's 32 of them a stage sum to under 2^23: the
// chained sum hi (16x8 tiles on or above the diagonal) is exact, and the
// tensor cores' rounding toward zero never touches it. The three small
// terms come from one product and its transpose, L = small (big +
// small / 2)^T, chained as small.big and small.(small / 2) (exact halves)
// over every tile: L + L^T = small.big^T + big.small^T + small.small^T,
// 2^-9 of hi, where that rounding costs ~2^-33 of the stage. hi and L
// start from zero each stage and go into the warp's f32 sums; the
// block's G_b = hi + (L + L^T) adds the warps in warp order in f64. Three
// products a k-step and tile where the split's four are. The per-value
// 3xTF32 split (mma_tf32.cuh's split_tf32 and mma_3xtf32, small.small
// dropped, each k-step from zero) leaves each k-step of a row's own sum
// of squares rounded toward zero, a bias of ~2^-24 of G_ii that reads
// above the plain f32 expansion form's error against float64
// (chip_smoke.py phase 1 prints both).
//
// Inputs x (C, P) f32 contiguous; scratch part (nb, C, C) f64 and output
// (C, C) f32, allocated by the wrapper. C <= kMaxClients.
//
// Past 32 clients the rows no longer fit one
// block's Gram: gram_tile_kernel tiles G into 32-row tiles and gives
// each block one chunk of columns and one pair of tiles I <= J, whose
// 64 rows (32 on the diagonal) stream through a ring of kTStages stages
// of kTCols columns. Every value takes the same split on its row's grid
// over the warp's k-steps of the stage (grid_split), so hi = big_I.big_J^T
// is exact as above; the small terms are three products chained from
// zero each stage, small_I.big_J^T + big_I.small_J^T + small_I.small_J^T
// (the L + L^T form needs one symmetric tile). A diagonal block computes
// the tiles on or above the diagonal. The block writes its entries i <=
// j of G_b in f64, and the finish launch above forms d. The column split
// depends on (C, P): chunk columns a block, a multiple of kTCols of at
// least kChunk, chosen by the wrapper so that the (nb, C, C) f64
// partials stay within a fixed budget (256 MiB: nb <= 32 at C = 1024)
// while one partial fits it (C <= 5792); past that, nb = 1, one chunk of
// every column, and the partial is twice the (C, C) f32 output: device
// memory is the only limit on C. The tile pairs run along grid.y and
// grid.z (65535 of them a row of the grid).
// Bound on the H100 at C = 1024, P = 534016: 2.2 GB read once, 0.65 us
// at 3.35 TB/s; the C (C + 1) / 2 dot products, 5.6e14 FMA-equivalent
// f32 operations, set the bound (chip_smoke.py phase 5). Each block reads
// its rows of the chunk once from device memory or L2: the rows are read
// about C / 32 times in all.
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kWarps = kThreads / 32;
// columns of a stage: 512 (64 k-steps, 4 a warp) for the 16-row Gram,
// 256 for the 32-row one, so that a ring of kStages stages of every
// client row stays within a block's shared memory (132 KB at C = 16 or
// 32) and holds about 60 KB in flight at C = 10 (deeper rings read no
// faster: loads alone take ~10.5 us with 3 to 8 stages)
template <int R>
__host__ __device__ constexpr int stage_cols() { return R == 16 ? 512 : 256; }
// a row of a stage, padded so that the eight rows g of a fragment load
// fall in distinct banks (stride = 4 mod 32)
template <int R>
__host__ __device__ constexpr int stage_stride() { return stage_cols<R>() + 4; }
constexpr int kStages = 4;
constexpr long long kChunk = 4096;  // columns a block
constexpr int kMaxClients = 32;
// the tiled design past kMaxClients: 8 warps, 2 k-steps a warp a stage,
// so 128 columns a stage, a ring of 3 stages of 64 rows (101 KB)
constexpr int kTThreads = 256;
constexpr int kTWarps = kTThreads / 32;
constexpr int kTSteps = 2;
constexpr int kTCols = 8 * kTSteps * kTWarps;
constexpr int kTStride = kTCols + 4;  // = 4 mod 32, as stage_stride
constexpr int kTStages = 3;
constexpr unsigned kGridRow = 65535;  // tile pairs a row of grid.y

// the 16x8 output tiles (m, n) of an R x R matrix, t = 4 m + n: all of
// them for L (2 at R = 16, 8 at R = 32), those on or above the diagonal
// (n >= 2 m) for hi
template <int R>
__host__ __device__ constexpr int num_tiles() { return R == 16 ? 2 : 8; }
__host__ __device__ constexpr bool upper(int t) { return t % 4 >= 2 * (t / 4); }

template <int R>
size_t smem_bytes(int C) {
  // the ring of C rows a stage, then the warps' (R, R) hi and L sums in
  // its place
  const size_t ring = sizeof(float) * kStages * C * stage_stride<R>();
  const size_t red = sizeof(float) * 2 * kWarps * R * R;
  return ring > red ? ring : red;
}

// Lane (g, tq)'s n pairs of values v[k][0..1] of row g (columns tq and
// tq + 4 of the warp's k-steps in a stage) -> their big and small parts
// on the row's grid there, 2^(e - 9) with 2^e above the quad's max |v|,
// and small / 2; called by the whole warp.
template <int N>
__device__ __forceinline__ void grid_split(const float (&v)[N][2],
                                           uint32_t (&big)[N][2],
                                           uint32_t (&small)[N][2],
                                           uint32_t (&half)[N][2]) {
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k)
    m = fmaxf(m, fmaxf(fabsf(v[k][0]), fabsf(v[k][1])));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  // e = m's biased exponent - 126, clamped so that the step and its
  // inverse stay normal
  const int q =
      min(max(static_cast<int>(__float_as_uint(m) >> 23) - 135, -116), 117);
  const float step = __uint_as_float(static_cast<uint32_t>(q + 127) << 23);
  const float inv = __uint_as_float(static_cast<uint32_t>(127 - q) << 23);
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = __fmul_rn(rintf(__fmul_rn(v[k][e], inv)), step);
      const float sm = __fsub_rn(v[k][e], b);
      big[k][e] = __float_as_uint(b);
      small[k][e] = __float_as_uint(sm);
      half[k][e] = __float_as_uint(__fmul_rn(sm, 0.5f));
    }
}

// G[e] for the entries e of `es` (-1: none), each sum_b part[b][e] in
// f64, lane l taking blocks l, l + 32, ... in order (kBatch of them a
// round, all loads in flight), then a butterfly; every lane gets the
// values.
template <int N>
__device__ __forceinline__ void gram_entries(const double* part,
                                             long long cc, int nb,
                                             const long long (&es)[N],
                                             double (&g)[N]) {
  constexpr int kBatch = 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < N; ++k) g[k] = 0.0;
  for (int b0 = lane; b0 < nb; b0 += 32 * kBatch) {
    double v[kBatch][N];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int b = b0 + 32 * j;
        v[j][k] = b < nb && es[k] >= 0
                      ? __ldg(part + static_cast<long long>(b) * cc + es[k])
                      : 0.0;
      }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int k = 0; k < N; ++k) g[k] = __dadd_rn(g[k], v[j][k]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
#pragma unroll
    for (int k = 0; k < N; ++k)
      g[k] = __dadd_rn(g[k], __shfl_xor_sync(0xffffffffu, g[k], off));
}

template <int R, bool kVec>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ x, double* __restrict__ part,
                    int C, long long P) {
  constexpr int kTiles = num_tiles<R>();
  constexpr int kGroups = R / 8;  // row groups of 8
  constexpr int kCols = stage_cols<R>(), kStride = stage_stride<R>();
  constexpr int kSteps = kCols / 8 / kWarps;  // k-steps a warp a stage
  extern __shared__ __align__(16) float smem[];  // [kStages][C][kStride]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = base + kChunk < P ? base + kChunk : P;
  const int nst = static_cast<int>((end - base + kCols - 1) / kCols);

  // stage s's columns of rows 0..C-1; past `end` zero-filled
  auto load_stage = [&](int s) {
    constexpr int V = kVec ? 4 : 1, kPacks = kCols / V;
    float* dst = smem + (s % kStages) * C * kStride;
    const long long c0 = base + static_cast<long long>(s) * kCols;
    for (int i = threadIdx.x; i < C * kPacks; i += kThreads) {
      const int r = i / kPacks, k = i % kPacks;
      const long long col = c0 + k * V;
      const bool in = col < end;  // with kVec, end - base is a multiple of 4
      const float* src = in ? x + r * P + col : x;
      const uint32_t at = smem_addr(dst + r * kStride + k * V);
      if (kVec)
        cp_async16(at, src, in);
      else
        cp_async4(at, src, in);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }
  float acc_hi[kTiles][4] = {}, acc_l[kTiles][4] = {};
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; stage s - 1's slot is free
    if (s + kStages - 1 < nst) load_stage(s + kStages - 1);
    cp_async_commit();
    const float* tile = smem + (s % kStages) * C * kStride;
    // the warp's k-steps kk kWarps + warp of this stage, each row group's
    // values split on one grid (rows C..R-1 are zeros, never stored)
    uint32_t big[kGroups][kSteps][2], small[kGroups][kSteps][2],
        half[kGroups][kSteps][2];
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      const int r = 8 * h + g;
      float v[kSteps][2];
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const float* at = tile + r * kStride + (kk * kWarps + warp) * 8 + tq;
        v[kk][0] = r < C ? at[0] : 0.0f;
        v[kk][1] = r < C ? at[4] : 0.0f;
      }
      grid_split(v, big[h], small[h], half[h]);
    }
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const int m = t / 4, n = t % 4;
      if (8 * n >= C) continue;  // all padding (the warp agrees)
      // hi: big.big over the warp's k-steps, exact (see above); L: small
      // against big + small / 2; both from zero each stage
      float hi[4] = {}, l[4] = {};
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        // A's a0..a3: (g, tq), (g + 8, tq), (g, tq + 4), (g + 8, tq + 4)
        // of rows 16 m..; B's b0, b1: rows tq, tq + 4 of column g = X's
        // row 8 n + g at those columns
        const uint32_t as[4] = {small[2 * m][kk][0], small[2 * m + 1][kk][0],
                                small[2 * m][kk][1], small[2 * m + 1][kk][1]};
        if (upper(t)) {
          const uint32_t ab[4] = {big[2 * m][kk][0], big[2 * m + 1][kk][0],
                                  big[2 * m][kk][1], big[2 * m + 1][kk][1]};
          mma_tf32(hi, ab, big[n][kk][0], big[n][kk][1]);
        }
        mma_tf32(l, as, big[n][kk][0], big[n][kk][1]);
        mma_tf32(l, as, half[n][kk][0], half[n][kk][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_hi[t][e] = __fadd_rn(acc_hi[t][e], hi[e]);
        acc_l[t][e] = __fadd_rn(acc_l[t][e], l[e]);
      }
    }
  }

  // the block's G_b: the warps' hi_ij + (L_ij + L_ji), in warp order, in
  // f64
  cp_async_wait<0>();
  __syncthreads();
  float* red_hi = smem;                // [kWarps][R][R]
  float* red_l = smem + kWarps * R * R;  // [kWarps][R][R]
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int m = t / 4, n = t % 4;
    if (8 * n >= C) continue;
    const int o = (warp * R + 16 * m + g) * R + 8 * n + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = o + (e / 2) * 8 * R + e % 2;
      if (upper(t)) red_hi[at] = acc_hi[t][e];
      red_l[at] = acc_l[t][e];
    }
  }
  __syncthreads();
  const int cc = C * C;
  for (int e = threadIdx.x; e < cc; e += kThreads) {
    const int i = e / C, j = e % C;
    if (i > j) continue;  // the upper triangle is what the finish reads
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      const double l = __dadd_rn(red_l[(w * R + i) * R + j],
                                 red_l[(w * R + j) * R + i]);
      s = __dadd_rn(s, __dadd_rn(red_hi[(w * R + i) * R + j], l));
    }
    part[static_cast<long long>(blockIdx.x) * cc + e] = s;
  }
}

// one chunk of columns of one 32 x 32 Gram tile pair (I, J), I <= J: the
// block's entries i <= j of G_b, in f64, into part[b]
template <bool kVec>
__global__ void __launch_bounds__(kTThreads)
gram_tile_kernel(const float* __restrict__ x, double* __restrict__ part,
                 int C, long long P, long long chunk) {
  // [kTStages][64][kTStride]: rows 0..31 tile I, 32..63 tile J (unused
  // on the diagonal, where B reads I's rows)
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  // pair u = (I, J) in row-major order
  long long u = static_cast<long long>(blockIdx.z) * kGridRow + blockIdx.y;
  const int T = (C + 31) / 32;
  if (u >= static_cast<long long>(T) * (T + 1) / 2) return;
  int I = 0;
  for (; u >= T - I; ++I) u -= T - I;
  const int J = I + static_cast<int>(u);
  const bool diag = I == J;
  const int slots = diag ? 32 : 64;
  const int b_row = diag ? 0 : 32;  // J's first row in a stage
  const long long base = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = base + chunk < P ? base + chunk : P;
  const int nst = static_cast<int>((end - base + kTCols - 1) / kTCols);

  auto row_of = [&](int slot) {  // slot -> client row (>= C: none)
    return slot < 32 ? 32 * I + slot : 32 * J + slot - 32;
  };
  auto load_stage = [&](int s) {
    constexpr int V = kVec ? 4 : 1, kPacks = kTCols / V;
    float* dst = smem + (s % kTStages) * 64 * kTStride;
    const long long c0 = base + static_cast<long long>(s) * kTCols;
    for (int i = threadIdx.x; i < slots * kPacks; i += kTThreads) {
      const int slot = i / kPacks, k = i % kPacks;
      const int r = row_of(slot);
      if (r >= C) continue;
      const long long col = c0 + k * V;
      const bool in = col < end;
      const float* src = in ? x + static_cast<long long>(r) * P + col : x;
      const uint32_t at = smem_addr(dst + slot * kTStride + k * V);
      if (kVec)
        cp_async16(at, src, in);
      else
        cp_async4(at, src, in);
    }
  };

  for (int s = 0; s < kTStages - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }
  float acc_hi[8][4] = {}, acc_lo[8][4] = {};
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kTStages - 2>();
    __syncthreads();  // stage s landed; stage s - 1's slot is free
    if (s + kTStages - 1 < nst) load_stage(s + kTStages - 1);
    cp_async_commit();
    const float* tile = smem + (s % kTStages) * 64 * kTStride;
    // each row group's values of the warp's k-steps, split on the row's
    // grid; rows past C are zeros, never loaded
    uint32_t bI[4][kTSteps][2], sI[4][kTSteps][2], bJ[4][kTSteps][2],
        sJ[4][kTSteps][2], unused[kTSteps][2];
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      if (diag && h >= 4) break;
      const int slot = (h < 4 ? 0 : b_row) + 8 * (h % 4) + g;
      const bool live = row_of(slot) < C;
      float v[kTSteps][2];
#pragma unroll
      for (int kk = 0; kk < kTSteps; ++kk) {
        const float* at =
            tile + slot * kTStride + (kk * kTWarps + warp) * 8 + tq;
        v[kk][0] = live ? at[0] : 0.0f;
        v[kk][1] = live ? at[4] : 0.0f;
      }
      if (h < 4)
        grid_split(v, bI[h], sI[h], unused);
      else
        grid_split(v, bJ[h - 4], sJ[h - 4], unused);
    }
    if (diag) {
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int kk = 0; kk < kTSteps; ++kk)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bJ[h][kk][e] = bI[h][kk][e];
            sJ[h][kk][e] = sI[h][kk][e];
          }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int m = t / 4, n = t % 4;
      // all padding, or below a diagonal block's diagonal (warp-uniform)
      if (32 * I + 16 * m >= C || 32 * J + 8 * n >= C) continue;
      if (diag && !upper(t)) continue;
      float hi[4] = {}, lo[4] = {};
#pragma unroll
      for (int kk = 0; kk < kTSteps; ++kk) {
        const uint32_t ab[4] = {bI[2 * m][kk][0], bI[2 * m + 1][kk][0],
                                bI[2 * m][kk][1], bI[2 * m + 1][kk][1]};
        const uint32_t as[4] = {sI[2 * m][kk][0], sI[2 * m + 1][kk][0],
                                sI[2 * m][kk][1], sI[2 * m + 1][kk][1]};
        mma_tf32(hi, ab, bJ[n][kk][0], bJ[n][kk][1]);
        mma_tf32(lo, as, bJ[n][kk][0], bJ[n][kk][1]);
        mma_tf32(lo, ab, sJ[n][kk][0], sJ[n][kk][1]);
        mma_tf32(lo, as, sJ[n][kk][0], sJ[n][kk][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_hi[t][e] = __fadd_rn(acc_hi[t][e], hi[e]);
        acc_lo[t][e] = __fadd_rn(acc_lo[t][e], lo[e]);
      }
    }
  }

  // the block's G_b: the warps' hi + lo, in warp order, in f64
  cp_async_wait<0>();
  __syncthreads();
  float* red_hi = smem;                   // [kTWarps][32][32]
  float* red_lo = smem + kTWarps * 1024;  // [kTWarps][32][32]
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int m = t / 4, n = t % 4;
    if (32 * I + 16 * m >= C || 32 * J + 8 * n >= C) continue;
    if (diag && !upper(t)) continue;
    const int o = (warp * 32 + 16 * m + g) * 32 + 8 * n + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = o + (e / 2) * 8 * 32 + e % 2;
      red_hi[at] = acc_hi[t][e];
      red_lo[at] = acc_lo[t][e];
    }
  }
  __syncthreads();
  const long long cc = static_cast<long long>(C) * C;
  for (int e = threadIdx.x; e < 1024; e += kTThreads) {
    const int il = e / 32, jl = e % 32;
    const int i = 32 * I + il, j = 32 * J + jl;
    if (i >= C || j >= C || (diag && il > jl)) continue;
    double s = 0.0;
    for (int w = 0; w < kTWarps; ++w)
      s = __dadd_rn(s, __dadd_rn(red_hi[w * 1024 + e], red_lo[w * 1024 + e]));
    part[static_cast<long long>(blockIdx.x) * cc +
         static_cast<long long>(i) * C + j] = s;
  }
}

// one warp per pair i <= j: G_ii, G_jj and G_ij from every block's
// partial in one fixed order (an entry gets the same bits in every warp),
// then d from G's own diagonal, written at (i, j) and (j, i)
__global__ void __launch_bounds__(256)
gram_finish_kernel(const double* __restrict__ part, float* __restrict__ out,
                   int C, int nb) {
  long long u = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const long long n = C;
  if (u >= n * (n + 1) / 2) return;  // the whole warp leaves together
  // pair u = (i, j), i <= j, in row-major upper-triangle order: the row
  // from the closed form (its guess corrected by a step at most), then
  // the column; the same pair the walk over the rows gives
  long long i = static_cast<long long>(
      (2.0 * n + 1.0 - sqrt((2.0 * n + 1.0) * (2.0 * n + 1.0) - 8.0 * u)) /
      2.0);
  auto first = [&](long long r) { return r * n - r * (r - 1) / 2; };
  if (i < 0) i = 0;
  while (i > 0 && first(i) > u) --i;
  while (i + 1 < n && first(i + 1) <= u) ++i;
  const long long j = i + (u - first(i));
  double g[3];  // G_ii, G_jj, G_ij
  gram_entries(part, n * n, nb, {i * n + i, j * n + j, i * n + j}, g);
  const double d = __dsub_rn(__dadd_rn(g[0], g[1]), __dmul_rn(2.0, g[2]));
  if (threadIdx.x % 32 == 0) {
    const float v = static_cast<float>(d > 0.0 ? d : 0.0);
    out[i * n + j] = v;
    out[j * n + i] = v;
  }
}

template <int R, bool kVec>
int launch_partial(const float* x, double* part, int C, long long P, int nb,
                   cudaStream_t st) {
  const auto kern = gram_partial_kernel<R, kVec>;
  const size_t smem = smem_bytes<R>(C);
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err != 0) return err;
  kern<<<static_cast<unsigned>(nb), kThreads, smem, st>>>(x, part, C, P);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_tiles(const float* x, double* part, int C, long long P, int nb,
                 long long chunk, cudaStream_t st) {
  const auto kern = gram_tile_kernel<kVec>;
  const size_t smem = sizeof(float) * kTStages * 64 * kTStride;
  static_assert(sizeof(float) * kTStages * 64 * kTStride >=
                    sizeof(float) * 2 * kTWarps * 1024,
                "the warp sums overflow the ring");
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err != 0) return err;
  const long long tiles = (C + 31) / 32;
  const long long pairs = tiles * (tiles + 1) / 2;
  const unsigned rows =
      static_cast<unsigned>((pairs + kGridRow - 1) / kGridRow);
  const dim3 grid(static_cast<unsigned>(nb),
                  rows > 1 ? kGridRow : static_cast<unsigned>(pairs), rows);
  kern<<<grid, kTThreads, smem, st>>>(x, part, C, P, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes: both launches on `stream` (PyTorch's current
// stream). part holds nb * C * C doubles, nb = ceil(P / kChunk), which the
// wrapper computes from the same chunk (4096 columns) and passes for a
// check. Allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a C above the cap or a
// scratch of another size.
extern "C" int pairwise_dists_launch(const float* x, double* part, float* out,
                                     int C, long long P, long long nb,
                                     void* stream) {
  if (C < 1 || C > kMaxClients || P < 1 || nb != (P + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int n = static_cast<int>(nb);
  int err;
  if (C <= 16)
    err = vec ? launch_partial<16, true>(x, part, C, P, n, st)
              : launch_partial<16, false>(x, part, C, P, n, st);
  else
    err = vec ? launch_partial<32, true>(x, part, C, P, n, st)
              : launch_partial<32, false>(x, part, C, P, n, st);
  if (err != 0) return err;
  const int pairs = C * (C + 1) / 2;
  gram_finish_kernel<<<(pairs + 7) / 8, 256, 0, st>>>(part, out, C, n);
  return static_cast<int>(cudaGetLastError());
}

// C entry of the tiled design, C >= 33: both launches on
// `stream`. part holds nb * C * C doubles, nb = ceil(P / chunk), chunk a
// multiple of kTCols of at least kChunk (the wrapper's pairwise_split).
// Allocates nothing, does not synchronise; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a C outside the design's range or a split or
// scratch of another size.
extern "C" int pairwise_tiles_launch(const float* x, double* part,
                                     float* out, int C, long long P,
                                     long long nb, long long chunk,
                                     void* stream) {
  if (C <= kMaxClients || P < 1 || chunk < kChunk ||
      chunk % kTCols != 0 || nb != (P + chunk - 1) / chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int n = static_cast<int>(nb);
  const int err = vec ? launch_tiles<true>(x, part, C, P, n, chunk, st)
                      : launch_tiles<false>(x, part, C, P, n, chunk, st);
  if (err != 0) return err;
  const long long pairs = static_cast<long long>(C) * (C + 1) / 2;
  gram_finish_kernel<<<static_cast<unsigned>((pairs + 7) / 8), 256, 0, st>>>(
      part, out, C, n);
  return static_cast<int>(cudaGetLastError());
}
