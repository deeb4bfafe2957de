// Per-client reductions over the raveled (C, P) client-delta matrix,
// shared by the DP clip kernel (clip_reduce.cu) and the quantized
// transport kernel (quant_clip_reduce.cu).
//
// The TPU kernels keep a (C, 1) accumulator in scratch memory across a
// sequential (sweeps, blocks) grid: the squared norms in one sweep, the
// absmax in the next, each finished before the sweep that consumes it.
// CUDA blocks run in no order, so here a reduction over P is two steps,
// never relying on the grid's order and without atomics:
//   1. a partial kernel on a (nb, C) grid: block (b, c) reduces columns
//      [b kChunk, (b + 1) kChunk) of row c and writes part[b C + c];
//   2. the consumer finishes row c from its nb partials with one warp
//      (lane l takes blocks l, l + 32, ... in order, then a fixed
//      butterfly), inside its own prologue. Every block that finishes a
//      row runs the same code on the same partials, so all of them get
//      the same bits, and two calls are bit-equal.
// The released value (clip scale, noise, residual) is built with the
// _rn intrinsics, so nvcc contracts nothing into an FMA: the op order is
// the TPU kernel's (and the plain version's), one rounding per op.
#pragma once

#include <cuda_runtime.h>

namespace client_rows {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
// columns of one row reduced by one partial block: 66 blocks a row at
// the quickstart's P = 534016, so 660 partial blocks for 10 clients
constexpr long long kChunk = 8192;
// columns per thread of the column-parallel kernels (strided by the
// block, so each warp's loads stay coalesced): 1024 columns a block
constexpr int kCols = 4;
// rows (clients) a call may hold: the consumers keep two floats a row in
// shared memory (32 KB at the cap, under the 48 KB a block gets without
// opting in)
constexpr int kMaxRows = 4096;
constexpr long long kBlockCols = static_cast<long long>(kThreads) * kCols;

// the TPU kernels' floors (repro/kernels/agg_reduce.py): zero deltas
// keep scale 1, an all-zero client quantizes to exact zeros
constexpr float kNormFloor = 1e-12f;
constexpr float kInt8Levels = 127.0f;
constexpr float kScaleFloor = 1e-30f;

inline long long num_chunks(long long P) { return (P + kChunk - 1) / kChunk; }

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ float warp_max(float s) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// Row c's total from its nb partials part[b C + c]; called by a whole
// warp, the result in every lane.
__device__ __forceinline__ float finish_sum(const float* __restrict__ part,
                                            int nb, int C, int c) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int b = lane; b < nb; b += 32)
    s += __ldg(part + static_cast<long long>(b) * C + c);
  return warp_sum(s);
}

__device__ __forceinline__ float finish_max(const float* __restrict__ part,
                                            int nb, int C, int c) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f;  // absolute values: 0 is the identity
  for (int b = lane; b < nb; b += 32)
    s = fmaxf(s, __ldg(part + static_cast<long long>(b) * C + c));
  return warp_max(s);
}

// min(1, clip / max(sqrt(sq), 1e-12)) with an IEEE square root and
// division, as the plain version computes it
__device__ __forceinline__ float clip_scale(float sq, float clip) {
  const float norm = __fsqrt_rn(sq);
  return fminf(1.0f, __fdiv_rn(clip, fmaxf(norm, kNormFloor)));
}

// Block-wide sum of one value per thread in a fixed order (warps by
// butterfly, then warp 0..7 in order); the result in thread 0.
__device__ __forceinline__ float block_sum(float s, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float block_max(float s, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  s = warp_max(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) t = fmaxf(t, red[i]);
  return t;
}

// Partial squared norms: block (b, c) writes sum over its chunk of row c
// of x^2 to part[b C + c].
__global__ void __launch_bounds__(kThreads)
row_sumsq_kernel(const float* __restrict__ x, float* __restrict__ part,
                 int C, long long P) {
  __shared__ float red[kWarps];
  const int b = blockIdx.x, c = blockIdx.y;
  const float* row = x + static_cast<long long>(c) * P;
  const long long lo = static_cast<long long>(b) * kChunk;
  const long long hi = lo + kChunk < P ? lo + kChunk : P;
  float s = 0.0f;
#pragma unroll 8
  for (long long p = lo + threadIdx.x; p < hi; p += kThreads) {
    const float v = __ldg(row + p);
    s = fmaf(v, v, s);
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) part[static_cast<long long>(b) * C + c] = s;
}

}  // namespace client_rows
