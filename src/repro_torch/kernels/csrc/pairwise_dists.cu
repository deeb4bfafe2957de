// Pairwise squared L2 distances between the clients' raveled deltas, the
// Krum / multi-Krum selection metric, written by hand for Hopper
// (sm_90a):
//   out[i, j] = max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0).
//
// Replaces: src/repro/kernels/agg_reduce.py::_pairwise_kernel (the
// pallas_call in pairwise_dists_flat). That kernel accumulates the
// expansion over P tiles into one (C, C) output block that stays resident
// across a sequential grid. CUDA blocks run in no order, so here the work
// is two launches and no atomics (two calls are bit-equal, and Krum's
// argmin cannot flip between runs):
//   1. pairwise_partial_kernel: block b owns columns
//      [b kChunk, (b + 1) kChunk) and writes the expansion form of its own
//      columns, |x_i|^2_b + |x_j|^2_b - 2 (x_i . x_j)_b, to part[b, i, j];
//   2. pairwise_finish_kernel: one warp per (i, j) sums part[:, i, j] and
//      clamps at 0: lane l takes blocks l, l + 32, ... in order, and a
//      fixed butterfly (shuffle xor) adds the 32 lane sums.
//
// Inputs x (C, P) f32 contiguous; scratch part (nb, C, C) and output
// (C, C) f32, allocated by the wrapper. C <= kMaxClients.
//
// Bound on the H100: bytes. The kernel reads x once: 4 C P bytes, 21.4 MB
// at the quickstart's (C, P) = (10, 534016), about 6.4 us at 3.35 TB/s;
// the C (C + 1) / 2 dot products (2.9e7 FMAs) are far under the card's
// rate. Design: a block stages its columns in (C, kTile) shared-memory
// tiles, each thread loading one column (the warp reads consecutive
// floats of a client row); warp g then takes the upper-triangle pairs
// q = g, g + 8, ..., each lane summing 8 columns of the tile, a fixed
// butterfly (shuffle xor) reducing the 32 lane sums, and lane 0 adding the
// tile's sum to the pair's accumulator in shared memory, tile by tile in
// order. The column split depends on P alone, not on the card.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;  // columns per shared-memory tile, one a thread
constexpr int kTilesPerBlock = 4;
constexpr int kRowsInFlight = 8;
constexpr long long kChunk = static_cast<long long>(kTile) * kTilesPerBlock;
// (C kTile + C (C + 1) / 2) floats of shared memory: 34.9 KB at the cap,
// under the 48 KB a block gets without opting in.
constexpr int kMaxClients = 32;

__global__ void __launch_bounds__(kThreads)
pairwise_partial_kernel(const float* __restrict__ x, float* __restrict__ part,
                        int C, long long P) {
  extern __shared__ float smem[];
  float* tile = smem;               // [C][kTile]
  float* acc = smem + C * kTile;    // upper triangle, row-major
  const int npairs = C * (C + 1) / 2;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  for (int q = t; q < npairs; q += kThreads) acc[q] = 0.0f;

  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  for (int k = 0; k < kTilesPerBlock; ++k) {
    const long long col = base + static_cast<long long>(k) * kTile + t;
    __syncthreads();  // the previous tile is consumed (and acc zeroed)
    // kRowsInFlight rows' loads issued before their stores, so their
    // latencies overlap
    for (int c0 = 0; c0 < C; c0 += kRowsInFlight) {
      float r[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int c = c0 + u;
        r[u] = c < C && col < P
                   ? __ldg(x + static_cast<long long>(c) * P + col)
                   : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
        if (c0 + u < C) tile[(c0 + u) * kTile + t] = r[u];
    }
    __syncthreads();
    // pair q = (i, j), i <= j, walked in row-major upper-triangle order
    int i = 0, j = 0;
    for (int q = 0; q < npairs; ++q) {
      if (q % kWarps == warp) {
        float s = 0.0f;
#pragma unroll
        for (int u = 0; u < kTile / 32; ++u) {
          const int cc = u * 32 + lane;
          s = fmaf(tile[i * kTile + cc], tile[j * kTile + cc], s);
        }
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) acc[q] += s;
      }
      if (++j == C) j = ++i;
    }
  }
  __syncthreads();
  // expansion form of this block's columns, full (C, C)
  float* out = part + static_cast<long long>(blockIdx.x) * C * C;
  for (int e = t; e < C * C; e += kThreads) {
    const int r = e / C, s = e % C;
    const int lo = r < s ? r : s, hi = r < s ? s : r;
    // index of (a, b), a <= b, in the row-major upper triangle
    const int ab = lo * C - lo * (lo - 1) / 2 + (hi - lo);
    const int aa = r * C - r * (r - 1) / 2;
    const int bb = s * C - s * (s - 1) / 2;
    out[e] = acc[aa] + acc[bb] - 2.0f * acc[ab];
  }
}

__global__ void __launch_bounds__(kThreads)
pairwise_finish_kernel(const float* __restrict__ part,
                       float* __restrict__ out, int CC, int nb) {
  const int e = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= CC) return;  // the whole warp leaves together
  float s = 0.0f;
#pragma unroll 4
  for (int b = lane; b < nb; b += 32)
    s += __ldg(part + static_cast<long long>(b) * CC + e);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[e] = fmaxf(s, 0.0f);
}

}  // namespace

// C entry, bound with ctypes: both launches on `stream` (PyTorch's current
// stream). part holds nb * C * C floats, nb = ceil(P / kChunk), which the
// wrapper computes from the same chunk (1024 columns) and passes for a
// check. Allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a C above the cap or a
// scratch of another size.
extern "C" int pairwise_dists_launch(const float* x, float* part, float* out,
                                     int C, long long P, long long nb,
                                     void* stream) {
  if (C < 1 || C > kMaxClients || P < 1 || nb != (P + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      (static_cast<size_t>(C) * kTile + C * (C + 1) / 2) * sizeof(float);
  pairwise_partial_kernel<<<static_cast<unsigned>(nb), kThreads, smem, st>>>(
      x, part, C, P);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int cc = C * C;
  pairwise_finish_kernel<<<(cc + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      part, out, cc, static_cast<int>(nb));
  return static_cast<int>(cudaGetLastError());
}
