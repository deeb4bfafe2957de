// The on-chip designs of the per-client reductions, shared by the DP clip
// kernel (clip_reduce.cu) and the quantized transport kernel
// (quant_clip_reduce.cu): one cooperative launch of ceil(P / width)
// blocks, width = 4 ceil(ceil(P / 128) / 4) columns (a function of P
// alone, so the bits do not depend on the card), one block an SM, each
// holding its columns of all C rows in shared memory. A reduction over a
// whole row (the clip's squared norm, the codec's absmax) is per-segment
// partials, per-block partials in a (C, nb) scratch, a grid barrier, and
// every block finishing every row from its nb partials in one fixed order
// (finish_row), so all blocks get the same bits. A row's partials lie
// side by side: every block reads all of them at once after the barrier,
// and in the (nb, C) layout of the two- and three-pass designs (a 4C-byte
// stride across a warp) those reads pile up on a few L2 lines and took
// longer than the tile itself. The barrier is cooperative groups' grid
// sync, which needs no counter zeroed before each launch (a memset node
// on the stream costs a graph node's gap every call). PERF.md section 6,
// PR 21, has the measurements. The caller picks the design before the
// launch; a grid that cannot be resident at once is refused
// (cudaErrorCooperativeLaunchTooLarge), never retried with the other
// design.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "client_rows.cuh"

namespace client_rows {

constexpr int kOcThreads = 512;  // 16 warps, one block an SM
constexpr int kOcWarps = kOcThreads / 32;
// the column split: ceil(P / kOcSplit) columns a block, rounded up to 4
constexpr long long kOcSplit = 128;
// columns of a row a warp takes at a time in the row passes: 4 float4 (16
// floats) a lane of each operand, all loads issued before their use, and
// the next segment's in flight meanwhile
constexpr int kSegCols = 512;

inline long long oc_width(long long P) {
  const long long w = (P + kOcSplit - 1) / kOcSplit;
  return (w + 3) / 4 * 4;
}

// the (C, width) tile, the (C, segs) segment partials, and `per_row`
// arrays of C floats after them (scales, weights)
inline size_t oc_smem(int C, long long width, int per_row) {
  const long long segs = (width + kSegCols - 1) / kSegCols;
  return sizeof(float) * (static_cast<size_t>(C) * width +
                          static_cast<size_t>(C) * segs +
                          static_cast<size_t>(per_row) * C);
}

inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// V floats: one float4 (V = 4) or one float
template <int V>
struct Pack {
  float v[V];
};

// An operand read once: through the read-only path, not kept in L1, and
// with L2 fetching the 256-byte block around it from device memory (the
// quant kernel reads faster this way than with plain __ldg).
template <int V>
__device__ __forceinline__ Pack<V> ld_global(const float* __restrict__ p) {
  Pack<V> r;
  if constexpr (V == 4)
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, "
        "[%4];"
        : "=f"(r.v[0]), "=f"(r.v[1]), "=f"(r.v[2]), "=f"(r.v[3])
        : "l"(p));
  else
    asm("ld.global.nc.L1::no_allocate.L2::256B.f32 %0, [%1];"
        : "=f"(r.v[0])
        : "l"(p));
  return r;
}

template <int V>
__device__ __forceinline__ Pack<V> ld_shared(const float* p) {
  Pack<V> r;
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    r.v[0] = f.x, r.v[1] = f.y, r.v[2] = f.z, r.v[3] = f.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void st(float* p, const Pack<V>& r) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  else
    *p = r.v[0];
}

// Every block waits here until all blocks have arrived, their writes
// before it visible to all after it.
__device__ __forceinline__ void grid_barrier() {
  cooperative_groups::this_grid().sync();
}

// Row c's total from its nb partials row[0..nb), written by other blocks
// of the running launch before a grid barrier (so through L2: the
// read-only path may hold stale lines); called by a whole warp, lane l
// taking partials l, l + 32, ... in order, then a fixed butterfly; the
// result in every lane.
template <bool kMax>
__device__ __forceinline__ float finish_row(const float* row, int nb) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f;  // a max of absolute values: 0 is its identity too
#pragma unroll 4
  for (int b = lane; b < nb; b += 32) {
    const float v = __ldcg(row + b);
    s = kMax ? fmaxf(s, v) : s + v;
  }
  return kMax ? warp_max(s) : warp_sum(s);
}

// A row pass over the block's segments (row c, columns [s kSegCols,
// (s + 1) kSegCols) of its wb), warp w taking segments w, w + kOcWarps,
// ... in turn, software-pipelined: the loads of a warp's next segment are
// in flight while it uses the current one. `load(q, buf)` fills buf with
// segment q's S operand streams, `use(q, buf)` consumes them; the caller
// has loaded the warp's first segment into `a` already (possibly before a
// grid barrier, so that its loads overlap the wait).
template <typename Buf, typename Load, typename Use>
__device__ __forceinline__ void run_segments(int nseg, Buf& a, Buf& b,
                                             Load load, Use use) {
  for (int q = threadIdx.x / 32; q < nseg; q += 2 * kOcWarps) {
    const int q1 = q + kOcWarps;
    if (q1 < nseg) load(q1, b);
    use(q, a);
    if (q1 >= nseg) break;
    if (q1 + kOcWarps < nseg) load(q1 + kOcWarps, a);
    use(q1, b);
  }
}

// The block's segments of kW columns, row-major over the C rows: segment
// q is row q / segs, columns [(q % segs) kW, (q % segs + 1) kW) of the
// block's wb; lane l's k-th pack of V floats starts at col(q, k) (-1 past
// wb).
template <int kW, int V>
struct SegMap {
  static constexpr int kPacks = kW / (32 * V);
  int segs, nseg, wb, lane;
  __device__ SegMap(int C, int wb_)
      : segs((wb_ + kW - 1) / kW), nseg(C * segs), wb(wb_),
        lane(threadIdx.x % 32) {}
  __device__ int row(int q) const { return q / segs; }
  __device__ int col(int q, int k) const {
    const int c = (q % segs) * kW + (k * 32 + lane) * V;
    return c < wb ? c : -1;
  }
};

// One block of an on-chip launch: its columns [col0, col0 + wb) of every
// row, and the dynamic shared memory laid out as oc_smem says.
template <int V>
struct OnChip {
  using Segs = SegMap<kSegCols, V>;
  // one operand stream of a segment: a lane's packs
  using Seg1 = Pack<V>[1][Segs::kPacks];
  int C, width, segs_max;
  long long P, col0;
  int wb;
  Segs sg;
  float* tile;  // [C][width]
  float* seg;   // [C][segs_max]
  float* rows;  // the per-row arrays, C floats each

  __device__ OnChip(float* smem, int C_, long long P_, int width_)
      : C(C_), width(width_), segs_max((width_ + kSegCols - 1) / kSegCols),
        P(P_), col0(static_cast<long long>(blockIdx.x) * width_),
        wb(static_cast<int>(P_ - col0 < width_ ? P_ - col0 : width_)),
        sg(C_, wb), tile(smem),
        seg(smem + static_cast<size_t>(C_) * width_),
        rows(seg + static_cast<size_t>(C_) * segs_max) {}

  template <typename T>
  __device__ T* at(T* base, int c, int col) const {
    return base + static_cast<long long>(c) * P + col0 + col;
  }
  __device__ float* in_tile(int c, int col) const {
    return tile + static_cast<size_t>(c) * width + col;
  }
  // stream `s` of segment q from `base` into buf[s]
  template <typename Buf>
  __device__ void load_stream(Buf& buf, int s, const float* base,
                              int q) const {
    const int c = sg.row(q);
#pragma unroll
    for (int k = 0; k < Segs::kPacks; ++k) {
      const int col = sg.col(q, k);
      if (col >= 0) buf[s][k] = ld_global<V>(at(base, c, col));
    }
  }
  // a row's partial over its segments, in order, to part[c nb + b]
  __device__ void row_partials(float* part, bool is_max) const {
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kOcThreads) {
      float t = 0.0f;
      for (int s = 0; s < sg.segs; ++s)
        t = is_max ? fmaxf(t, seg[c * segs_max + s])
                   : t + seg[c * segs_max + s];
      part[static_cast<long long>(c) * gridDim.x + blockIdx.x] = t;
    }
  }
  // row c's nb partials
  __device__ const float* part_row(const float* part, int c) const {
    return part + static_cast<long long>(c) * gridDim.x;
  }

  // x's columns into the tile (each lane's packs in order, a warp's sum by
  // butterfly, a row's segments in order) and the block's partial squared
  // norms to norm_part (C, nb); then `prefetch()` issues the next pass's
  // first loads, to be in flight during the grid barrier that follows.
  template <typename Prefetch>
  __device__ void tile_norms(const float* __restrict__ x, float* norm_part,
                             Prefetch prefetch) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    Seg1 xa, xb;
    if (warp < sg.nseg) load_stream(xa, 0, x, warp);
    run_segments(sg.nseg, xa, xb, [&](int q, Seg1& buf) {
      load_stream(buf, 0, x, q);
    }, [&](int q, Seg1& buf) {
      const int c = sg.row(q);
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < Segs::kPacks; ++k) {
        const int col = sg.col(q, k);
        if (col >= 0) {
          st<V>(in_tile(c, col), buf[0][k]);
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc = fmaf(buf[0][k].v[e], buf[0][k].v[e], acc);
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) seg[c * segs_max + q % sg.segs] = acc;
    });
    row_partials(norm_part, false);
    prefetch();
  }

  // after the barrier: every row's clip scale from the grid's norm_part,
  // warp w finishing rows w, w + kOcWarps, ... (the same order in every
  // block), into scale[C]
  __device__ void clip_scales(const float* norm_part, float clip,
                              float* scale) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = warp; c < C; c += kOcWarps) {
      const float sc = clip_scale(
          finish_row<false>(part_row(norm_part, c), gridDim.x), clip);
      if (lane == 0) scale[c] = sc;
    }
    __syncthreads();
  }
};

// One cooperative launch of `kern` on nb blocks of kOcThreads with `smem`
// bytes of dynamic shared memory; cudaErrorCooperativeLaunchTooLarge when
// the grid cannot be resident at once.
template <typename Kern, typename... Args>
int launch_on_chip_grid(Kern kern, int nb, size_t smem, cudaStream_t stream,
                        Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err == 0)
    err = static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kOcThreads, smem));
  if (err != 0) return err;
  if (static_cast<long long>(per_sm) * sms < nb)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nb));
  cfg.blockDim = dim3(kOcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, kern, args...));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace client_rows
