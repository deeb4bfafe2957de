// The fused DP release + int8 quantized transport + weighted reduce,
// written by hand for Hopper (sm_90a). Per client c, the released value
//   u_c = x_c * min(1, clip / max(|x_c|, 1e-12)) + noise_c   (clip > 0)
//   u_c = x_c                                                 (clip == 0)
// plus the EF residual resid_c when one is given; then the symmetric
// int8 round trip with s_c = max(max_p |u_c| / 127, 1e-30):
//   q = floor(u / s_c + uniform)  (stochastic, presampled uniforms)
//   q = rint(u / s_c)             (round half to even, without them)
//   t = clamp(q, -127, 127) * s_c
// and out[p] = sum_c w[c] t[c, p], resid'[c, p] = u[c, p] - t[c, p].
//
// Replaces: src/repro/kernels/agg_reduce.py::_quant_clip_reduce_kernel
// (the pallas_call in quant_clip_reduce_flat). That kernel runs a
// sequential (3, nb) grid ((2, nb) without the clip) with two (C, 1)
// scratch accumulators: squared norms, then the absmax of u recomputed
// on the fly, then the quantize/reduce sweep. u must survive two
// reductions over the whole row (the norm, then the absmax of u), which
// CUDA blocks, running in no order, cannot carry from one to the next.
//
// Bound on the H100: bytes. Each input read once and each output written
// once: 4 (5 C P + P + C) bytes with every operand, 109 MB at the
// quickstart's (C, P) = (10, 534016), about 32.5 us at 3.35 TB/s; 4 (4 C
// P + P + C), 87.6 MB and 26.1 us, as int8_ef calls it (residual and
// uniforms, no clip). Measured times: PERF.md section 6, row 8.
//
// Two designs; the wrapper picks one from (C, P) and the card before any
// launch (agg_reduce.py::quant_design_for), and this entry re-checks it.
//
// On chip, where u fits in the card's shared memory (C = 10 at P =
// 534016: 21.4 MB of the 132 SMs' ~29 MB): one cooperative launch of
// ceil(P / width) blocks, width = 4 ceil(ceil(P / 128) / 4) columns (a
// function of P alone, so the bits do not depend on the card), one block
// an SM, each owning its columns of all C rows in shared memory:
//   1. with the clip, x's tile arrives (float4 loads when every row start
//      is 16-byte aligned, else single floats), per-row partial squared
//      norms go to norm_part, a grid barrier, and every block finishes
//      every row's clip scale in one fixed order;
//   2. u is built in the tile in the TPU kernel's op order (released()):
//      noise and resid (and x, without the clip) read once; per-row
//      absmax partials, a grid barrier, every block finishes the scales;
//   3. each (row, column) is quantized from shared memory with uniform
//      read once, resid_out written once, t kept in place; then each
//      column's out = sum_c w_c t_c, clients 0..C-1 in order.
// Reads and writes each operand once: exactly the bound's bytes. One
// barrier without the clip. The barrier is this file's own (an arrival
// counter zeroed by a memset on the stream before the launch, one thread
// a block spinning on it); the cooperative launch guarantees that every
// block is resident and refuses a grid that is not, and there is no
// retry with the other design.
//
// Three passes, for every (C, P) whose u does not fit (C = 32 at P =
// 534016 is 68 MB), with no grid order and no atomics (client_rows.cuh):
//   1. (clip > 0) row_sumsq_kernel: per-chunk partial squared norms;
//   2. row_absmax_kernel on a (nb, C) grid: block (b, c) finishes row c's
//      norm from the partials (every warp, the same fixed order), builds
//      u on its chunk and writes the chunk's max |u|. A max is exact in
//      any order;
//   3. quant_reduce_kernel, a grid over P: each block finishes all C clip
//      scales and quantization scales into shared memory, then each
//      thread takes 4 columns and walks the clients 0..C-1 in order.
// u is rebuilt in passes 2 and 3 from the operands, so it reads x three
// times and the noise and residual twice: 9 C P floats, 1.8x the bound.
//
// Both designs: one rounding per op (the _rn intrinsics keep nvcc from
// fusing into an FMA), z = u / s an IEEE division, rint rounding half to
// even like jnp.round and torch.round (roundf would not). No atomics on
// values; two calls are bit-equal. The clip scale's norm is summed in
// another order by each design, so the two may differ by an ulp there.
//
// Inputs x (C, P), noise, resid and uniform (C, P) or null, w (C,), all
// f32 contiguous; scratch norm_part (nb, C) (unused without the clip),
// amax_part (nb, C) and a barrier counter (on chip only), outputs out
// (P,) and resid_out (C, P) (with a residual only), allocated by the
// wrapper.
#include <cuda_runtime.h>

#include <cstdint>

#include "client_rows.cuh"

namespace {

using namespace client_rows;

struct Args {
  const float* x;
  const float* noise;
  const float* resid;
  const float* uniform;
  const float* w;
  float* norm_part;
  float* amax_part;
  unsigned* bar;
  float* out;
  float* resid_out;
  float clip;
  int C;
  long long P;
  int nb;
  int width;  // on chip: the columns a block owns; 0: three passes
  cudaStream_t stream;
};

// ---- on chip ----

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

inline size_t oc_smem(int C, long long width) {
  const long long segs = (width + kSegCols - 1) / kSegCols;
  // the (C, width) tile, (C, segs) partials, clip and quantization scales
  // and the weights
  return sizeof(float) * (static_cast<size_t>(C) * width +
                          static_cast<size_t>(C) * segs + 3 * C);
}

// V floats: one float4 (V = 4) or one float
template <int V>
struct Pack {
  float v[V];
};

template <int V>
__device__ __forceinline__ Pack<V> ld_global(const float* __restrict__ p) {
  Pack<V> r;
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = f.x, r.v[1] = f.y, r.v[2] = f.z, r.v[3] = f.w;
  } else {
    r.v[0] = __ldg(p);
  }
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

// Every block waits here until all nb blocks have arrived: thread 0
// publishes the block's writes (fence), counts its arrival and spins on
// the counter (acquire); `target` is nb times the barrier's number in the
// call. The counter is zeroed before each launch.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(bar)
                   : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
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

template <bool kClip, bool kNoise, bool kResid, bool kUniform, int V>
__global__ void __launch_bounds__(kOcThreads, 1)
quant_on_chip_kernel(const float* __restrict__ x,
                     const float* __restrict__ noise,
                     const float* __restrict__ resid,
                     const float* __restrict__ uniform,
                     const float* __restrict__ w,
                     float* __restrict__ norm_part,
                     float* __restrict__ amax_part, unsigned* bar,
                     float* __restrict__ out, float* __restrict__ resid_out,
                     float clip, int C, long long P, int width) {
  using Segs = SegMap<kSegCols, V>;
  // the release pass's operand streams: x (without the clip), noise,
  // resid; at most two are present
  constexpr int kStreams = (!kClip) + kNoise + kResid > 0
                               ? (!kClip) + kNoise + kResid
                               : 1;
  // each stream's index in the release pass's buffers
  constexpr int kXi = 0, kNi = kClip ? 0 : 1, kRi = kNi + kNoise;
  using Seg1 = Pack<V>[1][Segs::kPacks];
  using SegS = Pack<V>[kStreams][Segs::kPacks];
  extern __shared__ __align__(16) float oc_buf[];
  const int segs_max = (width + kSegCols - 1) / kSegCols;
  float* tile = oc_buf;                                    // [C][width]
  float* seg = tile + static_cast<size_t>(C) * width;       // [C][segs]
  float* scale = seg + static_cast<size_t>(C) * segs_max;   // [C]
  float* qscale = scale + C;                                // [C]
  float* wsm = qscale + C;                                  // [C]
  const int nb = gridDim.x, b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long col0 = static_cast<long long>(b) * width;
  const int wb = static_cast<int>(P - col0 < width ? P - col0 : width);
  const Segs sg(C, wb);
  auto at = [&](auto* base, int c, int col) {
    return base + static_cast<long long>(c) * P + col0 + col;
  };
  auto in_tile = [&](int c, int col) {
    return tile + static_cast<size_t>(c) * width + col;
  };
  // stream `st` of segment q from `base` into buf[st]
  auto load_stream = [&](auto& buf, int st, const float* base, int q) {
    const int c = sg.row(q);
#pragma unroll
    for (int k = 0; k < Segs::kPacks; ++k) {
      const int col = sg.col(q, k);
      if (col >= 0) buf[st][k] = ld_global<V>(at(base, c, col));
    }
  };
  // a row's partial over its segments, in order, to part[b C + c]
  auto row_partials = [&](float* part, bool is_max) {
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kOcThreads) {
      float t = 0.0f;
      for (int s = 0; s < sg.segs; ++s)
        t = is_max ? fmaxf(t, seg[c * segs_max + s])
                   : t + seg[c * segs_max + s];
      part[static_cast<long long>(b) * C + c] = t;
    }
  };

  for (int c = threadIdx.x; c < C; c += kOcThreads) wsm[c] = __ldg(w + c);
  unsigned barriers = 0;
  SegS ua, ub;  // the release pass's buffers
  auto load_release = [&](int q, SegS& buf) {
    if constexpr (!kClip) load_stream(buf, kXi, x, q);
    if constexpr (kNoise) load_stream(buf, kNi, noise, q);
    if constexpr (kResid) load_stream(buf, kRi, resid, q);
  };

  if constexpr (kClip) {
    // 1. x into the tile, and the rows' squared norms
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
    if (warp < sg.nseg) load_release(warp, ua);  // in flight in the wait
    grid_barrier(bar, ++barriers * nb);
    for (int c = warp; c < C; c += kOcWarps) {
      const float sc = clip_scale(finish_sum<true>(norm_part, nb, C, c), clip);
      if (lane == 0) scale[c] = sc;
    }
    __syncthreads();
  } else {
    if (warp < sg.nseg) load_release(warp, ua);
  }

  // 2. u into the tile (in place with the clip, from x without), in
  // released()'s op order, and the rows' absmax
  run_segments(sg.nseg, ua, ub, load_release, [&](int q, SegS& buf) {
    const int c = sg.row(q);
    const float sc = kClip ? scale[c] : 1.0f;
    float m = 0.0f;
#pragma unroll
    for (int k = 0; k < Segs::kPacks; ++k) {
      const int col = sg.col(q, k);
      if (col < 0) continue;
      Pack<V> y;
      if constexpr (kClip)
        y = ld_shared<V>(in_tile(c, col));
      else
        y = buf[kXi][k];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v = y.v[e];
        if constexpr (kClip) {
          v = __fmul_rn(v, sc);
          if constexpr (kNoise) v = __fadd_rn(v, buf[kNi][k].v[e]);
        }
        if constexpr (kResid) v = __fadd_rn(v, buf[kRi][k].v[e]);
        y.v[e] = v;
        m = fmaxf(m, fabsf(v));
      }
      st<V>(in_tile(c, col), y);
    }
    m = warp_max(m);
    if (lane == 0) seg[c * segs_max + q % sg.segs] = m;
  });
  row_partials(amax_part, true);
  Seg1 fa, fb;  // the uniforms, the first in flight in the wait
  if (kUniform && warp < sg.nseg) load_stream(fa, 0, uniform, warp);
  grid_barrier(bar, ++barriers * nb);
  for (int c = warp; c < C; c += kOcWarps) {
    const float amax = finish_max<true>(amax_part, nb, C, c);
    if (lane == 0) qscale[c] = fmaxf(__fdiv_rn(amax, kInt8Levels), kScaleFloor);
  }
  __syncthreads();

  // 3. t = dequant(Q(u)) in place, the new residual out
  run_segments(sg.nseg, fa, fb, [&](int q, Seg1& buf) {
    if (kUniform) load_stream(buf, 0, uniform, q);
  }, [&](int q, Seg1& buf) {
    const int c = sg.row(q);
    const float sq = qscale[c];
#pragma unroll
    for (int k = 0; k < Segs::kPacks; ++k) {
      const int col = sg.col(q, k);
      if (col < 0) continue;
      float* u = in_tile(c, col);
      const Pack<V> y = ld_shared<V>(u);
      Pack<V> t, e;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float z = __fdiv_rn(y.v[i], sq);
        float q8 = kUniform ? floorf(__fadd_rn(z, buf[0][k].v[i])) : rintf(z);
        q8 = fminf(fmaxf(q8, -kInt8Levels), kInt8Levels);
        t.v[i] = __fmul_rn(q8, sq);
        e.v[i] = __fsub_rn(y.v[i], t.v[i]);
      }
      st<V>(u, t);
      if (kResid) st<V>(at(resid_out, c, col), e);
    }
  });
  __syncthreads();
  // out = sum_c w_c t_c, clients in order from 0
  for (int k = threadIdx.x; k < wb / V; k += kOcThreads) {
    Pack<V> acc;
#pragma unroll
    for (int i = 0; i < V; ++i) acc.v[i] = 0.0f;
    for (int c = 0; c < C; ++c) {
      const Pack<V> t = ld_shared<V>(in_tile(c, k * V));
#pragma unroll
      for (int i = 0; i < V; ++i) acc.v[i] = fmaf(wsm[c], t.v[i], acc.v[i]);
    }
    st<V>(out + col0 + k * V, acc);
  }
}

template <bool kClip, bool kNoise, bool kResid, bool kUniform, int V>
int launch_on_chip(const Args& a) {
  const auto kern = quant_on_chip_kernel<kClip, kNoise, kResid, kUniform, V>;
  const size_t smem = oc_smem(a.C, a.width);
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
  if (static_cast<long long>(per_sm) * sms < a.nb)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = static_cast<int>(cudaMemsetAsync(a.bar, 0, sizeof(unsigned),
                                         a.stream));
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.nb));
  cfg.blockDim = dim3(kOcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, a.x, a.noise, a.resid, a.uniform, a.w, a.norm_part,
      a.amax_part, a.bar, a.out, a.resid_out, a.clip, a.C, a.P, a.width));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// ---- three passes ----

// u at flat index i of row c, given the row's clip scale
template <bool kClip, bool kNoise, bool kResid>
__device__ __forceinline__ float released(const float* __restrict__ x,
                                          const float* __restrict__ noise,
                                          const float* __restrict__ resid,
                                          long long i, float sc) {
  float y = __ldg(x + i);
  if (kClip) {
    y = __fmul_rn(y, sc);
    if (kNoise) y = __fadd_rn(y, __ldg(noise + i));
  }
  if (kResid) y = __fadd_rn(y, __ldg(resid + i));
  return y;
}

template <bool kClip, bool kNoise, bool kResid>
__global__ void __launch_bounds__(kThreads)
row_absmax_kernel(const float* __restrict__ x,
                  const float* __restrict__ noise,
                  const float* __restrict__ resid,
                  const float* __restrict__ norm_part, int nb, float clip,
                  float* __restrict__ amax_part, int C, long long P) {
  __shared__ float red[kWarps];
  const int b = blockIdx.x, c = blockIdx.y;
  // every warp finishes the row's norm itself: same code, same bits
  const float sc = kClip ? clip_scale(finish_sum(norm_part, nb, C, c), clip)
                         : 1.0f;
  const long long row = static_cast<long long>(c) * P;
  const long long lo = static_cast<long long>(b) * kChunk;
  const long long hi = lo + kChunk < P ? lo + kChunk : P;
  float m = 0.0f;
#pragma unroll 8
  for (long long p = lo + threadIdx.x; p < hi; p += kThreads)
    m = fmaxf(m, fabsf(released<kClip, kNoise, kResid>(x, noise, resid,
                                                        row + p, sc)));
  m = block_max(m, red);
  if (threadIdx.x == 0) amax_part[static_cast<long long>(b) * C + c] = m;
}

template <bool kClip, bool kNoise, bool kResid, bool kUniform>
__global__ void __launch_bounds__(kThreads)
quant_reduce_kernel(const float* __restrict__ x,
                    const float* __restrict__ noise,
                    const float* __restrict__ resid,
                    const float* __restrict__ uniform,
                    const float* __restrict__ w,
                    const float* __restrict__ norm_part,
                    const float* __restrict__ amax_part, int nb, float clip,
                    float* __restrict__ out, float* __restrict__ resid_out,
                    int C, long long P) {
  extern __shared__ float sm[];
  float* scale = sm;      // [C] clip scales
  float* qscale = sm + C;  // [C] quantization scales
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = warp; c < C; c += kWarps) {
    const float sc =
        kClip ? clip_scale(finish_sum(norm_part, nb, C, c), clip) : 1.0f;
    const float amax = finish_max(amax_part, nb, C, c);
    if (lane == 0) {
      scale[c] = sc;
      qscale[c] = fmaxf(__fdiv_rn(amax, kInt8Levels), kScaleFloor);
    }
  }
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * kBlockCols +
                         threadIdx.x;
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float wc = __ldg(w + c), sc = scale[c], s = qscale[c];
    const long long row = static_cast<long long>(c) * P;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const long long p = base + static_cast<long long>(k) * kThreads;
      if (p < P) {
        const float y =
            released<kClip, kNoise, kResid>(x, noise, resid, row + p, sc);
        const float z = __fdiv_rn(y, s);
        float q = kUniform ? floorf(__fadd_rn(z, __ldg(uniform + row + p)))
                           : rintf(z);
        q = fminf(fmaxf(q, -kInt8Levels), kInt8Levels);
        const float t = __fmul_rn(q, s);
        acc[k] = fmaf(wc, t, acc[k]);
        if (kResid) resid_out[row + p] = __fsub_rn(y, t);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const long long p = base + static_cast<long long>(k) * kThreads;
    if (p < P) out[p] = acc[k];
  }
}

template <bool kClip, bool kNoise, bool kResid, bool kUniform>
int launch(const Args& a) {
  const unsigned nb = static_cast<unsigned>(a.nb);
  const dim3 rows(nb, static_cast<unsigned>(a.C));
  if (kClip) {
    row_sumsq_kernel<<<rows, kThreads, 0, a.stream>>>(a.x, a.norm_part, a.C,
                                                      a.P);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  row_absmax_kernel<kClip, kNoise, kResid><<<rows, kThreads, 0, a.stream>>>(
      a.x, a.noise, a.resid, a.norm_part, a.nb, a.clip, a.amax_part, a.C,
      a.P);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const unsigned blocks =
      static_cast<unsigned>((a.P + kBlockCols - 1) / kBlockCols);
  const size_t smem = 2 * static_cast<size_t>(a.C) * sizeof(float);
  quant_reduce_kernel<kClip, kNoise, kResid, kUniform>
      <<<blocks, kThreads, smem, a.stream>>>(
          a.x, a.noise, a.resid, a.uniform, a.w, a.norm_part, a.amax_part,
          a.nb, a.clip, a.out, a.resid_out, a.C, a.P);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const Args&);

struct Designs {
  LaunchFn three_pass, on_chip_vec, on_chip_scalar;
};

template <bool kClip, bool kNoise, bool kResid, bool kUniform>
constexpr Designs designs() {
  return {launch<kClip, kNoise, kResid, kUniform>,
          launch_on_chip<kClip, kNoise, kResid, kUniform, 4>,
          launch_on_chip<kClip, kNoise, kResid, kUniform, 1>};
}

// indexed by clip * 8 + noise * 4 + resid * 2 + uniform; noise without
// the clip is refused before the table is read
constexpr Designs kLaunch[16] = {
    designs<false, false, false, false>(), designs<false, false, false, true>(),
    designs<false, false, true, false>(),  designs<false, false, true, true>(),
    {}, {}, {}, {},
    designs<true, false, false, false>(),  designs<true, false, false, true>(),
    designs<true, false, true, false>(),   designs<true, false, true, true>(),
    designs<true, true, false, false>(),   designs<true, true, false, true>(),
    designs<true, true, true, false>(),    designs<true, true, true, true>()};

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// C entry, bound with ctypes, on `stream` (PyTorch's current stream).
// clip > 0 turns the DP release on; noise, resid and uniform may each be
// null (noise only with clip > 0); resid_out is written when resid is
// given. width selects the design: 0 the three passes (norm_part and
// amax_part hold nb * C floats each, nb = ceil(P / 8192)), else the
// on-chip launch, width the columns a block owns, which must be
// 4 ceil(ceil(P / 128) / 4), and nb = ceil(P / width) blocks, the
// partials nb * C floats each and bar one zeroed counter; the wrapper
// computes both from the same rules and passes them for a check. The
// on-chip launch returns cudaErrorCooperativeLaunchTooLarge when its grid
// cannot be resident at once. Allocates nothing, does not synchronise;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a bad size,
// a design's mismatch or noise without the clip.
extern "C" int quant_clip_reduce_launch(
    const float* x, const float* noise, const float* resid,
    const float* uniform, const float* w, float* norm_part, float* amax_part,
    unsigned* bar, float* out, float* resid_out, float clip, int C,
    long long P, long long nb, long long width, void* stream) {
  const bool has_clip = clip > 0.0f;
  const bool on_chip = width != 0;
  if (C < 1 || C > kMaxRows || P < 1 ||
      (on_chip ? width != oc_width(P) || nb != (P + width - 1) / width
               : nb != num_chunks(P)) ||
      (noise != nullptr && !has_clip) ||
      (resid != nullptr) != (resid_out != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,         noise, resid,    uniform,
               w,         norm_part, amax_part, bar,
               out,       resid_out, clip,  C,
               P,         static_cast<int>(nb), static_cast<int>(width),
               static_cast<cudaStream_t>(stream)};
  const int idx = (has_clip ? 8 : 0) + (noise != nullptr ? 4 : 0) +
                  (resid != nullptr ? 2 : 0) + (uniform != nullptr ? 1 : 0);
  const Designs& d = kLaunch[idx];
  if (!on_chip) return d.three_pass(a);
  const bool vec = P % 4 == 0 && aligned16(x) && aligned16(noise) &&
                   aligned16(resid) && aligned16(uniform) && aligned16(out) &&
                   aligned16(resid_out);
  return (vec ? d.on_chip_vec : d.on_chip_scalar)(a);
}
