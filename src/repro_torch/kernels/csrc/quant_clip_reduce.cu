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
// barrier without the clip. Step 1, the partials' layout, the barrier
// and the launch are on_chip_rows.cuh's, shared with the DP clip kernel;
// the cooperative launch guarantees that every block is resident and
// refuses a grid that is not, and there is no retry with the other
// design.
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
//      Past kSmemRows clients quant_scales_kernel finishes each row's
//      two scales once into the scratch, after the absmax partials, and
//      the reduce reads them there (the same scales, bit for bit).
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
// f32 contiguous; scratch norm_part, nb * C floats (unused without the
// clip), and amax_part, (nb + 2) * C floats (the partials, then the clip
// and quantization scales past kSmemRows clients); device memory is the
// only limit on C; outputs out
// (P,) and resid_out (C, P) (with a residual only), allocated by the
// wrapper.
#include <cuda_runtime.h>

#include "on_chip_rows.cuh"

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
  float* out;
  float* resid_out;
  float clip;
  int C;
  long long P;
  int nb;
  int width;  // on chip: the columns a block owns; 0: three passes
  cudaStream_t stream;
};

// ---- on chip (on_chip_rows.cuh) ----

template <bool kClip, bool kNoise, bool kResid, bool kUniform, int V>
__global__ void __launch_bounds__(kOcThreads, 1)
quant_on_chip_kernel(const float* __restrict__ x,
                     const float* __restrict__ noise,
                     const float* __restrict__ resid,
                     const float* __restrict__ uniform,
                     const float* __restrict__ w,
                     float* __restrict__ norm_part,
                     float* __restrict__ amax_part,
                     float* __restrict__ out, float* __restrict__ resid_out,
                     float clip, int C, long long P, int width) {
  using Blk = OnChip<V>;
  using Seg1 = typename Blk::Seg1;
  // the release pass's operand streams: x (without the clip), noise,
  // resid; at most two are present
  constexpr int kStreams = (!kClip) + kNoise + kResid > 0
                               ? (!kClip) + kNoise + kResid
                               : 1;
  // each stream's index in the release pass's buffers
  constexpr int kXi = 0, kNi = kClip ? 0 : 1, kRi = kNi + kNoise;
  using SegS = Pack<V>[kStreams][Blk::Segs::kPacks];
  extern __shared__ __align__(16) float oc_buf[];
  const Blk blk(oc_buf, C, P, width);
  const auto& sg = blk.sg;
  float* scale = blk.rows;   // [C]
  float* qscale = scale + C;  // [C]
  float* wsm = qscale + C;    // [C]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int c = threadIdx.x; c < C; c += kOcThreads) wsm[c] = __ldg(w + c);
  SegS ua, ub;  // the release pass's buffers
  auto load_release = [&](int q, SegS& buf) {
    if constexpr (!kClip) blk.load_stream(buf, kXi, x, q);
    if constexpr (kNoise) blk.load_stream(buf, kNi, noise, q);
    if constexpr (kResid) blk.load_stream(buf, kRi, resid, q);
  };

  if constexpr (kClip) {
    // 1. x into the tile, and the rows' squared norms; the release pass's
    // first loads in flight in the wait
    blk.tile_norms(x, norm_part, [&] {
      if (warp < sg.nseg) load_release(warp, ua);
    });
    grid_barrier();
    blk.clip_scales(norm_part, clip, scale);
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
    for (int k = 0; k < Blk::Segs::kPacks; ++k) {
      const int col = sg.col(q, k);
      if (col < 0) continue;
      Pack<V> y;
      if constexpr (kClip)
        y = ld_shared<V>(blk.in_tile(c, col));
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
      st<V>(blk.in_tile(c, col), y);
    }
    m = warp_max(m);
    if (lane == 0) blk.seg[c * blk.segs_max + q % sg.segs] = m;
  });
  blk.row_partials(amax_part, true);
  Seg1 fa, fb;  // the uniforms, the first in flight in the wait
  if (kUniform && warp < sg.nseg) blk.load_stream(fa, 0, uniform, warp);
  grid_barrier();
  for (int c = warp; c < C; c += kOcWarps) {
    const float amax = finish_row<true>(blk.part_row(amax_part, c), gridDim.x);
    if (lane == 0) qscale[c] = fmaxf(__fdiv_rn(amax, kInt8Levels), kScaleFloor);
  }
  __syncthreads();

  // 3. t = dequant(Q(u)) in place, the new residual out
  run_segments(sg.nseg, fa, fb, [&](int q, Seg1& buf) {
    if (kUniform) blk.load_stream(buf, 0, uniform, q);
  }, [&](int q, Seg1& buf) {
    const int c = sg.row(q);
    const float sq = qscale[c];
#pragma unroll
    for (int k = 0; k < Blk::Segs::kPacks; ++k) {
      const int col = sg.col(q, k);
      if (col < 0) continue;
      float* u = blk.in_tile(c, col);
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
      if (kResid) st<V>(blk.at(resid_out, c, col), e);
    }
  });
  __syncthreads();
  // out = sum_c w_c t_c, clients in order from 0
  for (int k = threadIdx.x; k < blk.wb / V; k += kOcThreads) {
    Pack<V> acc;
#pragma unroll
    for (int i = 0; i < V; ++i) acc.v[i] = 0.0f;
    for (int c = 0; c < C; ++c) {
      const Pack<V> t = ld_shared<V>(blk.in_tile(c, k * V));
#pragma unroll
      for (int i = 0; i < V; ++i) acc.v[i] = fmaf(wsm[c], t.v[i], acc.v[i]);
    }
    st<V>(out + blk.col0 + k * V, acc);
  }
}

template <bool kClip, bool kNoise, bool kResid, bool kUniform, int V>
int launch_on_chip(const Args& a) {
  // the clip scales, quantization scales and weights
  return launch_on_chip_grid(
      quant_on_chip_kernel<kClip, kNoise, kResid, kUniform, V>, a.nb,
      oc_smem(a.C, a.width, 3), a.stream, a.x, a.noise, a.resid, a.uniform,
      a.w, a.norm_part, a.amax_part, a.out, a.resid_out, a.clip, a.C, a.P,
      a.width);
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
  const int b = blockIdx.x;
  const long long lo = static_cast<long long>(b) * kChunk;
  const long long hi = lo + kChunk < P ? lo + kChunk : P;
  for (int c = blockIdx.y; c < C; c += gridDim.y) {
    // every warp finishes the row's norm itself: same code, same bits
    const float sc =
        kClip ? clip_scale(finish_sum(norm_part, nb, C, c), clip) : 1.0f;
    const long long row = static_cast<long long>(c) * P;
    float m = 0.0f;
#pragma unroll 8
    for (long long p = lo + threadIdx.x; p < hi; p += kThreads)
      m = fmaxf(m, fabsf(released<kClip, kNoise, kResid>(x, noise, resid,
                                                          row + p, sc)));
    m = block_max(m, red);
    if (threadIdx.x == 0) amax_part[static_cast<long long>(b) * C + c] = m;
    __syncthreads();  // red is reused by the next row
  }
}

// row c's clip scale and quantization scale from the partials, in the
// order quant_reduce_kernel finishes them; called by a whole warp
template <bool kClip>
__device__ __forceinline__ float2 row_scales(const float* norm_part,
                                             const float* amax_part, int nb,
                                             float clip, int C, int c) {
  const float sc =
      kClip ? clip_scale(finish_sum(norm_part, nb, C, c), clip) : 1.0f;
  const float amax = finish_max(amax_part, nb, C, c);
  return make_float2(sc, fmaxf(__fdiv_rn(amax, kInt8Levels), kScaleFloor));
}

// past kSmemRows clients: one warp a row, both scales once, into
// scales[0..C) (clip) and scales[C..2C) (quantization)
template <bool kClip>
__global__ void __launch_bounds__(kThreads)
quant_scales_kernel(const float* __restrict__ norm_part,
                    const float* __restrict__ amax_part, int nb, float clip,
                    float* __restrict__ scales, int C) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= C) return;  // the whole warp leaves together
  const float2 s = row_scales<kClip>(norm_part, amax_part, nb, clip, C, c);
  if (threadIdx.x % 32 == 0) {
    scales[c] = s.x;
    scales[C + c] = s.y;
  }
}

// kShared: the block finishes the scales into shared memory; else it
// reads them from `scales` (quant_scales_kernel's)
template <bool kClip, bool kNoise, bool kResid, bool kUniform, bool kShared>
__global__ void __launch_bounds__(kThreads)
quant_reduce_kernel(const float* __restrict__ x,
                    const float* __restrict__ noise,
                    const float* __restrict__ resid,
                    const float* __restrict__ uniform,
                    const float* __restrict__ w,
                    const float* __restrict__ norm_part,
                    const float* __restrict__ amax_part, int nb, float clip,
                    const float* __restrict__ scales,
                    float* __restrict__ out, float* __restrict__ resid_out,
                    int C, long long P) {
  extern __shared__ float sm[];  // [2 C] with kShared
  if constexpr (kShared) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = warp; c < C; c += kWarps) {
      const float2 s =
          row_scales<kClip>(norm_part, amax_part, nb, clip, C, c);
      if (lane == 0) {
        sm[c] = s.x;
        sm[C + c] = s.y;
      }
    }
    __syncthreads();
  }

  const long long base = static_cast<long long>(blockIdx.x) * kBlockCols +
                         threadIdx.x;
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float wc = __ldg(w + c);
    const float sc = kShared ? sm[c] : __ldg(scales + c);
    const float s = kShared ? sm[C + c] : __ldg(scales + C + c);
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
  const dim3 rows = row_grid(a.nb, a.C);
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
  if (a.C <= kSmemRows) {
    const size_t smem = 2 * static_cast<size_t>(a.C) * sizeof(float);
    quant_reduce_kernel<kClip, kNoise, kResid, kUniform, true>
        <<<blocks, kThreads, smem, a.stream>>>(
            a.x, a.noise, a.resid, a.uniform, a.w, a.norm_part, a.amax_part,
            a.nb, a.clip, nullptr, a.out, a.resid_out, a.C, a.P);
    return static_cast<int>(cudaGetLastError());
  }
  float* scales = a.amax_part + static_cast<long long>(a.nb) * a.C;
  quant_scales_kernel<kClip>
      <<<static_cast<unsigned>((a.C + kWarps - 1) / kWarps), kThreads, 0,
         a.stream>>>(a.norm_part, a.amax_part, a.nb, a.clip, scales, a.C);
  const int err2 = static_cast<int>(cudaGetLastError());
  if (err2 != 0) return err2;
  quant_reduce_kernel<kClip, kNoise, kResid, kUniform, false>
      <<<blocks, kThreads, 0, a.stream>>>(
          a.x, a.noise, a.resid, a.uniform, a.w, a.norm_part, a.amax_part,
          a.nb, a.clip, scales, a.out, a.resid_out, a.C, a.P);
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

}  // namespace

// C entry, bound with ctypes, on `stream` (PyTorch's current stream).
// clip > 0 turns the DP release on; noise, resid and uniform may each be
// null (noise only with clip > 0); resid_out is written when resid is
// given. width selects the design: 0 the three passes (norm_part holds
// nb * C floats and amax_part (nb + 2) * C, nb = ceil(P / 8192)), else the
// on-chip launch, width the columns a block owns, which must be
// 4 ceil(ceil(P / 128) / 4), and nb = ceil(P / width) blocks, the
// partials C * nb floats each; the wrapper
// computes both from the same rules and passes them for a check. The
// on-chip launch returns cudaErrorCooperativeLaunchTooLarge when its grid
// cannot be resident at once. Allocates nothing, does not synchronise;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a bad size,
// a design's mismatch or noise without the clip.
extern "C" int quant_clip_reduce_launch(
    const float* x, const float* noise, const float* resid,
    const float* uniform, const float* w, float* norm_part, float* amax_part,
    float* out, float* resid_out, float clip, int C, long long P,
    long long nb, long long width, void* stream) {
  const bool has_clip = clip > 0.0f;
  const bool on_chip = width != 0;
  if (C < 1 || P < 1 ||
      (on_chip ? width != oc_width(P) || nb != (P + width - 1) / width
               : nb != num_chunks(P)) ||
      (noise != nullptr && !has_clip) ||
      (resid != nullptr) != (resid_out != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,    noise,     resid,     uniform,
               w,    norm_part, amax_part, out,
               resid_out, clip, C,         P,
               static_cast<int>(nb), static_cast<int>(width),
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
