// The DP-FedAvg reduction, written by hand for Hopper (sm_90a):
//   out[p] = sum_c w[c] * (x[c, p] * min(1, clip / max(|x_c|, 1e-12))
//                          + noise[c, p]),
// the noise term only when a presampled noise matrix is given.
//
// Replaces: src/repro/kernels/agg_reduce.py::_clip_reduce_kernel and
// _clip_reduce_noise_kernel (the pallas_call in clip_reduce_flat). That
// kernel runs a sequential (2, nb) grid: sweep 0 sums every client's
// squared norm into a (C, 1) scratch, sweep 1 scales, adds the noise and
// reduces. The norm must be whole before any column is scaled, which
// CUDA blocks, running in no order, cannot carry from one to the next.
//
// Bound on the H100: bytes. The function reads x and the noise once and
// writes (P,): 4 (2 C P + P + C) bytes with noise, 44.9 MB at the
// quickstart's (C, P) = (10, 534016), about 13.4 us at 3.35 TB/s; 23.5 MB
// and 7.0 us without. Measured times: PERF.md section 6, row 7.
//
// Two designs; the wrapper picks one from (C, P) and the card before any
// launch (agg_reduce.py::clip_design_for), and this entry re-checks it.
//
// On chip, where x fits in the card's shared memory (C <= 13 at P =
// 534016 on an H100 SXM): one cooperative launch of on_chip_rows.cuh's
// grid (128 blocks of 4172 columns at that P, one an SM), each block
// holding its columns of all C rows:
//   1. x's tile arrives (float4 loads when every row start is 16-byte
//      aligned, else single floats), per-row partial squared norms go to
//      norm_part (C, nb); the noise's first segments are issued;
//   2. one grid barrier (cooperative groups' grid sync);
//   3. every block finishes every row's clip scale in one fixed order;
//   4. with noise, y = x s + n in place in the tile, the noise streamed
//      once by row segments; then each column's out = sum_c w_c y_c
//      (without noise y = x s there), clients 0..C-1 in order.
// Reads x and the noise once and writes out once: exactly the bound's
// bytes.
//
// Two launches, for every (C, P) whose x does not fit (C >= 14 at P =
// 534016, any C on a card whose SMs cannot hold the grid at once), with
// no grid order and no atomics (client_rows.cuh):
//   1. row_sumsq_kernel on a (nb, C) grid writes per-chunk partial
//      squared norms to part (nb, C);
//   2. clip_reduce_kernel, a grid over P: each block first finishes the
//      C norms from the partials in a fixed order and turns them into
//      the clip scales (shared memory), then each thread takes 4 columns
//      (strided by the block) and walks the clients 0..C-1 in order.
//      Past kSmemRows clients clip_scales_kernel finishes each scale once
//      into the scratch, after the partials, and the reduce reads it
//      there (the same scales, bit for bit).
// It reads x twice, so it moves 1.5x (with noise) to 1.9x (without) the
// bound's bytes.
//
// Both designs: the released value in the TPU kernel's op order, one
// rounding per op (x s, then + n, then the weighted sum's fma). No atomics
// on values; two calls are bit-equal. The norm is summed in another order
// by each design, so a clip scale may differ by an ulp between them: the
// bits depend on which design the card's SMs and shared memory pick.
// Without noise no noise operand is read (no zero matrix).
//
// Inputs x (C, P), noise (C, P) or null, w (C,), all f32 contiguous;
// scratch part, (nb + 1) * C floats (the partials, then the scales past
// kSmemRows clients), and output out (P,) f32, allocated by the wrapper.
// Device memory is the only limit on C.
#include <cuda_runtime.h>

#include "on_chip_rows.cuh"

namespace {

using namespace client_rows;

// ---- on chip (on_chip_rows.cuh) ----

template <bool kNoise, int V>
__global__ void __launch_bounds__(kOcThreads, 1)
clip_on_chip_kernel(const float* __restrict__ x,
                    const float* __restrict__ noise,
                    const float* __restrict__ w,
                    float* __restrict__ norm_part, float* __restrict__ out,
                    float clip, int C, long long P, int width) {
  using Blk = OnChip<V>;
  using Seg1 = typename Blk::Seg1;
  extern __shared__ __align__(16) float oc_buf[];
  const Blk blk(oc_buf, C, P, width);
  float* scale = blk.rows;  // [C]
  float* wsm = scale + C;   // [C]
  const int warp = threadIdx.x / 32;
  for (int c = threadIdx.x; c < C; c += kOcThreads) wsm[c] = __ldg(w + c);
  Seg1 fa, fb;  // the noise, a warp's first segment in flight in the wait

  // 1. x into the tile, and the rows' squared norms
  blk.tile_norms(x, norm_part, [&] {
    if (kNoise && warp < blk.sg.nseg) blk.load_stream(fa, 0, noise, warp);
  });
  // 2. every block's partials written
  grid_barrier();
  // 3. the clip scales
  blk.clip_scales(norm_part, clip, scale);

  // 4. y = x s + n in place, then out = sum_c w_c y_c
  if constexpr (kNoise) {
    run_segments(blk.sg.nseg, fa, fb, [&](int q, Seg1& buf) {
      blk.load_stream(buf, 0, noise, q);
    }, [&](int q, Seg1& buf) {
      const int c = blk.sg.row(q);
      const float sc = scale[c];
#pragma unroll
      for (int k = 0; k < Blk::Segs::kPacks; ++k) {
        const int col = blk.sg.col(q, k);
        if (col < 0) continue;
        Pack<V> y = ld_shared<V>(blk.in_tile(c, col));
#pragma unroll
        for (int e = 0; e < V; ++e)
          y.v[e] = __fadd_rn(__fmul_rn(y.v[e], sc), buf[0][k].v[e]);
        st<V>(blk.in_tile(c, col), y);
      }
    });
    __syncthreads();
  }
  for (int k = threadIdx.x; k < blk.wb / V; k += kOcThreads) {
    Pack<V> acc;
#pragma unroll
    for (int i = 0; i < V; ++i) acc.v[i] = 0.0f;
    for (int c = 0; c < C; ++c) {
      const Pack<V> y = ld_shared<V>(blk.in_tile(c, k * V));
      const float wc = wsm[c], sc = scale[c];
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc.v[i] = fmaf(wc, kNoise ? y.v[i] : __fmul_rn(y.v[i], sc),
                        acc.v[i]);
    }
    st<V>(out + blk.col0 + k * V, acc);
  }
}

template <bool kNoise, int V>
int launch_on_chip(const float* x, const float* noise, const float* w,
                   float* part, float* out, float clip, int C, long long P,
                   int nb, int width, cudaStream_t stream) {
  // the clip scales and the weights
  return launch_on_chip_grid(clip_on_chip_kernel<kNoise, V>, nb,
                             oc_smem(C, width, 2), stream, x, noise, w, part,
                             out, clip, C, P, width);
}

// ---- two launches ----

// past kSmemRows clients: one warp a row, each clip scale once, into
// scales[C]
__global__ void __launch_bounds__(kThreads)
clip_scales_kernel(const float* __restrict__ part, int nb, float clip,
                   float* __restrict__ scales, int C) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= C) return;  // the whole warp leaves together
  const float sq = finish_sum(part, nb, C, c);
  if (threadIdx.x % 32 == 0) scales[c] = clip_scale(sq, clip);
}

// kShared: the block finishes the C scales into shared memory; else it
// reads them from `scales` (clip_scales_kernel's)
template <bool kNoise, bool kShared>
__global__ void __launch_bounds__(kThreads)
clip_reduce_kernel(const float* __restrict__ x,
                   const float* __restrict__ noise,
                   const float* __restrict__ w,
                   const float* __restrict__ part, int nb, float clip,
                   const float* __restrict__ scales,
                   float* __restrict__ out, int C, long long P) {
  extern __shared__ float sm[];  // [C] with kShared
  if constexpr (kShared) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = warp; c < C; c += kWarps) {
      const float sq = finish_sum(part, nb, C, c);
      if (lane == 0) sm[c] = clip_scale(sq, clip);
    }
    __syncthreads();
  }

  const long long base = static_cast<long long>(blockIdx.x) * kBlockCols +
                         threadIdx.x;
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float wc = __ldg(w + c),
                sc = kShared ? sm[c] : __ldg(scales + c);
    const long long row = static_cast<long long>(c) * P;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const long long p = base + static_cast<long long>(k) * kThreads;
      if (p < P) {
        float y = __fmul_rn(__ldg(x + row + p), sc);
        if (kNoise) y = __fadd_rn(y, __ldg(noise + row + p));
        acc[k] = fmaf(wc, y, acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const long long p = base + static_cast<long long>(k) * kThreads;
    if (p < P) out[p] = acc[k];
  }
}

template <bool kNoise, bool kShared>
void launch_reduce(const float* x, const float* noise, const float* w,
                   const float* part, const float* scales, float* out,
                   float clip, int C, long long P, int nb, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((P + kBlockCols - 1) / kBlockCols);
  const size_t smem = kShared ? static_cast<size_t>(C) * sizeof(float) : 0;
  clip_reduce_kernel<kNoise, kShared><<<blocks, kThreads, smem, st>>>(
      x, noise, w, part, nb, clip, scales, out, C, P);
}

int launch_two(const float* x, const float* noise, const float* w,
               float* part, float* out, float clip, int C, long long P,
               int nb, cudaStream_t st) {
  row_sumsq_kernel<<<row_grid(nb, C), kThreads, 0, st>>>(x, part, C, P);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (C <= kSmemRows) {
    (noise != nullptr ? launch_reduce<true, true>
                      : launch_reduce<false, true>)(
        x, noise, w, part, nullptr, out, clip, C, P, nb, st);
    return static_cast<int>(cudaGetLastError());
  }
  float* scales = part + static_cast<long long>(nb) * C;
  clip_scales_kernel<<<static_cast<unsigned>((C + kWarps - 1) / kWarps),
                       kThreads, 0, st>>>(part, nb, clip, scales, C);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  (noise != nullptr ? launch_reduce<true, false> : launch_reduce<false, false>)(
      x, noise, w, part, scales, out, clip, C, P, nb, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes, on `stream` (PyTorch's current stream).
// noise may be null (the clip-only kernels). width selects the design: 0
// the two launches (part holds (nb + 1) * C floats, nb = ceil(P / 8192)), else
// the on-chip launch, width the columns a block owns, which must be
// 4 ceil(ceil(P / 128) / 4), and nb = ceil(P / width) blocks, part nb * C
// floats; the wrapper computes both from the same rules and passes them
// for a check. The on-chip launch returns
// cudaErrorCooperativeLaunchTooLarge when its grid cannot be resident at
// once. Allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a bad size, a design's
// mismatch or clip <= 0.
extern "C" int clip_reduce_launch(const float* x, const float* noise,
                                  const float* w, float* part, float* out,
                                  float clip, int C, long long P,
                                  long long nb, long long width,
                                  void* stream) {
  const bool on_chip = width != 0;
  if (C < 1 || P < 1 || !(clip > 0.0f) ||
      (on_chip ? width != oc_width(P) || nb != (P + width - 1) / width
               : nb != num_chunks(P)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(nb), wd = static_cast<int>(width);
  if (!on_chip) return launch_two(x, noise, w, part, out, clip, C, P, n, st);
  const bool vec = P % 4 == 0 && aligned16(x) && aligned16(noise) &&
                   aligned16(out);
  if (noise != nullptr)
    return (vec ? launch_on_chip<true, 4> : launch_on_chip<true, 1>)(
        x, noise, w, part, out, clip, C, P, n, wd, st);
  return (vec ? launch_on_chip<false, 4> : launch_on_chip<false, 1>)(
      x, noise, w, part, out, clip, C, P, n, wd, st);
}
