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
// on the fly, then the quantize/reduce sweep. Here, with no grid order
// and no atomics (client_rows.cuh):
//   1. (clip > 0) row_sumsq_kernel: per-chunk partial squared norms;
//   2. row_absmax_kernel on a (nb, C) grid: block (b, c) finishes row c's
//      norm from the partials (every warp, the same fixed order), builds
//      u on its chunk and writes the chunk's max |u|. A max is exact in
//      any order;
//   3. quant_reduce_kernel, a grid over P: each block finishes all C clip
//      scales and quantization scales into shared memory, then each
//      thread takes 4 columns and walks the clients 0..C-1 in order.
// u is rebuilt in passes 2 and 3 from the operands in the TPU kernel's
// op order, one rounding per op (the _rn intrinsics keep nvcc from
// fusing into an FMA), so both passes see the same bits and no (C, P)
// intermediate is stored. z = u / s is an IEEE division, and rint rounds
// half to even like jnp.round and torch.round (roundf would not).
// Two calls are bit-equal.
//
// Inputs x (C, P), noise, resid and uniform (C, P) or null, w (C,), all
// f32 contiguous; scratch norm_part (nb, C) (unused without the clip)
// and amax_part (nb, C), outputs out (P,) and resid_out (C, P) (with a
// residual only), allocated by the wrapper.
//
// Bound on the H100: bytes. Each input read once and each output written
// once: 4 (5 C P + P + C) bytes with every operand, 109 MB at the
// quickstart's (C, P) = (10, 534016), about 32.5 us at 3.35 TB/s. The
// design reads x three times and the noise and residual twice: 9 C P
// floats, 1.8x those bytes.
#include <cuda_runtime.h>

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
  float* out;
  float* resid_out;
  float clip;
  int C;
  long long P;
  int nb;
  cudaStream_t stream;
};

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

// indexed by clip * 8 + noise * 4 + resid * 2 + uniform; noise without
// the clip is refused before the table is read
constexpr LaunchFn kLaunch[16] = {
    launch<false, false, false, false>, launch<false, false, false, true>,
    launch<false, false, true, false>,  launch<false, false, true, true>,
    nullptr, nullptr, nullptr, nullptr,
    launch<true, false, false, false>,  launch<true, false, false, true>,
    launch<true, false, true, false>,   launch<true, false, true, true>,
    launch<true, true, false, false>,   launch<true, true, false, true>,
    launch<true, true, true, false>,    launch<true, true, true, true>};

}  // namespace

// C entry, bound with ctypes: two or three launches on `stream`
// (PyTorch's current stream). clip > 0 turns the DP release on; noise,
// resid and uniform may each be null (noise only with clip > 0);
// resid_out is written when resid is given. norm_part and amax_part hold
// nb * C floats each, nb = ceil(P / 8192), which the wrapper computes
// from the same chunk and passes for a check. Allocates nothing, does not
// synchronise; returns cudaGetLastError(), or cudaErrorInvalidValue for
// a bad size or noise without the clip.
extern "C" int quant_clip_reduce_launch(
    const float* x, const float* noise, const float* resid,
    const float* uniform, const float* w, float* norm_part, float* amax_part,
    float* out, float* resid_out, float clip, int C, long long P,
    long long nb, void* stream) {
  const bool has_clip = clip > 0.0f;
  if (C < 1 || C > kMaxRows || P < 1 || nb != num_chunks(P) ||
      (noise != nullptr && !has_clip) ||
      (resid != nullptr) != (resid_out != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,         noise, resid,    uniform,
               w,         norm_part, amax_part, out,
               resid_out, clip,  C,        P,
               static_cast<int>(nb), static_cast<cudaStream_t>(stream)};
  const int idx = (has_clip ? 8 : 0) + (noise != nullptr ? 4 : 0) +
                  (resid != nullptr ? 2 : 0) + (uniform != nullptr ? 1 : 0);
  return kLaunch[idx](a);
}
