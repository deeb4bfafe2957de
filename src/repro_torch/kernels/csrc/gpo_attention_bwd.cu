// GPO neural-process attention, backward, written by hand for Hopper
// (sm_90a), CUDA cores only: one kernel for dq, one for dk and dv.
//
// Replaces: src/repro/kernels/gpo_attention.py::_gpo_bwd_dq_kernel and
// ::_gpo_bwd_dkdv_kernel (the two pallas_calls in _gpo_backward).
//
// Inputs q, k, v, do (BH, S, HD) f32 contiguous, lse and delta (BH, S)
// f32 (the forward's logsumexp and rowsum(do * o)). Key j is allowed for
// query i iff j < num_ctx (a context key) or j == i (a target's own key).
// Per allowed pair (i, j), recomputed from q and k, never stored:
//
//   s = q_i . k_j * scale     p = exp(s - lse_i)     dp = do_i . v_j
//   ds = p * (dp - delta_i) * scale
//   dq_i += ds * k_j          dk_j += ds * q_i       dv_j += p * do_i
//
// Bound on the H100: at the training shapes (BH = 40 client-heads,
// S = 160, num_ctx = 80, HD = 32) one call moves ~4-5 MB and does
// ~0.1 GFLOP of f32 CUDA-core work, each about 1.3-2 us of the card, so
// the bound is about even between bytes and operations; a call is held
// back by its launch and by each thread's serial walk over its keys.
//
// The design: one thread owns one output row, so nothing crosses blocks
// and there are no atomics; a result depends on neither the grid order
// nor the batch. dq: one block per (bh, 64 query rows); the block walks
// the context keys [0, num_ctx) in 32-key shared-memory tiles of k and v,
// then each target row adds its own key once (the TPU kernel's band as a
// loop). dk/dv: one block per (bh, 64 key rows); a context key is read by
// every query row, so its thread sweeps all S rows in 32-row shared-
// memory tiles of q, do, lse and delta; a target key j is read by query j
// alone and takes one term (the TPU kernel's transposed band). Masked
// pairs are skipped, never computed with -1e30.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kRows = 64;  // output rows (threads) per block
constexpr int kTile = 32;  // keys (dq) or query rows (dk/dv) per tile

template <int HD>
__global__ void __launch_bounds__(kRows)
gpo_attention_bwd_dq_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int S, int num_ctx,
                            float scale) {
  __shared__ float ks[kTile][HD];
  __shared__ float vs[kTile][HD];
  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * S;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < S;  // dead threads still join every barrier

  float qr[HD];
  float dor[HD];
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    const size_t g = base + static_cast<size_t>(row) * HD + d;
    qr[d] = live ? q[g] : 0.0f;
    dor[d] = live ? dout[g] : 0.0f;
    acc[d] = 0.0f;
  }
  const float l = live ? lse[rbase + row] : 0.0f;
  const float dl = live ? delta[rbase + row] : 0.0f;

  for (int k0 = 0; k0 < num_ctx; k0 += kTile) {
    const int n = min(kTile, num_ctx - k0);  // real keys in the tile
    for (int i = threadIdx.x; i < kTile * HD; i += kRows) {
      const int j = i / HD;
      const int d = i % HD;
      const size_t g = base + static_cast<size_t>(k0 + j) * HD + d;
      ks[j][d] = j < n ? k[g] : 0.0f;
      vs[j][d] = j < n ? v[g] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float s = 0.0f;
      float dp = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s = fmaf(qr[d], ks[j][d], s);
        dp = fmaf(dor[d], vs[j][d], dp);
      }
      const float p = expf(s * scale - l);
      const float ds = p * (dp - dl) * scale;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
    __syncthreads();
  }

  if (live && row >= num_ctx) {  // a target row: its own key, once
    const float* kr = k + base + static_cast<size_t>(row) * HD;
    const float* vr = v + base + static_cast<size_t>(row) * HD;
    float s = 0.0f;
    float dp = 0.0f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      s = fmaf(qr[d], kr[d], s);
      dp = fmaf(dor[d], vr[d], dp);
    }
    const float p = expf(s * scale - l);
    const float ds = p * (dp - dl) * scale;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < HD; ++d)
      dq[base + static_cast<size_t>(row) * HD + d] = acc[d];
  }
}

template <int HD>
__global__ void __launch_bounds__(kRows)
gpo_attention_bwd_dkdv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int S, int num_ctx, float scale) {
  __shared__ float qs[kTile][HD];
  __shared__ float dos[kTile][HD];
  __shared__ float ls[kTile];
  __shared__ float dls[kTile];
  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * S;
  const int key = blockIdx.x * kRows + threadIdx.x;
  const bool live = key < S;
  const bool ctx_key = key < num_ctx;  // num_ctx <= S, so also live

  float kr[HD];
  float vr[HD];
  float dka[HD];
  float dva[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    const size_t g = base + static_cast<size_t>(key) * HD + d;
    kr[d] = live ? k[g] : 0.0f;
    vr[d] = live ? v[g] : 0.0f;
    dka[d] = 0.0f;
    dva[d] = 0.0f;
  }

  // a context key in the block: every query row reads it, so sweep all
  // S rows (a uniform condition per block, so every thread joins every
  // barrier; the block's target keys only help stage the tiles)
  if (static_cast<int>(blockIdx.x) * kRows < num_ctx) {
    for (int i0 = 0; i0 < S; i0 += kTile) {
      const int n = min(kTile, S - i0);
      for (int t = threadIdx.x; t < kTile * HD; t += kRows) {
        const int i = t / HD;
        const int d = t % HD;
        const size_t g = base + static_cast<size_t>(i0 + i) * HD + d;
        qs[i][d] = i < n ? q[g] : 0.0f;
        dos[i][d] = i < n ? dout[g] : 0.0f;
      }
      if (threadIdx.x < kTile) {
        const int i = threadIdx.x;
        ls[i] = i < n ? lse[rbase + i0 + i] : 0.0f;
        dls[i] = i < n ? delta[rbase + i0 + i] : 0.0f;
      }
      __syncthreads();
      if (ctx_key) {
        for (int i = 0; i < n; ++i) {
          float s = 0.0f;
          float dp = 0.0f;
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            s = fmaf(qs[i][d], kr[d], s);
            dp = fmaf(dos[i][d], vr[d], dp);
          }
          const float p = expf(s * scale - ls[i]);
          const float ds = p * (dp - dls[i]) * scale;
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            dva[d] = fmaf(p, dos[i][d], dva[d]);
            dka[d] = fmaf(ds, qs[i][d], dka[d]);
          }
        }
      }
      __syncthreads();
    }
  }

  if (live && !ctx_key) {  // a target key: read by its own query alone
    const float* qr = q + base + static_cast<size_t>(key) * HD;
    const float* dr = dout + base + static_cast<size_t>(key) * HD;
    float s = 0.0f;
    float dp = 0.0f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      s = fmaf(qr[d], kr[d], s);
      dp = fmaf(dr[d], vr[d], dp);
    }
    const float p = expf(s * scale - lse[rbase + key]);
    const float ds = p * (dp - delta[rbase + key]) * scale;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dva[d] = p * dr[d];
      dka[d] = ds * qr[d];
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      const size_t g = base + static_cast<size_t>(key) * HD + d;
      dk[g] = dka[d];
      dv[g] = dva[d];
    }
  }
}

template <int HD>
void launch_dq(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dq, int bh, int S, int num_ctx, float scale,
               cudaStream_t st) {
  const dim3 grid((S + kRows - 1) / kRows, bh);
  gpo_attention_bwd_dq_kernel<HD><<<grid, kRows, 0, st>>>(
      q, k, v, dout, lse, delta, dq, S, num_ctx, scale);
}

template <int HD>
void launch_dkdv(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* delta,
                 float* dk, float* dv, int bh, int S, int num_ctx,
                 float scale, cudaStream_t st) {
  const dim3 grid((S + kRows - 1) / kRows, bh);
  gpo_attention_bwd_dkdv_kernel<HD><<<grid, kRows, 0, st>>>(
      q, k, v, dout, lse, delta, dk, dv, S, num_ctx, scale);
}

float softmax_scale(int hd) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
}

}  // namespace

// C entries, bound with ctypes. Each launches on `stream` (PyTorch's
// current stream), allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head width that is
// not instantiated here.
extern "C" int gpo_attention_bwd_dq_launch(const float* q, const float* k,
                                           const float* v, const float* dout,
                                           const float* lse,
                                           const float* delta, float* dq,
                                           int bh, int S, int num_ctx, int hd,
                                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = softmax_scale(hd);
  switch (hd) {
    case 24:
      launch_dq<24>(q, k, v, dout, lse, delta, dq, bh, S, num_ctx, scale, st);
      break;
    case 32:
      launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, S, num_ctx, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gpo_attention_bwd_dkdv_launch(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dk, float* dv, int bh,
    int S, int num_ctx, int hd, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = softmax_scale(hd);
  switch (hd) {
    case 24:
      launch_dkdv<24>(q, k, v, dout, lse, delta, dk, dv, bh, S, num_ctx,
                      scale, st);
      break;
    case 32:
      launch_dkdv<32>(q, k, v, dout, lse, delta, dk, dv, bh, S, num_ctx,
                      scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
