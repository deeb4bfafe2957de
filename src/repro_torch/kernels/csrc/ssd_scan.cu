// Mamba2 SSD chunked scan, written by hand for Hopper (sm_90a), CUDA
// cores only.
//
// Replaces: src/repro/kernels/ssd_scan.py::_ssd_kernel (the pallas_call
// in ssd_scan_bhsp).
//
// Inputs x (b, s, h, p), B and C (b, s, n) (ngroups = 1: shared by every
// head), all float or all bf16; dt (b, s, h), A_log (h,) and D (h,) f32;
// all contiguous, s a multiple of the chunk L (the wrapper pads with
// dt = 0, an exact identity). Outputs y (b, s, h, p) in x's type and,
// when the pointer is not null, the final state (b, h, p, n) in f32: the
// decode cache a prefill hands on (the TPU kernel keeps it in VMEM only).
// Per head, with a = -exp(A_log) and cs the inclusive cumsum of dt * a
// over the chunk, each chunk computes as the TPU kernel does
//   scores(i, j) = (C_i . B_j) * exp(cs_i - cs_j) * dt_j      (j <= i)
//   y_i  = sum_j scores(i, j) x_j + exp(cs_i) * state C_i + D x_i
//   state = exp(cs_L) * state + sum_j (x_j dt_j exp(cs_L - cs_j)) B_j^T
// with every product in f32 from upcast inputs.
//
// Bound on the H100 SXM at its 700 W limit (data-sheet rates: 3.35 TB/s,
// 989 TFLOP/s bf16 dense, 67 TFLOP/s f32): at mamba2-780m's prefill (b 4,
// s 2048, h 48, p 64, n 128, L 128, bf16) the scan moves ~113 MB with the
// final state, ~34 us of bytes, and does ~23 GFLOP (the causal triangles
// of C.B^T and of the y product, the state's two products; ~32 GFLOP
// counting the triangles in full): ~23 us at the bf16 tensor-core rate,
// ~340 us at the f32 CUDA-core rate. The simple design: one block of 256 threads per
// (batch, head), walking the chunks in order with the (p, n) state
// resident in shared memory (the TPU kernel's sequential chunk axis as a
// loop). A chunk stages x and B as f32 in shared memory; the rows of C
// and of the score matrix go through in blocks of 32, so that at L 128,
// p 64, n 128 the block needs 166 KB of the 227 KB, not the 256 KB of
// whole f32 tiles. Rows are padded by one float, so a warp walking
// neighbouring rows hits 32 different banks. Each of the three products
// (C.B^T, the y rows, the state update) gives every thread a register
// tile (4 x 4, 4 x 2, 8 x 4 outputs), so one shared-memory load feeds
// 2 to 2.7 FMAs and the tile's independent sums hide the loads' latency.
// The cumsum is a warp scan. Parallelism is b * h blocks (192 at batch 4
// on 132 SMs, 48 at batch 1); a chunk-parallel state pass, tensor cores
// and sharing C.B^T across the heads of a batch are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRowBlock = 32;   // rows of C and of the scores at a time
constexpr int kMaxChunk = 128;  // L: four 32-column groups, four scan warps
constexpr int kMaxP = 64;       // p: two 32-column groups; 8 warps x 8 rows
constexpr int kMaxN = 128;      // n: four 32-column groups
// row strides of the shared tiles, padded by one float
constexpr int kNS = kMaxN + 1;
constexpr int kPS = kMaxP + 1;
constexpr int kLS = kMaxChunk + 1;
constexpr int kSmemFloats = kMaxChunk * kNS + kMaxChunk * kPS + kMaxP * kNS +
                            kRowBlock * kNS + kRowBlock * kLS + 2 * kMaxChunk;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The tiles are sized for the largest shape (L 128, p 64, n 128) and the
// parts past the call's L, p and n are zero, so the register tiles below
// need no bounds on their loads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv,
                T* __restrict__ y, float* __restrict__ state_out, int S,
                int H, int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                      // (L, n)  B of the chunk
  float* xs = bs + kMaxChunk * kNS;      // (L, p)  x, then x dt exp(cs_L - cs)
  float* st = xs + kMaxChunk * kPS;      // (p, n)  the running state
  float* cblk = st + kMaxP * kNS;        // (32, n) a block of C rows
  float* sc = cblk + kRowBlock * kNS;    // (32, L) a block of score rows
  float* cs = sc + kRowBlock * kLS;      // (L)     cumsum of dt * a
  float* dts = cs + kMaxChunk;           // (L)     dt
  __shared__ float warp_tot[kMaxChunk / 32];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float a = -expf(A_log[h]);
  const float d = Dv[h];

  for (int i = tid; i < kMaxP * kNS; i += kThreads) st[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += L) {
    // ---- stage the chunk: x, B, dt (zero past L, p, n) ----
    for (int i = tid; i < kMaxChunk * kMaxP; i += kThreads) {
      const int j = i / kMaxP, pp = i % kMaxP;
      xs[j * kPS + pp] =
          j < L && pp < P
              ? to_f32(x[((static_cast<size_t>(b) * S + c0 + j) * H + h) * P +
                         pp])
              : 0.0f;
    }
    for (int i = tid; i < kMaxChunk * kMaxN; i += kThreads) {
      const int j = i / kMaxN, nn = i % kMaxN;
      bs[j * kNS + nn] =
          j < L && nn < N
              ? to_f32(Bm[(static_cast<size_t>(b) * S + c0 + j) * N + nn])
              : 0.0f;
    }
    // ---- cs = inclusive cumsum of dt * a: a warp scan, then the warps'
    // totals; past L, dt = 0 and cs stays at cs_L ----
    float run = 0.0f;
    if (tid < kMaxChunk) {
      const float dtv =
          tid < L ? dt[(static_cast<size_t>(b) * S + c0 + tid) * H + h] : 0.0f;
      dts[tid] = dtv;
      run = dtv * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += up;
      }
      if (lane == 31) warp_tot[warp] = run;
    }
    __syncthreads();
    if (tid < kMaxChunk) {
      for (int w = 0; w < warp; ++w) run += warp_tot[w];
      cs[tid] = run;
    }
    __syncthreads();

    // ---- y, 32 rows at a time; warp w owns rows 4w..4w+3 ----
    for (int i0 = 0; i0 < L; i0 += kRowBlock) {
      for (int i = tid; i < kRowBlock * kMaxN; i += kThreads) {
        const int r = i / kMaxN, nn = i % kMaxN;
        cblk[r * kNS + nn] =
            i0 + r < L && nn < N
                ? to_f32(
                      Cm[(static_cast<size_t>(b) * S + c0 + i0 + r) * N + nn])
                : 0.0f;
      }
      __syncthreads();
      // scores(i, j) = (C_i . B_j) * exp(cs_i - cs_j) * dt_j for j <= i:
      // a 4 x 4 register tile, columns lane + 32k for the groups k that
      // hold any j <= i0 + 31
      const int kmax = min(i0, L - 1) / 32;
      {
        float acc[4][4] = {};
        for (int nn = 0; nn < N; ++nn) {
          float cv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) cv[q] = cblk[(warp * 4 + q) * kNS + nn];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k > kmax) break;
            const float bv = bs[(lane + 32 * k) * kNS + nn];
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[q][k] = fmaf(cv[q], bv, acc[q][k]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = warp * 4 + q, i = i0 + r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = lane + 32 * k;
            sc[r * kLS + j] = k <= kmax && j <= i && i < L
                                  ? acc[q][k] * expf(cs[i] - cs[j]) * dts[j]
                                  : 0.0f;
          }
        }
      }
      __syncthreads();
      // y_i = scores x + exp(cs_i) (C_i . state) + D x_i: a 4 x 2 tile,
      // columns lane and lane + 32 of p
      {
        const int jmax = min(i0 + kRowBlock, L);
        float intra[4][2] = {};
        for (int j = 0; j < jmax; ++j) {
          const float x0 = xs[j * kPS + lane], x1 = xs[j * kPS + lane + 32];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float sv = sc[(warp * 4 + q) * kLS + j];
            intra[q][0] = fmaf(sv, x0, intra[q][0]);
            intra[q][1] = fmaf(sv, x1, intra[q][1]);
          }
        }
        float inter[4][2] = {};
        for (int nn = 0; nn < N; ++nn) {
          const float s0 = st[lane * kNS + nn], s1 = st[(lane + 32) * kNS + nn];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float cv = cblk[(warp * 4 + q) * kNS + nn];
            inter[q][0] = fmaf(cv, s0, inter[q][0]);
            inter[q][1] = fmaf(cv, s1, inter[q][1]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + warp * 4 + q;
          if (i >= L) continue;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int pp = lane + 32 * c;
            if (pp >= P) continue;
            const float out = intra[q][c] + expf(cs[i]) * inter[q][c] +
                              d * xs[i * kPS + pp];
            y[((static_cast<size_t>(b) * S + c0 + i) * H + h) * P + pp] =
                from_f32<T>(out);
          }
        }
      }
      __syncthreads();
    }

    // ---- state = exp(total) state + (x dt exp(total - cs))^T B: an 8 x 4
    // tile, rows 8w..8w+7 of p, columns lane + 32k of n ----
    const float total = cs[L - 1];
    for (int i = tid; i < L * kMaxP; i += kThreads) {
      const int j = i / kMaxP, pp = i % kMaxP;
      xs[j * kPS + pp] = xs[j * kPS + pp] * dts[j] * expf(total - cs[j]);
    }
    __syncthreads();
    {
      const float decay = expf(total);
      float acc[8][4] = {};
      for (int j = 0; j < L; ++j) {
        float bv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = bs[j * kNS + lane + 32 * k];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float xv = xs[j * kPS + warp * 8 + q];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[q][k] = fmaf(xv, bv[k], acc[q][k]);
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float* sp = st + (warp * 8 + q) * kNS + lane + 32 * k;
          *sp = decay * *sp + acc[q][k];
        }
      }
    }
    __syncthreads();
  }

  if (state_out != nullptr) {
    float* so = state_out + static_cast<size_t>(bh) * P * N;
    for (int i = tid; i < P * N; i += kThreads)
      so[i] = st[(i / N) * kNS + i % N];
  }
}

}  // namespace

// C entry, bound with ctypes. dtype 0 is float, 1 is bf16 (x, B, C, y);
// state_out may be null. Launches on `stream` (PyTorch's current stream),
// allocates nothing, does not synchronise; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a chunk outside 1..128, s not a multiple of
// the chunk, p outside 1..64 or n outside 1..128.
extern "C" int ssd_scan_launch(const void* x, const float* dt,
                               const float* A_log, const void* Bm,
                               const void* Cm, const float* Dv, void* y,
                               float* state_out, int batch, int S, int H,
                               int P, int N, int L, int dtype, void* stream) {
  if (L < 1 || L > kMaxChunk || S % L != 0 || P < 1 || P > kMaxP ||
      N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch * H);
  if (dtype == 0) {
    cudaFuncSetAttribute(ssd_scan_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    ssd_scan_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), dt, A_log,
        static_cast<const float*>(Bm), static_cast<const float*>(Cm), Dv,
        static_cast<float*>(y), state_out, S, H, P, N, L);
  } else if (dtype == 1) {
    cudaFuncSetAttribute(ssd_scan_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    ssd_scan_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), dt, A_log,
        static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(Cm), Dv,
        static_cast<__nv_bfloat16*>(y), state_out, S, H, P, N, L);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
