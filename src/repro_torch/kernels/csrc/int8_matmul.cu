// Int8 weight-only inference matmul for the GPO serving path, written by
// hand for Hopper (sm_90a), f32 FMAs on the CUDA cores.
//
// Replaces: src/repro/kernels/quant_matmul.py::_int8_matmul_kernel
// (the pallas_call in int8_matmul_flat).
//
// Computes out[m, n] = (sum_k x[m, k] * float(q[k, n])) * scale[n]:
// x (M, K) f32 row-major, q (K, N) int8 row-major, scale (N,) f32,
// out (M, N) f32. The scale is applied after the K reduction.
//
// Bound on the H100: at serving shapes (M <= 1280, K <= 256, N <= 256) a
// call moves <= ~2 MB and does <= ~168 MFLOP. At the decode step's
// (320, 128) x (128, 256) that is 21 MFLOP, 0.31 us at 67 TFLOP/s f32 and
// less in bytes, so latency and parallelism bound it, not bytes or
// operations. The design is for that:
//  * small output tiles, 16 rows x 32 columns, so the engine step's
//    shapes launch 160 (M 320, N 256) to 640 (M 1280) blocks on 132 SMs;
//  * K in chunks of 128 staged in shared memory by cp.async with 16-byte
//    copies (a float4 of x, 16 int8 of q), two chunks in flight: for
//    K <= 256 every copy is issued up front and each chunk waits once;
//    longer K (4098 at the paper's width) streams through the two stages.
//    Unaligned operands (K or N not a multiple of 4 or 16, as the head's
//    N = 1) take 4-byte copies of x and plain loads of q. Rows, columns and
//    K past the edge are zero-filled and never stored;
//  * 128 threads: 32 sub-tiles of 4 x 4 outputs, each summed over K by 4
//    neighbouring lanes, lane j taking every fourth group of 4 k in
//    ascending order; the 4 partial sums are then added by a fixed xor
//    butterfly. Each q word (4 int8) is widened once for 16 FMAs by
//    byte permutes into 2^23 + (b + 128) and one subtract, exactly;
//  * q rows sit 32 bytes apart with 32 more after every 4 rows, so the
//    4 k-lanes read 4 distinct 32-byte bank groups (conflict-free).
// No atomics and no split of K across warps or blocks: an output's sum is
// in a fixed order that depends only on K, so a row's result does
// not depend on M or on the other rows (the serving cache's hit == miss
// contract).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 16;        // output rows per block
constexpr int kBN = 32;        // output columns per block
constexpr int kKC = 128;       // K per shared-memory chunk
constexpr int kThreads = 128;  // 32 sub-tiles x 4 k-lanes
constexpr int kQBytes = kBN * (kKC + kKC / 4);  // a chunk of q, padded

// byte offset of q row r (of kBN int8) within a chunk
__device__ __forceinline__ int q_off(int r) { return kBN * (r + (r >> 2)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared, zero-filled when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte c of w (4 int8, sign bits flipped) as float: the bits of
// 2^23 + (b + 128), less 2^23 + 128
__device__ __forceinline__ float widen(uint32_t w, uint32_t c) {
  const uint32_t bits = __byte_perm(w, 0x4B000000u, 0x7540u | c);
  return __int_as_float(static_cast<int>(bits)) - 8388736.0f;
}

template <bool kVecX, bool kVecQ>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int N, int K, int vec_out) {
  __shared__ __align__(16) float xs[2][kBM][kKC];
  __shared__ __align__(16) int8_t qs[2][kQBytes];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  auto load_chunk = [&](int c, int stage) {
    const int k0 = c * kKC;
    if (kVecX) {  // K % 4 == 0: a float4 is wholly in or out
      for (int i = tid; i < kBM * kKC / 4; i += kThreads) {
        const int r = i / (kKC / 4);
        const int kk = (i % (kKC / 4)) * 4;
        const bool in = m0 + r < M && k0 + kk < K;
        const float* src =
            x + (in ? static_cast<size_t>(m0 + r) * K + k0 + kk : 0);
        cp_async16(smem_addr(&xs[stage][r][kk]), src, in);
      }
    } else {
      for (int i = tid; i < kBM * kKC; i += kThreads) {
        const int r = i / kKC;
        const int kk = i % kKC;
        const bool in = m0 + r < M && k0 + kk < K;
        const float* src =
            x + (in ? static_cast<size_t>(m0 + r) * K + k0 + kk : 0);
        cp_async4(smem_addr(&xs[stage][r][kk]), src, in);
      }
    }
    if (kVecQ) {  // N % 16 == 0: 16 columns are wholly in or out
      for (int i = tid; i < kKC * (kBN / 16); i += kThreads) {
        const int r = i / (kBN / 16);
        const int cc = (i % (kBN / 16)) * 16;
        const bool in = k0 + r < K && n0 + cc < N;
        const int8_t* src =
            q + (in ? static_cast<size_t>(k0 + r) * N + n0 + cc : 0);
        cp_async16(smem_addr(&qs[stage][q_off(r) + cc]), src, in);
      }
    } else {
      for (int i = tid; i < kKC * kBN; i += kThreads) {
        const int r = i / kBN;
        const int cc = i % kBN;
        const bool in = k0 + r < K && n0 + cc < N;
        qs[stage][q_off(r) + cc] =
            in ? q[static_cast<size_t>(k0 + r) * N + n0 + cc] : int8_t{0};
      }
    }
  };

  const int n_chunks = (K + kKC - 1) / kKC;
  if (n_chunks > 0) {
    load_chunk(0, 0);
    cp_async_commit();
  }
  if (n_chunks > 1) {
    load_chunk(1, 1);
    cp_async_commit();
  }

  const int kl = tid & 3;              // k-lane
  const int rb = (tid >> 5) * 4;       // sub-tile rows rb..rb+3 (a warp's)
  const int cb = ((tid >> 2) & 7) * 4;  // sub-tile columns cb..cb+3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int stage = c & 1;
    const int groups = (min(kKC, K - c * kKC) + 3) / 4;
    for (int gi = kl; gi < groups; gi += 4) {
      float4 xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(&xs[stage][rb + i][4 * gi]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int8_t* qrow = &qs[stage][q_off(4 * gi + kk) + cb];
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(qrow) ^ 0x80808080u;
        float qv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) qv[j] = widen(w, j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xk = kk == 0 ? xv[i].x
                           : kk == 1 ? xv[i].y
                           : kk == 2 ? xv[i].z
                                     : xv[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xk, qv[j], acc[i][j]);
        }
      }
    }
    if (c + 2 < n_chunks) {
      __syncthreads();  // every lane is done with this stage
      load_chunk(c + 2, stage);
      cp_async_commit();
    }
  }

  // the 4 k-lanes' partial sums, added in a fixed order
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 1);
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 2);
    }

  // lane kl stores row rb + kl of the sub-tile
  const int gm = m0 + rb + kl;
  const int gn = n0 + cb;
  if (gm >= M) return;
  float row[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    row[j] = kl == 0 ? acc[0][j] : kl == 1 ? acc[1][j] : kl == 2 ? acc[2][j]
                                                                 : acc[3][j];
  float* dst = out + static_cast<size_t>(gm) * N + gn;
  if (vec_out && gn < N) {
    const float4 sc = *reinterpret_cast<const float4*>(scale + gn);
    *reinterpret_cast<float4*>(dst) = make_float4(
        row[0] * sc.x, row[1] * sc.y, row[2] * sc.z, row[3] * sc.w);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gn + j < N) dst[j] = row[j] * scale[gn + j];
  }
}

template <bool kVecX, bool kVecQ>
void launch(const float* x, const int8_t* q, const float* scale, float* out,
            int M, int N, int K, int vec_out, cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<kVecX, kVecQ><<<grid, kThreads, 0, st>>>(
      x, q, scale, out, M, N, K, vec_out);
}

}  // namespace

// C entry, bound with ctypes. Launches on `stream` (PyTorch's current
// stream), allocates nothing, does not synchronise; returns
// cudaGetLastError() so a refused launch is reported. The 16-byte copies
// are taken where the rows allow them: x when K % 4 == 0, q when
// N % 16 == 0, each with a 16-byte-aligned base; scale and out are read
// and written as float4 when N % 4 == 0 and both bases are aligned.
extern "C" int int8_matmul_launch(const float* x, const int8_t* q,
                                  const float* scale, float* out, int M,
                                  int N, int K, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vx = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vq = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int vo = N % 4 == 0 && reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vx && vq)
    launch<true, true>(x, q, scale, out, M, N, K, vo, st);
  else if (vx)
    launch<true, false>(x, q, scale, out, M, N, K, vo, st);
  else if (vq)
    launch<false, true>(x, q, scale, out, M, N, K, vo, st);
  else
    launch<false, false>(x, q, scale, out, M, N, K, vo, st);
  return static_cast<int>(cudaGetLastError());
}
