// Mamba2 SSD chunked scan, written by hand for Hopper (sm_90a): bf16 on
// the tensor cores (mma.sync), f32 on the CUDA cores.
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
//
// Bound on the H100 SXM at its 700 W limit (data-sheet rates: 3.35 TB/s,
// 989 TFLOP/s bf16 dense, 67 TFLOP/s f32): at mamba2-780m's prefill (b 4,
// s 2048, h 48, p 64, n 128, L 128, bf16) the scan moves ~113 MB with the
// final state, 33.6 us of bytes, and needs ~23 GFLOP (the causal
// triangles of C.B^T and of the y product, the state's two products;
// ~32 GFLOP counting the triangles in full): ~23 us at the bf16
// tensor-core rate, ~340 us at the f32 CUDA-core rate. Bytes bound it.
//
// bf16 (ssd_scan_bf16_kernel): the four products on the tensor cores,
// mma.sync m16n8k16 bf16 -> f32, fragments as in the flash kernel
// (mma_bf16.cuh). What held the CUDA-core design back, and what this one
// does about it:
// - f32 products on the CUDA cores. x, B and C arrive in bf16 and are
//   exact mma operands. The three f32 operands (the scores, the state,
//   x dt exp(cs_L - cs_j)) go in as hi = bf16(v) plus lo = bf16(v - hi),
//   two mmas into one f32 accumulator, which keeps about 16 bits of v.
//   Every lo term is kept to stay close to f32; only the lo of
//   x dt exp(cs_L - cs_j) is required by a check the card makes (the
//   state within 1e-4 (1 + |plain|); without it a CPU model of this
//   rounding reads ~2e-3 there). Without the scores' or the state
//   copy's lo, the same model moves y by ~1.4e-2 and ~3.1e-3 of
//   1 + |plain|, inside y's 3e-2, and the row limit is not shown to
//   catch them: no card check holds those two
//   (tests/test_torch_ssd_numerics.py). C.B^T needs one mma. The mma work
//   issued is ~40 GFLOP at the shape above (the lo terms, the causal
//   band in 16 x 16 tiles): ~41 us at the dense rate.
// - Scores through shared memory. A warp owns 16 rows of the chunk and
//   walks the band 16 keys at a time: C.B^T for the block (two partial
//   sums over n, so four accumulator chains are in flight), scaled by
//   exp(cs_i - cs_j) dt_j and masked in registers, split, and fed back
//   at once as the A fragments of scores.x, as flash feeds S back as P.
//   The scores never touch shared memory, and a warp holds 16 of them a
//   thread, not its whole row band.
// - The state in f32 throughout: the update's accumulator in registers
//   (a warp owns a (p, n) tile of it for the whole scan), rescaled by
//   exp(cs_L) each chunk, and a hi/lo bf16 copy in shared memory that
//   the next chunk's C.state^T reads with ldmatrix.
// - A serial, unoverlapped chunk chain. The next chunk's x, B, C and dt
//   are copied by cp.async into the other of two stages while this
//   chunk computes; a chunk takes three barriers (its stage landed; y
//   done with x, C and the state copy; x dt exp(cs_L - cs) staged).
//   Each warp computes the chunk's cumsum itself, so that needs none.
// - One block per (batch, head): 192 blocks at batch 4, 48 at batch 1,
//   on 132 SMs. A block here takes a (batch, head) and PW columns of p
//   (PW 64 or 32, the wrapper's choice), recomputing C.B^T for each
//   slice, which the tensor cores make cheap; the rows of p are
//   independent in y and in the state.
// - Causal balance: 8 warps, warp w on row tile w (w < 4) or 11 - w, so
//   the two warps of each scheduler share the (L/16 + 1) tiles of the
//   band evenly; the four warps of the light tiles (0-3) issue all the
//   copies. The state update splits (PW, n) evenly over the 8 warps.
//   The heaviest warp's band (tile 7: 8 blocks of C.B^T and scores.x)
//   still sets the pace of the y phase.
// Every tile is the full 128 x 128 (a chunk, n or p below that is
// padded in the tile with zeros and dt = 0, an exact identity), so every
// loop bound is a constant but the band's. Shared memory at PW 64: two
// stages of B, C (128 x 128) and x (128 x 64) with dt, 173 KB; the
// state's hi/lo copy 34 KB; each warp's cumsum and weights 1 KB: 215 KB
// of the 227. Rows are padded by 16 bytes, so the 8 rows an ldmatrix
// reads sit in 8 distinct 4-bank groups. After y, x's tile holds the hi
// part of x dt exp(cs_L - cs) in place and C's tile its lo part. No
// atomics: every sum runs in a fixed order whatever PW, so two calls,
// and any two widths, are bit-equal. Widths that are not multiples of
// 8, or operands not 16-byte aligned, take plain loads and stores in
// place of cp.async and paired stores. Tried on the card and kept over
// a first cut: the fused band walk (the first held a warp's whole band
// of C.B^T before any scores.x, at 240+ registers), the light warps
// issuing the copies (the copies' address math sat on the heavy warps'
// path). PERF.md §6 has the times.
//
// f32 (ssd_scan_kernel, the port's original design, CUDA cores): one
// block of 256 threads per (batch, head), walking the chunks in order with the (p, n)
// state resident in shared memory (the TPU kernel's sequential chunk
// axis as a loop). A chunk stages x and B as f32 in shared memory; the
// rows of C and of the score matrix go through in blocks of 32, so that
// at L 128, p 64, n 128 the block needs 166 KB of the 227 KB, not the
// 256 KB of whole f32 tiles. Rows are padded by one float, so a warp
// walking neighbouring rows hits 32 different banks. Each of the three
// products (C.B^T, the y rows, the state update) gives every thread a
// register tile (4 x 4, 4 x 2, 8 x 4 outputs), so one shared-memory load
// feeds 2 to 2.7 FMAs and the tile's independent sums hide the loads'
// latency. The cumsum is a warp scan. TF32 mma would not hold the f32
// tolerances.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

// ---- f32: CUDA cores ---------------------------------------------------
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

// Tile k of the scan: a chunk of L rows runs as ceil(L / tile) tiles of
// at most `tile` rows, in order, the state carried from one to the next
// (an exact rewrite of the chunk's own sums, which differ only in their
// rounding); at L <= tile a tile is the chunk.
struct ScanTile {
  int start;  // its first row in the sequence
  int rows;   // its rows
};
__device__ __forceinline__ ScanTile scan_tile(int k, int L, int tile) {
  const int per = (L + tile - 1) / tile;
  const int in = (k % per) * tile;
  return {(k / per) * L + in, min(tile, L - in)};
}
__host__ __device__ __forceinline__ int scan_tiles(int S, int L, int tile) {
  return S / L * ((L + tile - 1) / tile);
}

// The tiles are sized for the largest tile (128 rows, p 64, n 128) and
// the parts past the tile's rows, p and n are zero, so the register tiles
// below need no bounds on their loads. Block (b * H + h, p slice, n
// slice): columns [64 y, 64 y + 64) of p, [128 z, 128 z + 128) of n.
// With ypart (n > 128) the block writes its slice's share of y without
// D x in f32 to ypart[z], and ssd_finish_kernel adds them up.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv,
                T* __restrict__ y, float* __restrict__ state_out,
                float* __restrict__ ypart, int S, int H, int P, int N,
                int L) {
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
  const int p0 = blockIdx.y * kMaxP, n0 = blockIdx.z * kMaxN;
  const int Pw = min(kMaxP, P - p0), Nw = min(kMaxN, N - n0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float a = -expf(A_log[h]);
  const float d = Dv[h];

  for (int i = tid; i < kMaxP * kNS; i += kThreads) st[i] = 0.0f;

  const int ntiles = scan_tiles(S, L, kMaxChunk);
  for (int tk = 0; tk < ntiles; ++tk) {
    const ScanTile tile = scan_tile(tk, L, kMaxChunk);
    const int c0 = tile.start, L = tile.rows;  // this tile's rows
    // ---- stage the chunk: x, B, dt (zero past L, p, n) ----
    for (int i = tid; i < kMaxChunk * kMaxP; i += kThreads) {
      const int j = i / kMaxP, pp = i % kMaxP;
      xs[j * kPS + pp] =
          j < L && pp < Pw
              ? to_f32(x[((static_cast<size_t>(b) * S + c0 + j) * H + h) * P +
                         p0 + pp])
              : 0.0f;
    }
    for (int i = tid; i < kMaxChunk * kMaxN; i += kThreads) {
      const int j = i / kMaxN, nn = i % kMaxN;
      bs[j * kNS + nn] =
          j < L && nn < Nw
              ? to_f32(Bm[(static_cast<size_t>(b) * S + c0 + j) * N + n0 + nn])
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
            i0 + r < L && nn < Nw
                ? to_f32(Cm[(static_cast<size_t>(b) * S + c0 + i0 + r) * N +
                            n0 + nn])
                : 0.0f;
      }
      __syncthreads();
      // scores(i, j) = (C_i . B_j) * exp(cs_i - cs_j) * dt_j for j <= i:
      // a 4 x 4 register tile, columns lane + 32k for the groups k that
      // hold any j <= i0 + 31
      const int kmax = min(i0, L - 1) / 32;
      {
        float acc[4][4] = {};
        for (int nn = 0; nn < Nw; ++nn) {
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
        for (int nn = 0; nn < Nw; ++nn) {
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
            if (pp >= Pw) continue;
            const size_t at =
                ((static_cast<size_t>(b) * S + c0 + i) * H + h) * P + p0 + pp;
            if (ypart != nullptr) {
              ypart[static_cast<size_t>(blockIdx.z) * gridDim.x * S * P +
                    at] = intra[q][c] + expf(cs[i]) * inter[q][c];
              continue;
            }
            const float out = intra[q][c] + expf(cs[i]) * inter[q][c] +
                              d * xs[i * kPS + pp];
            y[at] = from_f32<T>(out);
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
    for (int i = tid; i < Pw * Nw; i += kThreads)
      so[static_cast<size_t>(p0 + i / Nw) * N + n0 + i % Nw] =
          st[(i / Nw) * kNS + i % Nw];
  }
}

// n > 128: y = D x + the n slices' shares, added in slice order, rounded
// to y's type once
template <typename T>
__global__ void __launch_bounds__(256)
ssd_finish_kernel(const float* __restrict__ ypart, const T* __restrict__ x,
                  const float* __restrict__ Dv, T* __restrict__ y,
                  int slices, long long total, int H, int P) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  float v = ypart[i];
  for (int z = 1; z < slices; ++z) v += ypart[z * total + i];
  y[i] = from_f32<T>(v + Dv[(i / P) % H] * to_f32(x[i]));
}


// ---- bf16: tensor cores (mma.sync m16n8k16) -----------------------------

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
// the four warps of the lighter row tiles (0-3) issue the copies
constexpr int kLoadThreads = 128;
constexpr int kTcL = 128;              // chunk rows of a tile
constexpr int kTcN = 128;              // state width n of a tile
constexpr int kBCStride = kTcN + 8;    // bf16 per row of B, C, the state
constexpr float kLog2e = 1.4426950408889634f;
template <int PW>
constexpr int kXStride = PW + 8;       // bf16 per row of x

// dynamic shared memory, bytes: two stages (B, C, x in bf16, dt in f32),
// the state's hi and lo copies, each warp's cumsum and state weights
template <int PW>
struct TcSmem {
  static constexpr int kBC = kTcL * kBCStride * 2;
  static constexpr int kX = kTcL * kXStride<PW> * 2;
  static constexpr int kStage = 2 * kBC + kX + kTcL * 4;
  static constexpr int kSt = PW * kBCStride * 2;
  static constexpr int kWarp = 2 * kTcL * 4;
  static constexpr int kBytes = 2 * kStage + 2 * kSt + kTcWarps * kWarp;
};

__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// x (b, s, h, p), B/C (b, s, n) bf16 -> y bf16, state_out f32 or null.
// Block (b * H + h, slice, n slice): columns [slice * PW, slice * PW +
// PW) of p and [128 z, 128 z + 128) of n; with ypart (n > 128) the
// block writes its n slice's share of y without D x in f32 to ypart[z],
// and ssd_finish_kernel adds them up. A chunk past 128 rows runs as
// 128-row tiles in order (scan_tile). Every tile is the full 128 x 128
// (zero past the tile's rows, n and p), so every loop bound is a
// constant but the causal band's.
template <int PW>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_scan_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ A_log,
                     const __nv_bfloat16* __restrict__ Bm,
                     const __nv_bfloat16* __restrict__ Cm,
                     const float* __restrict__ Dv,
                     __nv_bfloat16* __restrict__ y,
                     float* __restrict__ state_out,
                     float* __restrict__ ypart, int S, int H, int P,
                     int N, int L, int vec) {
  using Smem = TcSmem<PW>;
  constexpr int kXS = kXStride<PW>;
  constexpr int kPT = PW / 16;     // 16-column groups of the slice
  constexpr int kKN = kTcN / 16;   // k steps over n
  constexpr int kKL = kTcL / 16;   // 16-row tiles of the chunk
  // the state update's warp grid: kWP warps along p (kRM rows each), kWN
  // along n (kNC columns each)
  constexpr int kWP = PW == 64 ? 2 : 1;
  constexpr int kRM = PW / kWP;
  constexpr int kMT = kRM / 16;
  constexpr int kWN = kTcWarps / kWP;
  constexpr int kNC = kTcN / kWN;
  constexpr int kNG = kNC / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto btile_of = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * Smem::kStage);
  };
  auto ctile_of = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * Smem::kStage +
                                            Smem::kBC);
  };
  auto xtile_of = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * Smem::kStage +
                                            2 * Smem::kBC);
  };
  auto dts_of = [&](int s) {
    return reinterpret_cast<float*>(smem_raw + s * Smem::kStage +
                                    2 * Smem::kBC + Smem::kX);
  };
  __nv_bfloat16* st_hi =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * Smem::kStage);
  __nv_bfloat16* st_lo = st_hi + PW * kBCStride;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int p0 = blockIdx.y * PW;
  const int n0 = blockIdx.z * kTcN;
  const int Nw = min(kTcN, N - n0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int tq = lane & 3;  // fragment column pair
  const float a2 = -expf(A_log[h]) * kLog2e;  // dt * a2: log2 units
  const float d = Dv[h];
  // this warp's cumsum of the chunk (log2 units) and x weights
  float* cs2 = reinterpret_cast<float*>(smem_raw + 2 * Smem::kStage +
                                        2 * Smem::kSt + warp * Smem::kWarp);
  float* wv = cs2 + kTcL;

  // tile c -> stage s: rows past the tile's, columns past n and p, zero.
  // Run by threads 0..kLoadThreads-1; offsets are 32-bit from the tile's
  // first row
  auto load_chunk = [&](int c, int s) {
    const ScanTile tile = scan_tile(c, L, kTcL);
    const int L = tile.rows;  // this tile's rows
    const size_t row0 = static_cast<size_t>(b) * S + tile.start;
    const __nv_bfloat16* bsrc = Bm + row0 * N + n0;
    const __nv_bfloat16* csrc = Cm + row0 * N + n0;
    const __nv_bfloat16* xsrc = x + (row0 * H + h) * P + p0;
    __nv_bfloat16* bt = btile_of(s);
    __nv_bfloat16* ct = ctile_of(s);
    __nv_bfloat16* xt = xtile_of(s);
    if (vec) {
      // 16-byte pieces: 16 a row of B or C, PW / 8 a row of x
      constexpr int kBCIters = kTcL * (kTcN / 8) / kLoadThreads;
#pragma unroll
      for (int it = 0; it < kBCIters; ++it) {
        const int i = threadIdx.x + it * kLoadThreads;
        const int j = i / (kTcN / 8);
        const int k = 8 * (i % (kTcN / 8));
        const bool in = j < L && k < Nw;
        const int src = in ? j * N + k : 0;
        cp_async16(smem_addr(bt + j * kBCStride + k), bsrc + src, in);
        cp_async16(smem_addr(ct + j * kBCStride + k), csrc + src, in);
      }
      constexpr int kXIters = kTcL * (PW / 8) / kLoadThreads;
#pragma unroll
      for (int it = 0; it < kXIters; ++it) {
        const int i = threadIdx.x + it * kLoadThreads;
        const int j = i / (PW / 8);
        const int k = 8 * (i % (PW / 8));
        const bool in = j < L && p0 + k < P;
        const int src = in ? j * H * P + k : 0;
        cp_async16(smem_addr(xt + j * kXS + k), xsrc + src, in);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.0f);
      for (int i = threadIdx.x; i < kTcL * kTcN; i += kLoadThreads) {
        const int j = i / kTcN;
        const int k = i % kTcN;
        const bool in = j < L && k < Nw;
        bt[j * kBCStride + k] = in ? bsrc[j * N + k] : zero;
        ct[j * kBCStride + k] = in ? csrc[j * N + k] : zero;
      }
      for (int i = threadIdx.x; i < kTcL * PW; i += kLoadThreads) {
        const int j = i / PW;
        const int k = i % PW;
        const bool in = j < L && p0 + k < P;
        xt[j * kXS + k] = in ? xsrc[j * H * P + k] : zero;
      }
    }
    const float* dsrc = dt + row0 * H + h;
    const int j = threadIdx.x;
    const bool in = j < L;
    cp_async4(smem_addr(dts_of(s) + j), dsrc + (in ? j * H : 0), in);
  };

  for (int i = threadIdx.x; i < PW * kBCStride; i += kTcThreads) {
    st_hi[i] = __float2bfloat16(0.0f);
    st_lo[i] = __float2bfloat16(0.0f);
  }
  // the state tile this warp owns: rows pb.. of the slice, columns nb..
  const int pb = (warp / kWN) * kRM;
  const int nb = (warp % kWN) * kNC;
  float acc[kMT][2 * kNG][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * kNG; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  // the row tile of y this warp owns: the warps w and w + 4 of a
  // scheduler get tiles t and 7 - t, (t + 1) + (8 - t) units of the band
  const int rt = warp < 4 ? warp : 11 - warp;
  const int i0 = 16 * rt;
  const int r0 = i0 + g;
  const int r1 = r0 + 8;

  const int nc = scan_tiles(S, L, kTcL);
  if (threadIdx.x < kLoadThreads) load_chunk(0, 0);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const ScanTile tile = scan_tile(c, L, kTcL);
    const int L = tile.rows;  // this tile's rows
    const int s = c & 1;
    cp_async_wait<0>();
    // chunk c has landed for every thread; every warp is done with chunk
    // c - 1 (its stage is free, the state copy is the one after c - 1)
    __syncthreads();
    if (c + 1 < nc && threadIdx.x < kLoadThreads) load_chunk(c + 1, s ^ 1);
    cp_async_commit();
    const __nv_bfloat16* bt = btile_of(s);
    __nv_bfloat16* ct = ctile_of(s);
    __nv_bfloat16* xt = xtile_of(s);
    const float* ds = dts_of(s);

    // ---- each warp: the cumsum of dt * a (log2 units) over the chunk,
    // lane l on rows 4l..4l+3; and w_j = dt_j exp(cs_L - cs_j) ----
    float last;
    {
      const float4 dv = *reinterpret_cast<const float4*>(ds + 4 * lane);
      float4 c4;
      c4.x = dv.x * a2;
      c4.y = c4.x + dv.y * a2;
      c4.z = c4.y + dv.z * a2;
      c4.w = c4.z + dv.w * a2;
      float incl = c4.w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0f;
      last = __shfl_sync(0xffffffffu, incl, 31);
      c4.x += excl;
      c4.y += excl;
      c4.z += excl;
      c4.w += excl;
      *reinterpret_cast<float4*>(cs2 + 4 * lane) = c4;
      *reinterpret_cast<float4*>(wv + 4 * lane) = make_float4(
          dv.x * ex2(last - c4.x), dv.y * ex2(last - c4.y),
          dv.z * ex2(last - c4.z), dv.w * ex2(last - c4.w));
      __syncwarp();
    }

    // ---- y for rows i0..i0+15 ----
    {
      // C rows as A fragments over k = n
      uint32_t cf[kKN][4];
#pragma unroll
      for (int kk = 0; kk < kKN; ++kk)
        ldmatrix_x4(cf[kk], smem_addr(ct + (i0 + (lane & 15)) * kBCStride +
                                      16 * kk + (lane >> 4) * 8));
      const float c0 = cs2[r0];
      const float c1 = cs2[r1];
      // exp(cs_i) C.state^T: the state's hi and lo copies as B fragments
      float ya[PW / 8][4];
#pragma unroll
      for (int q = 0; q < PW / 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) ya[q][e] = 0.0f;
      if (c > 0) {
#pragma unroll
        for (int kk = 0; kk < kKN; ++kk) {
#pragma unroll
          for (int dd = 0; dd < kPT; ++dd) {
            // matrices: rows 16dd + {0, 8} of the state (p), n 16kk + {0, 8}
            const int row = 16 * dd + (lane >> 4) * 8 + (lane & 7);
            const int col = 16 * kk + ((lane >> 3) & 1) * 8;
            uint32_t sh[4], sl[4];
            ldmatrix_x4(sh, smem_addr(st_hi + row * kBCStride + col));
            ldmatrix_x4(sl, smem_addr(st_lo + row * kBCStride + col));
            mma_bf16(ya[2 * dd], cf[kk], sh[0], sh[1]);
            mma_bf16(ya[2 * dd + 1], cf[kk], sh[2], sh[3]);
            mma_bf16(ya[2 * dd], cf[kk], sl[0], sl[1]);
            mma_bf16(ya[2 * dd + 1], cf[kk], sl[2], sl[3]);
          }
        }
        const float e0 = ex2(c0);
        const float e1 = ex2(c1);
#pragma unroll
        for (int q = 0; q < PW / 8; ++q) {
          ya[q][0] *= e0;
          ya[q][1] *= e0;
          ya[q][2] *= e1;
          ya[q][3] *= e1;
        }
      }
      // the band, 16 columns (keys j) at a time: C.B^T, then the scores
      // (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i in place, then
      // += scores.x with the score tile as hi and lo A fragments
#pragma unroll
      for (int jj = 0; jj < kKL; ++jj) {
        if (jj > rt) break;
        // two partial sums over n (k steps 0-3, 4-7), four independent
        // accumulator chains
        float sc[2][2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[hf][t2][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kKN; ++kk) {
          // matrices: rows 16jj + {0, 8} of B, n 16kk + {0, 8}
          const int key = 16 * jj + (lane >> 4) * 8 + (lane & 7);
          const int dim = 16 * kk + ((lane >> 3) & 1) * 8;
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_addr(bt + key * kBCStride + dim));
          const int hf = kk / (kKN / 2);
          mma_bf16(sc[hf][0], cf[kk], bk[0], bk[1]);
          mma_bf16(sc[hf][1], cf[kk], bk[2], bk[3]);
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2) {
          const int j = 16 * jj + 8 * t2 + 2 * tq;
          const float2 cj = *reinterpret_cast<const float2*>(cs2 + j);
          const float2 dj = *reinterpret_cast<const float2*>(ds + j);
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = sc[0][t2][e] + sc[1][t2][e];
          v[0] = j <= r0 ? v[0] * ex2(c0 - cj.x) * dj.x : 0.0f;
          v[1] = j + 1 <= r0 ? v[1] * ex2(c0 - cj.y) * dj.y : 0.0f;
          v[2] = j <= r1 ? v[2] * ex2(c1 - cj.x) * dj.x : 0.0f;
          v[3] = j + 1 <= r1 ? v[3] * ex2(c1 - cj.y) * dj.y : 0.0f;
          // A registers: (row g, keys 2tq) (row g + 8, 2tq) of key
          // tile t2 = 0, then the same of t2 = 1
          split_bf16(v[0], v[1], ah[2 * t2], al[2 * t2]);
          split_bf16(v[2], v[3], ah[2 * t2 + 1], al[2 * t2 + 1]);
        }
#pragma unroll
        for (int dd = 0; dd < kPT; ++dd) {
          // matrices: rows 16jj + {0, 8} of x, columns 16dd + {0, 8}
          const int key = 16 * jj + ((lane >> 3) & 1) * 8 + (lane & 7);
          const int dim = 16 * dd + (lane >> 4) * 8;
          uint32_t bx[4];
          ldmatrix_x4_trans(bx, smem_addr(xt + key * kXS + dim));
          mma_bf16(ya[2 * dd], ah, bx[0], bx[1]);
          mma_bf16(ya[2 * dd + 1], ah, bx[2], bx[3]);
          mma_bf16(ya[2 * dd], al, bx[0], bx[1]);
          mma_bf16(ya[2 * dd + 1], al, bx[2], bx[3]);
        }
      }
      // + D x_i, rounded to bf16 once
      const size_t t0 = static_cast<size_t>(b) * S + tile.start;
#pragma unroll
      for (int q = 0; q < PW / 8; ++q) {
        const int col = 8 * q + 2 * tq;
        const int pc = p0 + col;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? r1 : r0;
          if (r >= L || pc >= P) continue;
          if (ypart != nullptr) {
            float* dp = ypart +
                        static_cast<size_t>(blockIdx.z) * gridDim.x * S * P +
                        ((t0 + r) * H + h) * P + pc;
            dp[0] = ya[q][2 * half];
            if (pc + 1 < P) dp[1] = ya[q][2 * half + 1];
            continue;
          }
          const float2 xv = bf16x2_to_f32(ld_u32(xt + r * kXS + col));
          const float o0 = ya[q][2 * half] + d * xv.x;
          const float o1 = ya[q][2 * half + 1] + d * xv.y;
          __nv_bfloat16* dst = y + ((t0 + r) * H + h) * P + pc;
          if (vec) {
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o0, o1);
          } else {
            dst[0] = __float2bfloat16(o0);
            if (pc + 1 < P) dst[1] = __float2bfloat16(o1);
          }
        }
      }
    }
    // every warp is done with x, C and the state copy
    __syncthreads();

    // ---- x dt exp(cs_L - cs) as hi (in x's tile) and lo (in C's) ----
    {
      // a fixed trip count of pairs, four loads in flight before their
      // stores
      __nv_bfloat16* xl = ct;  // row stride kXS
      constexpr int kPairs = PW / 2;
      constexpr int kIters = kTcL * kPairs / kTcThreads;
      constexpr int kGroup = 4;
      const int col = 2 * (threadIdx.x % kPairs);
#pragma unroll
      for (int i0 = 0; i0 < kIters; i0 += kGroup) {
        uint32_t xv[kGroup];
        float w[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int j = (threadIdx.x + (i0 + u) * kTcThreads) / kPairs;
          xv[u] = ld_u32(xt + j * kXS + col);
          w[u] = wv[j];
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int j = (threadIdx.x + (i0 + u) * kTcThreads) / kPairs;
          const float2 v = bf16x2_to_f32(xv[u]);
          uint32_t hi, lo;
          split_bf16(v.x * w[u], v.y * w[u], hi, lo);
          *reinterpret_cast<uint32_t*>(xt + j * kXS + col) = hi;
          *reinterpret_cast<uint32_t*>(xl + j * kXS + col) = lo;
        }
      }
    }
    __syncthreads();

    // ---- state = exp(cs_L) state + (x dt exp(cs_L - cs))^T B ----
    {
      const float decay = ex2(last);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2 * kNG; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] *= decay;
      const __nv_bfloat16* xh = xt;
      const __nv_bfloat16* xl = ct;
#pragma unroll
      for (int kt = 0; kt < kKL; ++kt) {
        // A = (x w)^T: x w is stored (j, p), so ldmatrix transposes
        uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int k = 16 * kt + (lane & 7) + ((lane >> 4) & 1) * 8;
          const int m = pb + 16 * mt + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(ah[mt], smem_addr(xh + k * kXS + m));
          ldmatrix_x4_trans(al[mt], smem_addr(xl + k * kXS + m));
        }
#pragma unroll
        for (int gi = 0; gi < kNG; ++gi) {
          const int key = 16 * kt + ((lane >> 3) & 1) * 8 + (lane & 7);
          const int dim = nb + 16 * gi + (lane >> 4) * 8;
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, smem_addr(bt + key * kBCStride + dim));
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(acc[mt][2 * gi], ah[mt], bb[0], bb[1]);
            mma_bf16(acc[mt][2 * gi + 1], ah[mt], bb[2], bb[3]);
            mma_bf16(acc[mt][2 * gi], al[mt], bb[0], bb[1]);
            mma_bf16(acc[mt][2 * gi + 1], al[mt], bb[2], bb[3]);
          }
        }
      }
      // the hi/lo copy the next chunk's C.state^T reads
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2 * kNG; ++nt) {
          const int p = pb + 16 * mt + g;
          const int n = nb + 8 * nt + 2 * tq;
          uint32_t hi, lo;
          split_bf16(acc[mt][nt][0], acc[mt][nt][1], hi, lo);
          *reinterpret_cast<uint32_t*>(st_hi + p * kBCStride + n) = hi;
          *reinterpret_cast<uint32_t*>(st_lo + p * kBCStride + n) = lo;
          split_bf16(acc[mt][nt][2], acc[mt][nt][3], hi, lo);
          *reinterpret_cast<uint32_t*>(st_hi + (p + 8) * kBCStride + n) = hi;
          *reinterpret_cast<uint32_t*>(st_lo + (p + 8) * kBCStride + n) = lo;
        }
      }
    }
  }

  if (state_out != nullptr) {
    float* so = state_out + static_cast<size_t>(bh) * P * N;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2 * kNG; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + pb + 16 * mt + g + 8 * (e >> 1);
          const int n = nb + 8 * nt + 2 * tq + (e & 1);
          if (p < P && n < Nw) so[static_cast<size_t>(p) * N + n0 + n] =
              acc[mt][nt][e];
        }
      }
    }
  }
}

template <int PW>
int launch_bf16(const void* x, const float* dt, const float* A_log,
                const void* Bm, const void* Cm, const float* Dv, void* y,
                float* state_out, float* ypart, int batch, int S, int H,
                int P, int N, int L, cudaStream_t st) {
  constexpr int kSmem = TcSmem<PW>::kBytes;
  auto* kernel = ssd_scan_bf16_kernel<PW>;
  // above 48 KB only once the attribute is set; set on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // cp.async takes 16-byte pieces: rows of whole pieces, aligned bases
  auto aligned = [](const void* p, int to) {
    return reinterpret_cast<uintptr_t>(p) % to == 0;
  };
  const int vec = P % 8 == 0 && N % 8 == 0 && aligned(x, 16) &&
                  aligned(Bm, 16) && aligned(Cm, 16) && aligned(y, 4);
  const dim3 grid(batch * H, (P + PW - 1) / PW, (N + kTcN - 1) / kTcN);
  kernel<<<grid, kTcThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A_log,
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), Dv,
      static_cast<__nv_bfloat16*>(y), state_out, ypart, S, H, P, N, L, vec);
  return static_cast<int>(cudaGetLastError());
}

// n > 128: the slices' shares of y and D x into y
template <typename T>
int launch_finish(const float* ypart, const void* x, const float* Dv,
                  void* y, int batch, int S, int H, int P, int N,
                  cudaStream_t st) {
  const long long total = static_cast<long long>(batch) * S * H * P;
  ssd_finish_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                         st>>>(ypart, static_cast<const T*>(x), Dv,
                               static_cast<T*>(y), (N + kMaxN - 1) / kMaxN,
                               total, H, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes. dtype 0 is float (CUDA cores), 1 is bf16
// (tensor cores; pw, the columns of p a block takes, is 32 or 64);
// state_out may be null; ypart holds ceil(n / 128) * b * s * h * p
// floats when n > 128 (the n slices' shares of y), else it is unused.
// Launches on `stream` (PyTorch's current stream), allocates nothing,
// does not synchronise; returns cudaGetLastError(), or
// cudaErrorInvalidValue for s not a multiple of the chunk, an empty
// shape, a missing ypart, or another dtype or pw. The chunk, p and n are
// bounded by device memory alone.
extern "C" int ssd_scan_launch(const void* x, const float* dt,
                               const float* A_log, const void* Bm,
                               const void* Cm, const float* Dv, void* y,
                               float* state_out, float* ypart, int batch,
                               int S, int H, int P, int N, int L, int dtype,
                               int pw, void* stream) {
  if (L < 1 || S % L != 0 || P < 1 || N < 1 ||
      (N > kMaxN && ypart == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* const part = N > kMaxN ? ypart : nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    const int smem = kSmemFloats * static_cast<int>(sizeof(float));
    cudaFuncSetAttribute(ssd_scan_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    const dim3 grid(batch * H, (P + kMaxP - 1) / kMaxP,
                    (N + kMaxN - 1) / kMaxN);
    ssd_scan_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), dt, A_log,
        static_cast<const float*>(Bm), static_cast<const float*>(Cm), Dv,
        static_cast<float*>(y), state_out, part, S, H, P, N, L);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0 || part == nullptr) return err;
    return launch_finish<float>(part, x, Dv, y, batch, S, H, P, N, st);
  }
  if (dtype != 1 || (pw != 64 && pw != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  err = (pw == 64 ? launch_bf16<64> : launch_bf16<32>)(
      x, dt, A_log, Bm, Cm, Dv, y, state_out, part, batch, S, H, P, N, L, st);
  if (err != 0 || part == nullptr) return err;
  return launch_finish<__nv_bfloat16>(part, x, Dv, y, batch, S, H, P, N, st);
}
