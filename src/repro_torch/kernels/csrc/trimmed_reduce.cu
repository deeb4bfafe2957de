// Per-coordinate rank-trimmed weighted mean over the client axis, written
// by hand for Hopper (sm_90a): for each coordinate p, client c's stable
// rank is the number of clients j with x[j, p] < x[c, p], or
// x[j, p] == x[c, p] and j < c; the clients ranked in [trim, C - trim)
// survive, and
//   out[p] = sum_surv w[c] x[c, p] / sum_surv w[c].
// trim = (C - 1) / 2 is the coordinate-wise median.
//
// Replaces: src/repro/kernels/agg_reduce.py::_trim_kernel (the
// pallas_call in trimmed_reduce_flat), with its rank predicate exactly
// (agg_reduce.py:486), not a sort with another tie rule.
//
// Inputs x (C, P) f32 contiguous, w (C,) f32; output (P,) f32. The
// wrapper holds 0 <= 2 trim < C; C is bounded by device memory alone.
//
// Bound on the H100: bytes. 4 (C P + P + C) bytes, 23.5 MB at the
// quickstart's (C, P) = (10, 534016), about 7.0 us at 3.35 TB/s; the
// C^2 compares per coordinate (53 M at that shape) are far under the
// card's rate, if they are plain register compares. Design: one thread
// owns one coordinate and holds its C values in registers (for each
// client, the warp reads 32 consecutive floats). C is a template
// parameter, one instantiation per C in 1..kMaxClients, so every loop
// over the clients unrolls and every client index is a constant: the
// values stay in registers (a runtime index would put them in local
// memory), and the rank predicate splits at compile time into <= for
// lower client indices and < for higher ones. num and den accumulate
// keep * w * x and keep * w over the clients in order 0..C-1, as
// _trim_kernel does. Deterministic: no atomics, one thread per output.
//
// Past 32 clients the values do not fit a
// thread's registers, and the C^2 compares would not fit the card's
// rate (5.6e11 at C = 1024, P = 534016): a second design,
// trimmed_select_kernel. A block owns kCols consecutive coordinates and
// stages their (C, kCols) slab in shared memory, once, as order keys
// (and the C weights beside it):
// the f32 bits mapped to a uint32 whose unsigned order is the float
// order (-0 taken as +0, so that it ties with +0 as x == y does). Ties go
// by client index, so client c's rank is its position in the order of
// the pairs (key, c), and the survivors are the clients whose pair lies
// between the pairs at ranks trim and C - 1 - trim. One warp a coordinate
// finds those two pairs by a radix select over the key's 32 bits, most
// significant first: at each bit the lanes count the candidates whose
// bit is 0 (a lane takes clients lane, lane + 32, ...) and add the
// counts over the warp, so the select reads the slab 32 times and
// compares nothing pairwise; what is left of the rank at the end is the
// pair's position among the clients of its value, in client order. Then
// one thread a coordinate walks the clients in order 0..C-1, keeps the
// pairs between the two, and sums num and den as the register kernel
// does. A NaN is before no one in _trim_kernel's predicate, so the other
// clients' ranks are as if it were absent; its own key falls at one end,
// which moves nobody else's rank that matters: a NaN anywhere in a column
// makes that column NaN in _trim_kernel (num += keep * w * x with keep =
// 0 is NaN), and here too, since a dropped client adds 0 * x (an
// infinity dropped is NaN as well). No atomics: the counts are integer
// sums, the f32 sums run in client order.
//
// The slab takes 4 C (cols + 2) bytes (keys at pitch cols + 1, then the
// weights): 16 columns a block while that fits the card's shared memory
// (C <= 3228 on an H100), then 8, 4, 2 or 1, one warp a column each.
// Past one column's slab (C > 19370 on an H100) the keys are read from
// device memory where the select needs them, the same keys in the same
// order, and lane 0 of the warp walks. Every variant sums the same
// values in the same order, so all give the same bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
// the largest C with an instantiation: 32 values in registers a thread,
// and C^2 = 1024 unrolled compares in the largest one
constexpr int kMaxClients = 32;
// the select design past kMaxClients: at most kCols coordinates a block
// (one warp each); a slab's row pitch is cols + 1 keys (odd: the warp's
// column reads and the walk's row reads hit distinct banks)
constexpr int kCols = 16;

template <int C>
__global__ void __launch_bounds__(kThreads)
trimmed_reduce_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, float* __restrict__ out,
                      int trim, long long P) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= P) return;
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    v[c] = __ldg(x + static_cast<long long>(c) * P + p);
  float num = 0.0f;
  float den = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // lower client index: ties count as before; higher: only strictly
    // smaller values do (the same predicate as _trim_kernel, NaN too)
    int rank = 0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < c) rank += v[j] <= v[c];
      if (j > c) rank += v[j] < v[c];
    }
    // a dropped client adds 0 * x, as _trim_kernel's keep * w * x does:
    // a NaN or an infinity trimmed away makes the column NaN, and on
    // finite values the sums are those of the survivors alone, bit for bit
    const bool keep = rank >= trim && rank < C - trim;
    const float wc = keep ? __ldg(w + c) : 0.0f;
    num = fmaf(wc, v[c], num);
    den += wc;
  }
  out[p] = num / den;
}

template <int C>
void launch(const float* x, const float* w, float* out, int trim,
            long long P, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((P + kThreads - 1) / kThreads);
  trimmed_reduce_kernel<C><<<blocks, kThreads, 0, st>>>(x, w, out, trim, P);
}

// launch<c> for the runtime c, c in [C, kMaxClients]
template <int C>
void dispatch(int c, const float* x, const float* w, float* out, int trim,
              long long P, cudaStream_t st) {
  if (c == C) {
    launch<C>(x, w, out, trim, P, st);
  } else if constexpr (C < kMaxClients) {
    dispatch<C + 1>(c, x, w, out, trim, P, st);
  }
}

// f32 -> a uint32 in the same order (unsigned), -0 as +0
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t b = __float_as_uint(x);
  if ((b << 1) == 0u) b = 0u;  // -0
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

// the pair at rank r (0-based) of a column's C (key, client) pairs,
// key_of(c) client c's key: its key, and its position among the clients
// of that key; called by the whole warp
template <typename KeyOf>
__device__ __forceinline__ void select_rank(KeyOf key_of, int C, int r,
                                            uint32_t& key, int& pos) {
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0u;  // the key's bits decided so far
  for (int b = 31; b >= 0; --b) {
    // candidates (bits above b as decided) whose bit b is 0
    int n = 0;
    for (int c = lane; c < C; c += 32)
      n += ((key_of(c) ^ prefix) >> b) == 0u;
    n = __reduce_add_sync(0xffffffffu, n);
    if (r >= n) {
      prefix |= 1u << b;
      r -= n;
    }
  }
  key = prefix;
  pos = r;
}

// the survivors' pairs lie between (kl, pl) and (kh, ph) of the column
// (all of them at trim 0); called by the whole warp
template <typename KeyOf>
__device__ __forceinline__ void thresholds(KeyOf key_of, int C, int trim,
                                           uint32_t& kl, int& pl,
                                           uint32_t& kh, int& ph) {
  if (trim == 0) {  // every client survives
    kl = 0u;
    pl = 0;
    kh = 0xffffffffu;
    ph = C;
    return;
  }
  select_rank(key_of, C, trim, kl, pl);
  if (C - 1 - trim == trim) {  // the median of an odd C
    kh = kl;
    ph = pl;
  } else {
    select_rank(key_of, C, C - 1 - trim, kh, ph);
  }
}

// the walk: clients in order 0..C-1, counting each threshold key's
// clients as it passes them, the survivors' sums in client order
template <typename KeyOf, typename WeightOf>
__device__ __forceinline__ float walk(KeyOf key_of, WeightOf weight_of,
                                      int C, uint32_t kl, int pl,
                                      uint32_t kh, int ph) {
  int nl = 0, nh = 0;
  float num = 0.0f;
  float den = 0.0f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const uint32_t u = key_of(c);
    const bool keep = (u > kl || (u == kl && nl >= pl)) &&
                      (u < kh || (u == kh && nh <= ph));
    nl += u == kl;
    nh += u == kh;
    // a dropped client adds 0 * x, as _trim_kernel's keep * w * x does
    const float wc = keep ? weight_of(c) : 0.0f;
    num = fmaf(wc, key_value(u), num);
    den += wc;
  }
  return num / den;
}

// COLS coordinates a block, one warp each, their (C, COLS) slab of keys
// and the C weights staged in shared memory
template <int COLS>
__global__ void __launch_bounds__(32 * COLS)
trimmed_select_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, float* __restrict__ out,
                      int C, int trim, long long P) {
  constexpr int kThr = 32 * COLS;
  constexpr int kPitch = COLS + 1;
  extern __shared__ uint32_t keys[];  // [C][kPitch], then the C weights
  float* const ws = reinterpret_cast<float*>(keys + C * kPitch);
  __shared__ uint32_t lo_key[COLS], hi_key[COLS];
  __shared__ int lo_pos[COLS], hi_pos[COLS];
  const long long p0 = static_cast<long long>(blockIdx.x) * COLS;
  for (int i = threadIdx.x; i < C; i += kThr) ws[i] = __ldg(w + i);
  for (int i = threadIdx.x; i < C * COLS; i += kThr) {
    const int c = i / COLS, t = i % COLS;
    const long long p = p0 + t;
    keys[c * kPitch + t] =
        p < P ? order_key(__ldg(x + static_cast<long long>(c) * P + p)) : 0u;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;  // the warp's coordinate p0 + warp
  uint32_t kl, kh;
  int pl, ph;
  thresholds([&](int c) { return keys[c * kPitch + warp]; }, C, trim, kl,
             pl, kh, ph);
  if ((threadIdx.x & 31) == 0) {
    lo_key[warp] = kl;
    lo_pos[warp] = pl;
    hi_key[warp] = kh;
    hi_pos[warp] = ph;
  }
  __syncthreads();

  // one thread a coordinate walks; the weights come from shared memory,
  // so only the sums' own chain is serial
  const int t = threadIdx.x;
  if (t >= COLS || p0 + t >= P) return;
  out[p0 + t] = walk([&](int c) { return keys[c * kPitch + t]; },
                     [&](int c) { return ws[c]; }, C, lo_key[t], lo_pos[t],
                     hi_key[t], hi_pos[t]);
}

// past one column's slab: kCols coordinates a block, one warp each, the
// keys read from device memory where they are needed
__global__ void __launch_bounds__(32 * kCols)
trimmed_select_global_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             float* __restrict__ out, int C, int trim,
                             long long P) {
  const long long p = static_cast<long long>(blockIdx.x) * kCols +
                      (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp leaves together
  auto key_of = [&](int c) {
    return order_key(__ldg(x + static_cast<long long>(c) * P + p));
  };
  uint32_t kl, kh;
  int pl, ph;
  thresholds(key_of, C, trim, kl, pl, kh, ph);
  if ((threadIdx.x & 31) == 0)
    out[p] = walk(key_of, [&](int c) { return __ldg(w + c); }, C, kl, pl,
                  kh, ph);
}

template <int COLS>
int launch_cols(const float* x, const float* w, float* out, int C, int trim,
                long long P, size_t smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      trimmed_select_kernel<COLS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((P + COLS - 1) / COLS);
  trimmed_select_kernel<COLS><<<blocks, 32 * COLS, smem, st>>>(x, w, out, C,
                                                               trim, P);
  return static_cast<int>(cudaGetLastError());
}

// the widest slab that fits the card's shared memory a block, else the
// keys from device memory
int launch_select(const float* x, const float* w, float* out, int C,
                  int trim, long long P, cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto smem = [&](int cols) {  // keys at pitch cols + 1, then the weights
    return sizeof(uint32_t) * static_cast<size_t>(C) * (cols + 2);
  };
  const size_t cap = static_cast<size_t>(optin);
  if (smem(16) <= cap) return launch_cols<16>(x, w, out, C, trim, P,
                                              smem(16), st);
  if (smem(8) <= cap) return launch_cols<8>(x, w, out, C, trim, P, smem(8),
                                            st);
  if (smem(4) <= cap) return launch_cols<4>(x, w, out, C, trim, P, smem(4),
                                            st);
  if (smem(2) <= cap) return launch_cols<2>(x, w, out, C, trim, P, smem(2),
                                            st);
  if (smem(1) <= cap) return launch_cols<1>(x, w, out, C, trim, P, smem(1),
                                            st);
  const unsigned blocks = static_cast<unsigned>((P + kCols - 1) / kCols);
  trimmed_select_global_kernel<<<blocks, 32 * kCols, 0, st>>>(x, w, out, C,
                                                              trim, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes. Launches on `stream` (PyTorch's current
// stream), allocates nothing, does not synchronise: the register kernel
// for C <= kMaxClients, the select kernels above. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a trim out of range.
extern "C" int trimmed_reduce_launch(const float* x, const float* w,
                                     float* out, int C, int trim,
                                     long long P, void* stream) {
  if (C < 1 || trim < 0 || 2 * trim >= C)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > kMaxClients) return launch_select(x, w, out, C, trim, P, st);
  dispatch<1>(C, x, w, out, trim, P, st);
  return static_cast<int>(cudaGetLastError());
}
