// GPO neural-process attention, backward, written by hand for Hopper
// (sm_90a): one kernel for dq, one for dk and dv, every product on the
// tensor cores in 3xTF32 (mma_tf32.cuh), on the tile schedule that the
// forward shares (gpo_tiles.cuh).
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
// Precision: each product is mma.sync m16n8k8 tf32 -> f32 with every f32
// operand split into big + small TF32 and three products summed (3xTF32,
// mma_tf32.cuh); one TF32 pass would miss the card check's
// 1e-5 (1 + |plain|) 40-180 times over (tests/test_torch_gpo_bwd_numerics.py
// models both). The tensor cores' sums round toward zero, so a chain of
// products through one accumulator drifts: each k-step's big.big sum and
// each stage's accumulation start from zero and are added in f32, which
// brings the error against float64 to that of the plain f32 version
// (PERF.md, section 6). k = 8 divides every built width HD (GPO_WIDTHS in
// gpo_tiles.cuh); the wrapper pads any other head with zero columns.
// Past HD 64 a context block owns a slab of dq, or of dk and dv, and
// recomputes p and ds over the whole head (gpo_tiles.cuh).
//
// dq: one block of four warps per (bh, 16 query rows). The block's q and
// do rows (and, if it holds target rows, their own k and v rows) come
// into shared memory by cp.async with the first stages of the context
// keys [0, num_ctx): k and v, 32 keys a stage, a ring of four stages
// with three in flight. Q and dO sit in registers as split A fragments;
// each warp takes 8 keys of a stage: S = Q.K^T and dP = dO.V^T (16 x 8)
// on the tensor cores, p and ds in registers, then dq += dS.K. The four
// warps' partial dq tiles are summed in shared memory in warp order, and
// each target row (i >= num_ctx) adds its own key's term, one dot
// product per row on the CUDA cores.
// dk/dv: a one-dimensional grid, every bh's context blocks first, so the
// heavy blocks spread evenly over the SMs. A context block takes 16
// context keys (K and V as A fragments) and streams all S query rows
// (q, do, lse, delta) through the same ring, 8 rows a warp: S^T = K.Q^T
// and dP^T = V.dO^T put the keys in the mma's M, then dV += P^T.dO and
// dK += dS^T.Q, and the warp partials are summed in warp order. A target
// block takes 32 target keys: key j >= num_ctx is read by query j alone,
// so dv_j = p_jj do_j and dk_j = ds_jj q_j, an elementwise pass in the
// same launch.
//
// An accumulator tile feeds the next product with no shuffle: its
// columns 2 tq, 2 tq + 1 become A's k = tq, tq + 4, and the B operand's
// rows are read from shared memory in that order (a_from_acc). A masked
// pair (a key past num_ctx in a context tile, a query or a staged key
// past the end, zero-filled) is a select to p = 0, never exp(-1e30 -
// lse). No atomics: every sum runs in a fixed order and a block reads
// one bh alone, so a result is bit-equal from call to call and does not
// depend on BH.
//
// Bound on the H100 SXM: at the training shape (BH 40, S 160, num_ctx
// 80, HD 32) dq moves 4.15 MB and dk/dv 4.97 MB: 1.24 and 1.48 us at
// 3.35 TB/s. Their 0.099 and 0.132 GFLOP of products, three TF32 passes
// each at 495 TFLOP/s dense, take 0.6 and 0.8 us, so the bytes set the
// bound. Neither sets the pace: a call pays
// a fixed cost (the launch, the first copies, the epilogue) and a cost a
// stage of 32 rows, in which each warp issues a few hundred
// instructions, most of them TF32 splits and f32 adds around its
// mma.sync, with 3-4 warps an SM sub-partition: too few to hide the
// latency of its mma.sync chains and its exp (chip_smoke.py phase 5
// times both; PERF.md, section 6).
#include "gpo_tiles.cuh"

namespace {

constexpr int kTpr = 4;             // threads a target key, dk/dv
constexpr int kTargets = kThreads / kTpr;  // target keys a dk/dv block takes
static_assert(2 * kStage <= kThreads, "a thread each lse and delta value");

// rows [r0, r0 + kStage) of one bh's (S,) lse or delta into shared
// memory, zero-filled from row `end` on; threads [t0, t0 + kStage) copy
__device__ __forceinline__ void stage_row_values(float* dst,
                                                 const float* __restrict__ src,
                                                 int r0, int end, int t0) {
  const int i = static_cast<int>(threadIdx.x) - t0;
  if (i < 0 || i >= kStage) return;
  const bool live = r0 + i < end;
  cp_async4(smem_addr(dst + i), src + (live ? r0 + i : 0), live);
}

// one row's own-key pair (p, ds) on the CUDA cores, TPR neighbouring
// threads a row, each over HD / TPR columns of q, k, v and do; every
// lane of the warp joins the shuffles
template <int HD, int TPR>
__device__ __forceinline__ void own_key(const float* q, const float* k,
                                        const float* v, const float* dout,
                                        float l, float dl, float scale,
                                        float& p, float& ds) {
  float s = 0.0f;
  float dp = 0.0f;
#pragma unroll
  for (int c = 0; c < HD / TPR; ++c) {
    s = fmaf(q[c], k[c], s);
    dp = fmaf(dout[c], v[c], dp);
  }
#pragma unroll
  for (int m = TPR / 2; m > 0; m >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, m);
    dp += __shfl_xor_sync(0xffffffffu, dp, m);
  }
  p = expf(s * scale - l);
  ds = p * (dp - dl) * scale;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
gpo_attention_bwd_dq_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int S, int num_ctx,
                            float scale) {
  constexpr int P = pitch(HD);
  constexpr int VW = slab(HD);             // dq columns of the block
  constexpr int kBufs = bufs(HD);
  constexpr int kTileF = kTile * P;        // floats of a 16-row tile
  constexpr int kStageF = 2 * kStage * P;  // floats of a stage: k, v
  // the block's rows of q, do, k and v; then the ring of stages, which
  // holds the warp partials after the walk
  extern __shared__ __align__(16) float sm[];  // dq_smem_floats<HD>()
  float* const qs = sm;
  float* const dos = sm + kTileF;
  float* const kd = sm + 2 * kTileF;
  float* const vd = sm + 3 * kTileF;
  float* const ring = sm + 4 * kTileF;

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;
  const float* lr = lse + static_cast<size_t>(blockIdx.y) * S;
  const float* dr = delta + static_cast<size_t>(blockIdx.y) * S;
  const int r0 = blockIdx.x * kTile;
  const int col0 = blockIdx.z * VW;  // the block's slab of dq
  const bool has_target = r0 + kTile > num_ctx;  // uniform in the block

  // group 0: the block's tiles and stage 0; then stages 1 .. kBufs - 2,
  // one group each (empty past the last stage)
  stage_rows<HD, kTile>(qs, q + base, r0, S);
  stage_rows<HD, kTile>(dos, dout + base, r0, S);
  if (has_target) {
    stage_rows<HD, kTile>(kd, k + base, r0, S);
    stage_rows<HD, kTile>(vd, v + base, r0, S);
  }
  auto stage = [&](int st) {
    float* buf = ring + (st % kBufs) * kStageF;
    stage_rows<HD, kStage>(buf, k + base, st * kStage, num_ctx);
    stage_rows<HD, kStage>(buf + kStage * P, v + base, st * kStage, num_ctx);
  };
  const int stages = (num_ctx + kStage - 1) / kStage;
#pragma unroll
  for (int st = 0; st < kBufs - 1; ++st) {
    if (st < stages) stage(st);
    cp_async_commit();
  }
  float l[2], dl[2];  // rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    l[h] = r < S ? lr[r] : 0.0f;
    dl[h] = r < S ? dr[r] : 0.0f;
  }
  const int r = threadIdx.x >> 3;  // the epilogue's row, 8 threads a row
  const int row = r0 + r;
  const bool live = row < S;
  const float l_own = live ? lr[row] : 0.0f;
  const float dl_own = live ? dr[row] : 0.0f;
  cp_async_wait<kBufs - 2>();
  __syncthreads();

  Tile<HD> qa, da;
  qa.load(qs, g, tq);
  da.load(dos, g, tq);
  float acc[VW / 8][4] = {};
  for (int st = 0; st < stages; ++st) {
    if (st > 0) {
      cp_async_wait<kBufs - 2>();
      __syncthreads();  // stage st landed; stage st - 1's buffer is free
    }
    if (st + kBufs - 1 < stages) stage(st + kBufs - 1);
    cp_async_commit();
    const int j0 = st * kStage + 8 * w;  // this warp's 8 keys
    if (j0 < num_ctx) {
      const float* ku = ring + (st % kBufs) * kStageF + 8 * w * P;
      const float* vu = ku + kStage * P;
      float s[4], dp[4], ds[4];
      mma_abt<HD>(s, qa, ku, g, tq);
      mma_abt<HD>(dp, da, vu, g, tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool on = j0 + 2 * tq + (e & 1) < num_ctx;
        const float p = on ? expf(s[e] * scale - l[e >> 1]) : 0.0f;
        ds[e] = p * (dp[e] - dl[e >> 1]) * scale;
      }
      mma_acc_u<HD, VW>(acc, ds, ku + col0, g, tq);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  store_partial<HD, VW>(ring, acc, w, g, tq);
  __syncthreads();

  // the partials in warp order, plus a target row's own key (its dot
  // products over the whole head, HD / 8 columns a thread)
  const int c0 = (threadIdx.x & 7) * (VW / 8);
  const int t = r * P + (threadIdx.x & 7) * (HD / 8);
  float p = 0.0f;
  float ds = 0.0f;
  if (has_target)
    own_key<HD, 8>(qs + t, kd + t, vd + t, dos + t, l_own, dl_own, scale, p,
                   ds);
  if (!live) return;
  const bool target = row >= num_ctx;
  const int tv = r * P + col0 + c0;  // the row's slab columns of k
  const size_t off = base + static_cast<size_t>(row) * HD + col0 + c0;
#pragma unroll
  for (int c = 0; c < VW / 8; ++c) {
    const float x = sum_partials<HD>(ring, r, c0 + c);
    dq[off + c] = target ? fmaf(ds, kd[tv + c], x) : x;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
gpo_attention_bwd_dkdv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int bh, int S, int num_ctx, int ctx_blocks,
                              int tgt_blocks, float scale) {
  constexpr int P = pitch(HD);
  constexpr int VW = slab(HD);  // dk and dv columns of a context block
  constexpr int kSlabs = HD / VW;
  constexpr int kBufs = bufs(HD);
  constexpr int kTileF = kTile * P;
  // floats of a stage: q and do rows, then lse and delta
  constexpr int kStageF = 2 * kStage * P + 2 * kStage;
  // the block's rows of k and v; then the ring of stages, which holds
  // the dk and dv warp partials after the walk
  extern __shared__ __align__(16) float sm[];  // dkdv_smem_floats<HD>()
  static_assert(2 * kWarps * kTileF <= kBufs * kStageF, "partials overflow");

  // a one-dimensional grid: every bh's context blocks (each tile's
  // slabs side by side), then every bh's target blocks, so the heavy
  // blocks spread evenly over the SMs
  const int n_ctx = bh * ctx_blocks * kSlabs;
  const int b = blockIdx.x;
  const bool ctx = b < n_ctx;
  const int bhi =
      ctx ? b / (ctx_blocks * kSlabs) : (b - n_ctx) / tgt_blocks;
  const int tile =
      ctx ? b / kSlabs % ctx_blocks : (b - n_ctx) % tgt_blocks;
  const int col0 = ctx ? b % kSlabs * VW : 0;  // the block's slab
  const size_t base = static_cast<size_t>(bhi) * S * HD;
  const float* lr = lse + static_cast<size_t>(bhi) * S;
  const float* dr = delta + static_cast<size_t>(bhi) * S;

  if (!ctx) {
    // kTargets target keys, kTpr threads a key: read by their own query
    // alone
    const int key = num_ctx + tile * kTargets + threadIdx.x / kTpr;
    const bool live = key < S;
    const size_t off = base + static_cast<size_t>(live ? key : 0) * HD +
                       (threadIdx.x % kTpr) * (HD / kTpr);
    float p, ds;
    own_key<HD, kTpr>(q + off, k + off, v + off, dout + off,
                      live ? lr[key] : 0.0f, live ? dr[key] : 0.0f, scale, p,
                      ds);
    if (!live) return;
#pragma unroll
    for (int c = 0; c < HD / kTpr; ++c) {
      dv[off + c] = p * dout[off + c];
      dk[off + c] = ds * q[off + c];
    }
    return;
  }

  float* const ks = sm;
  float* const vs = sm + kTileF;
  float* const ring = sm + 2 * kTileF;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int j0 = tile * kTile;  // the block's 16 keys

  // group 0: the block's k and v rows (zero from num_ctx on: those are
  // target keys) and stage 0; then stages 1 .. kBufs - 2
  stage_rows<HD, kTile>(ks, k + base, j0, num_ctx);
  stage_rows<HD, kTile>(vs, v + base, j0, num_ctx);
  auto stage = [&](int st) {
    float* buf = ring + (st % kBufs) * kStageF;
    const int i0 = st * kStage;
    stage_rows<HD, kStage>(buf, q + base, i0, S);
    stage_rows<HD, kStage>(buf + kStage * P, dout + base, i0, S);
    stage_row_values(buf + 2 * kStage * P, lr, i0, S, 0);
    stage_row_values(buf + 2 * kStage * P + kStage, dr, i0, S, kStage);
  };
  const int stages = (S + kStage - 1) / kStage;
#pragma unroll
  for (int st = 0; st < kBufs - 1; ++st) {
    if (st < stages) stage(st);
    cp_async_commit();
  }
  bool key_on[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key_on[h] = j0 + g + 8 * h < num_ctx;
  cp_async_wait<kBufs - 2>();
  __syncthreads();

  Tile<HD> ka, va;
  ka.load(ks, g, tq);
  va.load(vs, g, tq);
  float dk_acc[VW / 8][4] = {};
  float dv_acc[VW / 8][4] = {};
  for (int st = 0; st < stages; ++st) {
    if (st > 0) {
      cp_async_wait<kBufs - 2>();
      __syncthreads();  // stage st landed; stage st - 1's buffer is free
    }
    if (st + kBufs - 1 < stages) stage(st + kBufs - 1);
    cp_async_commit();
    const int i0 = st * kStage + 8 * w;  // this warp's 8 query rows
    if (i0 < S) {
      const float* buf = ring + (st % kBufs) * kStageF;
      const float* qu = buf + 8 * w * P;
      const float* du = qu + kStage * P;
      const float* lu = buf + 2 * kStage * P + 8 * w;
      const float* dlu = lu + kStage;
      float s[4], dp[4], p[4], ds[4];
      mma_abt<HD>(s, ka, qu, g, tq);
      mma_abt<HD>(dp, va, du, g, tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * tq + (e & 1);  // query i0 + col
        const bool on = key_on[e >> 1] && i0 + col < S;
        p[e] = on ? expf(s[e] * scale - lu[col]) : 0.0f;
        ds[e] = p[e] * (dp[e] - dlu[col]) * scale;
      }
      mma_acc_u<HD, VW>(dv_acc, p, du + col0, g, tq);
      mma_acc_u<HD, VW>(dk_acc, ds, qu + col0, g, tq);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* const part_k = ring;
  float* const part_v = ring + kWarps * kTileF;
  store_partial<HD, VW>(part_k, dk_acc, w, g, tq);
  store_partial<HD, VW>(part_v, dv_acc, w, g, tq);
  __syncthreads();

  const int r = threadIdx.x >> 3;
  const int key = j0 + r;
  if (key >= num_ctx) return;  // a target key: a target block writes it
  const int c0 = (threadIdx.x & 7) * (VW / 8);
  const size_t off = base + static_cast<size_t>(key) * HD + col0 + c0;
#pragma unroll
  for (int c = 0; c < VW / 8; ++c) {
    dk[off + c] = sum_partials<HD>(part_k, r, c0 + c);
    dv[off + c] = sum_partials<HD>(part_v, r, c0 + c);
  }
}

template <int HD>
constexpr size_t dq_smem_floats() {
  return 4 * kTile * pitch(HD) + bufs(HD) * 2 * kStage * pitch(HD);
}

template <int HD>
constexpr size_t dkdv_smem_floats() {
  return 2 * kTile * pitch(HD) +
         bufs(HD) * (2 * kStage * pitch(HD) + 2 * kStage);
}

template <int HD>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int bh, int S, int num_ctx, float scale,
              cudaStream_t st) {
  const dim3 grid((S + kTile - 1) / kTile, bh, HD / slab(HD));
  return launch_dyn(gpo_attention_bwd_dq_kernel<HD>, grid,
                    sizeof(float) * dq_smem_floats<HD>(), st, q, k, v, dout,
                    lse, delta, dq, S, num_ctx, scale);
}

template <int HD>
int launch_dkdv(const float* q, const float* k, const float* v,
                const float* dout, const float* lse, const float* delta,
                float* dk, float* dv, int bh, int S, int num_ctx,
                float scale, cudaStream_t st) {
  const int ctx_blocks = (num_ctx + kTile - 1) / kTile;
  const int tgt_blocks = (S - num_ctx + kTargets - 1) / kTargets;
  const dim3 grid(bh * (ctx_blocks * (HD / slab(HD)) + tgt_blocks));
  return launch_dyn(gpo_attention_bwd_dkdv_kernel<HD>, grid,
                    sizeof(float) * dkdv_smem_floats<HD>(), st, q, k, v,
                    dout, lse, delta, dk, dv, bh, S, num_ctx, ctx_blocks,
                    tgt_blocks, scale);
}

}  // namespace

// C entries, bound with ctypes. q, k, v, do and the outputs are (bh, S,
// width), width a built width (GPO_WIDTHS), hd <= width the head's own
// width (the wrapper pads the rest with zero columns), which sets the
// scale 1 / sqrt(hd). Each launches on `stream` (PyTorch's current
// stream), allocates nothing, does not synchronise; returns
// cudaGetLastError(), cudaErrorInvalidValue for a width that is not built
// here or an hd outside [1, width], or cudaErrorMisalignedAddress for a
// (BH, S, width) operand that does not start 16-byte aligned.
extern "C" int gpo_attention_bwd_dq_launch(const float* q, const float* k,
                                           const float* v, const float* dout,
                                           const float* lse,
                                           const float* delta, float* dq,
                                           int bh, int S, int num_ctx, int hd,
                                           int width, void* stream) {
  if (!aligned16({q, k, v, dout, dq}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (hd < 1 || hd > width) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = softmax_scale(hd);
  switch (width) {
#define GPO_DQ_CASE(W)                                                      \
  case W:                                                                   \
    return launch_dq<W>(q, k, v, dout, lse, delta, dq, bh, S, num_ctx, scale, \
                        st);
    GPO_WIDTHS(GPO_DQ_CASE)
#undef GPO_DQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gpo_attention_bwd_dkdv_launch(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dk, float* dv, int bh,
    int S, int num_ctx, int hd, int width, void* stream) {
  if (!aligned16({q, k, v, dout, dk, dv}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (hd < 1 || hd > width) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = softmax_scale(hd);
  switch (width) {
#define GPO_DKDV_CASE(W)                                                \
  case W:                                                               \
    return launch_dkdv<W>(q, k, v, dout, lse, delta, dk, dv, bh, S,     \
                          num_ctx, scale, st);
    GPO_WIDTHS(GPO_DKDV_CASE)
#undef GPO_DKDV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
