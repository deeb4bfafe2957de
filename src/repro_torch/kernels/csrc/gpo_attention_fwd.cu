// GPO neural-process attention, forward, written by hand for Hopper
// (sm_90a): both products on the tensor cores in 3xTF32 (mma_tf32.cuh),
// on the backward's tile schedule (gpo_tiles.cuh).
//
// Replaces: src/repro/kernels/gpo_attention.py::_gpo_fwd_kernel (the
// pallas_call in _gpo_forward).
//
// Inputs q, k, v (BH, S, HD) f32 contiguous; outputs o (BH, S, HD) and
// lse (BH, S) f32, HD a built width (GPO_WIDTHS in gpo_tiles.cuh: the
// wrapper pads any other head with zero columns). Key j is allowed for
// query i iff j < num_ctx (a context key) or j == i (a target's own
// key). As in the TPU kernel, scores scale by 1/sqrt(hd) of the head's
// own width, the mask value is -1e30 (never -inf), l clamps at 1e-30 and
// lse = m + log l; the backward reads this lse. Past HD 64 a block owns
// a slab of o's columns and recomputes the scores over the whole head
// (gpo_tiles.cuh); the first slab's block writes lse.
//
// One block of four warps per (bh, 16 query rows). The block's q rows
// (and, if it holds target rows, their own k and v rows) come into
// shared memory by cp.async with the first stages of the context keys
// [0, num_ctx): k and v, 32 keys a stage, a ring of four stages with
// three in flight. Q sits in registers as split A fragments. Each warp
// takes 8 keys of a stage: S = Q.K^T (16 x 8) on the tensor cores, an
// online softmax per row over the warp's own keys (a row's 8 scores lie
// on the 4 lanes of a quad: two shuffles for the max), then acc (16 x
// HD) rescaled and acc += P.V, p fed to the mma as it lies in the
// accumulator (a_from_acc). A key past num_ctx in the last stage is
// zero-filled and a select to p = 0, never exp(-1e30 - m). After the
// walk the four warps' (m, l, acc) are merged in warp order, each
// scaled by exp(m_w - m): a warp that saw no key (m_w = -1e30, l_w = 0,
// acc_w = 0) adds exactly nothing. Then each target row (i >= num_ctx)
// adds its own key once, one dot product on the CUDA cores; a context
// row's own key is one of the context keys. No S x S scores and no
// target x target pair are ever touched. No atomics: every sum runs in a
// fixed order and a block reads one bh alone, so a result is bit-equal
// from call to call and does not depend on BH.
//
// Precision: the tensor cores' sums round toward zero, so each k-step's
// big.big of S and each 8-key slice's P.V start from zero and are added
// in f32 (mma_abt, mma_acc_u), which keeps the error against float64 at
// the plain f32 version's (chip_smoke.py phase 1 holds it, with a
// planted control that chains those sums; PERF.md, section 6).
//
// Bound on the H100 SXM: at the training shape (BH 40, S 160, num_ctx
// 80, HD 32) a call moves 3.30 MB (q, k, v read, o and lse written once):
// 0.99 us at 3.35 TB/s. Its 0.066 GFLOP of products, three TF32 passes
// each at 495 TFLOP/s dense, take 0.4 us, so the bytes set the bound.
// Neither sets the pace: as for the backward's dq, a call is one block's
// chain (the launch, the first copies, a stage of dependent mma.sync and
// exp per 32 keys, the merge) with at most 3-4 warps an SM
// sub-partition (chip_smoke.py phase 5's pace sweep).
#include "gpo_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask value, not -inf

template <int HD>
__global__ void __launch_bounds__(kThreads)
gpo_attention_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int num_ctx,
                         float scale) {
  constexpr int P = pitch(HD);
  constexpr int VW = slab(HD);             // output columns of the block
  constexpr int kBufs = bufs(HD);
  constexpr int kTileF = kTile * P;        // floats of a 16-row tile
  constexpr int kStageF = 2 * kStage * P;  // floats of a stage: k, v
  // the block's rows of q, k and v; then the ring of stages, which holds
  // the warp partials (acc, then m and l) after the walk
  extern __shared__ __align__(16) float sm[];  // fwd_smem_floats<HD>()
  static_assert(kWarps * kTileF + 2 * kWarps * kTile <= kBufs * kStageF,
                "partials overflow");
  float* const qs = sm;
  float* const kd = sm + kTileF;
  float* const vd = sm + 2 * kTileF;
  float* const ring = sm + 3 * kTileF;

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;
  const int r0 = blockIdx.x * kTile;
  const int col0 = blockIdx.z * VW;  // the block's slab of o
  const bool has_target = r0 + kTile > num_ctx;  // uniform in the block

  // group 0: the block's tiles and stage 0; then stages 1 .. kBufs - 2,
  // one group each (empty past the last stage)
  stage_rows<HD, kTile>(qs, q + base, r0, S);
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
  cp_async_wait<kBufs - 2>();
  __syncthreads();

  Tile<HD> qa;
  qa.load(qs, g, tq);
  float acc[VW / 8][4] = {};
  // rows g and g + 8: the running max (the same on the 4 lanes of a
  // quad) and this lane's share of the running sum
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
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
      float s[4], p[4];
      mma_abt<HD>(s, qa, ku, g, tq);
      bool on[4];
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        on[e] = j0 + 2 * tq + (e & 1) < num_ctx;
        s[e] *= scale;
        if (on[e]) mx[e >> 1] = fmaxf(mx[e >> 1], s[e]);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = expf(m[h] - mx[h]);  // 0 while m is the mask value
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = on[e] ? expf(s[e] - m[e >> 1]) : 0.0f;
        l[e >> 1] += p[e];
      }
#pragma unroll
      for (int nt = 0; nt < VW / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
      }
      mma_acc_u<HD, VW>(acc, p, vu + col0, g, tq);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* const ms = ring + kWarps * kTileF;  // kWarps x 16 maxima
  float* const ls = ms + kWarps * kTile;     // kWarps x 16 sums
  store_partial<HD, VW>(ring, acc, w, g, tq);
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ms[w * kTile + g + 8 * h] = m[h];
      ls[w * kTile + g + 8 * h] = l[h];
    }
  }
  __syncthreads();

  // the warps in warp order, each scaled by exp(m_w - m_row), 8 threads
  // a row over VW / 8 columns each
  const int r = threadIdx.x >> 3;
  const int row = r0 + r;
  const int c0 = (threadIdx.x & 7) * (VW / 8);
  float mr = kNegInf;
#pragma unroll
  for (int ww = 0; ww < kWarps; ++ww) mr = fmaxf(mr, ms[ww * kTile + r]);
  float lr = 0.0f;
  float x[VW / 8] = {};
#pragma unroll
  for (int ww = 0; ww < kWarps; ++ww) {
    const float a = expf(ms[ww * kTile + r] - mr);
    lr = fmaf(a, ls[ww * kTile + r], lr);
#pragma unroll
    for (int c = 0; c < VW / 8; ++c)
      x[c] = fmaf(a, ring[(ww * kTile + r) * P + c0 + c], x[c]);
  }

  // a target row's own key: q_i . k_i over the row's 8 threads, HD / 8
  // columns each (every lane of the warp joins the shuffles)
  const int t = r * P + (threadIdx.x & 7) * (HD / 8);
  float s_own = 0.0f;
  if (has_target) {
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) s_own = fmaf(qs[t + c], kd[t + c], s_own);
#pragma unroll
    for (int msk = 4; msk > 0; msk >>= 1)
      s_own += __shfl_xor_sync(0xffffffffu, s_own, msk);
    s_own *= scale;
  }
  if (row >= S) return;
  const int tv = r * P + col0 + c0;  // the row's slab columns of v
  if (row >= num_ctx) {
    const float m_new = fmaxf(mr, s_own);
    const float alpha = expf(mr - m_new);
    const float p = expf(s_own - m_new);
    lr = fmaf(lr, alpha, p);
#pragma unroll
    for (int c = 0; c < VW / 8; ++c) x[c] = fmaf(p, vd[tv + c], x[c] * alpha);
    mr = m_new;
  }
  const float lc = fmaxf(lr, 1e-30f);
  const size_t off = base + static_cast<size_t>(row) * HD + col0 + c0;
#pragma unroll
  for (int c = 0; c < VW / 8; ++c) o[off + c] = x[c] / lc;
  // every slab's block has the same m and l; the first writes lse
  if (blockIdx.z == 0 && (threadIdx.x & 7) == 0)
    lse[static_cast<size_t>(blockIdx.y) * S + row] = mr + logf(lc);
}

template <int HD>
constexpr size_t fwd_smem_floats() {
  return 3 * kTile * pitch(HD) + bufs(HD) * 2 * kStage * pitch(HD);
}

template <int HD>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int bh, int S, int num_ctx, float scale,
               cudaStream_t st) {
  const dim3 grid((S + kTile - 1) / kTile, bh, HD / slab(HD));
  return launch_dyn(gpo_attention_fwd_kernel<HD>, grid,
                    sizeof(float) * fwd_smem_floats<HD>(), st, q, k, v, o,
                    lse, S, num_ctx, scale);
}

}  // namespace

// C entry, bound with ctypes. q, k, v, o are (bh, S, width), width a
// built width (GPO_WIDTHS), hd <= width the head's own width (the wrapper
// pads the rest with zero columns), which sets the scale 1 / sqrt(hd).
// Launches on `stream` (PyTorch's current stream), allocates nothing,
// does not synchronise; returns cudaGetLastError(), cudaErrorInvalidValue
// for a width that is not built here or an hd outside [1, width], or
// cudaErrorMisalignedAddress for a q, k or v that does not start 16-byte
// aligned.
extern "C" int gpo_attention_fwd_launch(const float* q, const float* k,
                                        const float* v, float* o, float* lse,
                                        int bh, int S, int num_ctx, int hd,
                                        int width, void* stream) {
  if (!aligned16({q, k, v})) return static_cast<int>(cudaErrorMisalignedAddress);
  if (hd < 1 || hd > width) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = softmax_scale(hd);
  switch (width) {
#define GPO_FWD_CASE(W) \
  case W:               \
    return launch_fwd<W>(q, k, v, o, lse, bh, S, num_ctx, scale, st);
    GPO_WIDTHS(GPO_FWD_CASE)
#undef GPO_FWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
