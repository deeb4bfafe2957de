// Tensor-core building blocks for f32 kernels at about f32 accuracy
// (sm_90a): the TF32 split and mma.sync m16n8k8 tf32 -> f32 in 3xTF32.
// The cp.async helpers come from mma_bf16.cuh. Used by the GPO
// attention forward and backward (gpo_tiles.cuh).
//
// 3xTF32: an f32 operand x becomes big = tf32(x) (round to nearest on
// the 13 dropped mantissa bits, ties away from zero, as cvt.rna) and
// small = x - big, exact in f32, which the tensor cores read as TF32 by
// ignoring its low 13 bits (truncation, ~2^-21 of x; rounding it would
// cost two integer ops a value and buys nothing the card check sees); a
// product a.b is summed as small.big + big.small + big.big, which keeps
// about 21 of f32's 24 bits where one TF32 pass keeps 11 (small.small,
// ~2^-22 relative, is dropped). The tensor cores add in f32 but round
// toward zero: a long chain of products through one accumulator loses
// more than the split, so callers keep chains short and add their
// results in f32 on the CUDA cores.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32): lane = 4 g + tq holds
// A rows g and g + 8, columns tq and tq + 4 (a0 (g, tq), a1 (g + 8, tq),
// a2 (g, tq + 4), a3 (g + 8, tq + 4)); B rows tq and tq + 4 of column g;
// the f32 accumulator rows g and g + 8, columns 2 tq and 2 tq + 1. So an
// accumulator tile is not an A fragment as it stands: the kernels read
// B's rows 2 tq and 2 tq + 1 for k = tq and tq + 4 instead, which
// permutes the sum over k and moves no register (see a_from_acc).
#pragma once

#include "mma_bf16.cuh"

namespace {

// cvt.rna.tf32.f32's value for a finite x, in two integer ops: add half
// of the 13 dropped bits to the magnitude, then clear them (cvt also
// tests for inf and NaN, which finite operands never need)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> big = tf32(x), small = x - big (exact; the mma truncates it)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// d (16x8 f32) += a (16x8 tf32, row) . b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32 from split operands: the two small terms first,
// so the big.big sum rounds last
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

// an accumulator tile c (16x8) as a split A operand: a0..a3 take c0, c2,
// c1, c3, so A's k = tq and tq + 4 are the accumulator's columns 2 tq and
// 2 tq + 1; the B operand must then give k = tq the row of column 2 tq
// and k = tq + 4 the row of column 2 tq + 1
__device__ __forceinline__ void a_from_acc(const float (&c)[4],
                                           uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

}  // namespace
