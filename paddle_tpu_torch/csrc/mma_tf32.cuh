// float32-accurate products on the tensor cores from three TF32 passes
// (the float32 K5 / K6 of flash_attention_bwd.cu and the float32 K2 of
// flash_attention_fwd.cu).
//
// TF32 keeps float32's 8 exponent bits and 10 of its 23 mantissa bits, so
// one TF32 product of float32 operands errs by about 2^-11 relative.  Split
// each operand x = hi + lo (split_tf32: hi x rounded to TF32, lo the rest,
// itself cut to TF32).  Then hi + lo is within 2^-21 |x| of x, and a b =
// hi_a hi_b + hi_a lo_b + lo_a hi_b + lo_a lo_b, whose last term, about
// 2^-22 of the product, is dropped: three mma.sync products, the two small
// ones issued first (as CUTLASS's OpMultiplyAddFastF32 orders them), keep
// float32's accuracy at a third of the TF32 rate (494.7 / 3 = 165 TFLOP/s
// dense on an H100 SXM, against the CUDA cores' 67).
//
// m16n8k8 fragments, lane = 4 g + t (g = lane / 4, t = lane % 4), one
// float32 (a TF32 in its upper 19 bits) a register:
//   A (16 x 8, row-major):  a[0] (row g, k t)      a[1] (row g + 8, k t)
//                           a[2] (row g, k t + 4)  a[3] (row g + 8, k t + 4)
//   B (8 x 8, column):      b0 (k t, col g)        b1 (k t + 4, col g)
//   C (16 x 8, float32):    c[0] (row g, col 2t)   c[1] (row g, col 2t + 1)
//                           c[2] (row g + 8, col 2t)  c[3] (row g + 8, 2t + 1)
// A sum over k may take k in any order, so a C fragment is the A fragment
// of a product whose k order is permuted within each step of 8 -- k t is
// column 2t and k t + 4 column 2t + 1 of the C tile -- as long as B's k
// rows follow the same order: b0 row 2t, b1 row 2t + 1.  That turns a
// product's result into the next product's A operand with no shuffle.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// x = hi + lo, each a TF32: hi is x rounded to TF32 to nearest, ties away
// from zero -- the bits cvt.rna.tf32.f32 gives for every x but a NaN,
// formed by an integer add and mask: cvt is a conversion, a quarter of the
// integer rate, and was a quarter of the kernels' time -- and lo is x - hi
// (exact) with its low 13 bits cleared, so that hi + lo is within 2^-21 |x|
// of x.  A NaN x may give a hi that is not NaN; its lo is NaN, and so is
// the product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a b on the tensor cores, one warp: m16n8k8, TF32 in, float32
// accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b to float32 accuracy from split operands: lo_a hi_b, hi_a lo_b,
// then hi_a hi_b
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bhi0, uint32_t bhi1,
                                           uint32_t blo0, uint32_t blo1) {
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, ahi, bhi0, bhi1);
}

// Segment ids: the 3xTF32 bodies skip tile pairs whose id ranges miss each
// other.  rng is the int32 (B, n, 2) [min, max] id of every kIdRange
// tokens (segment_tile_ranges); id_range gives the [min, max] id of rows
// [r0, r1].
constexpr int kIdRange = 64;

__device__ __forceinline__ int2 id_range(const int* rng, int b, int n,
                                         int r0, int r1) {
  int2 out = make_int2(0x7fffffff, -0x7fffffff - 1);
  for (int u = r0 / kIdRange; u <= r1 / kIdRange; ++u) {
    const int* r = rng + ((size_t)b * n + u) * 2;
    out.x = min(out.x, __ldg(r));
    out.y = max(out.y, __ldg(r + 1));
  }
  return out;
}

}  // namespace ptt
