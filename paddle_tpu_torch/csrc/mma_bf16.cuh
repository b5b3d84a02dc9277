// Register-level 16-bit helpers shared by the Hopper kernels: pack16
// (every Hopper kernel: a product's float32 accumulator, packed to 16-bit
// pairs, is the register A operand of the next product), ldmatrix's
// transposed 8x8 loads (K4 in int8_matmul.cu, K1-paged in
// decode_attention.cu), the exact int8 -> 16-bit converter (K2-paged-int8
// in flash_attention_fwd.cu, K1-paged-int8), and for decode_attention.cu
// the warp-level mma.sync product, movmatrix's register transpose and
// cp.async's 16- and 4-byte copies.
//
// The 16-bit element type e16 is the library's: bfloat16, or float16 where
// the source is compiled with -DPTT_F16 (a library of its own, the
// VARIANTS of ops/cuda/_build.py).  Both are 2 bytes, so every tile,
// swizzle, TMA box and shared-memory budget carries over; what differs is
// the products' operand type (PTT_E16 in the mma.sync and wgmma
// instructions), the rounding to 16 bits, the TMA element type (sm90.cuh)
// and the exact int8 conversion.
#pragma once

#include <cuda_bf16.h>
#ifdef PTT_F16
#include <cuda_fp16.h>
#endif
#include <cuda_runtime.h>
#include <stdint.h>

#ifdef PTT_F16
#define PTT_E16 "f16"
#else
#define PTT_E16 "bf16"
#endif

namespace ptt {

#ifdef PTT_F16
typedef __half e16;
typedef __half2 e16x2;
constexpr bool kHalf = true;
constexpr int kE16Code = 2;   // the C entries' dtype code of the library
__device__ __forceinline__ e16 to_e16(float x) { return __float2half_rn(x); }
__device__ __forceinline__ e16x2 to_e16x2(float lo, float hi) {
  return __floats2half2_rn(lo, hi);
}
#else
typedef __nv_bfloat16 e16;
typedef __nv_bfloat162 e16x2;
constexpr bool kHalf = false;
constexpr int kE16Code = 0;
__device__ __forceinline__ e16 to_e16(float x) { return __float2bfloat16(x); }
__device__ __forceinline__ e16x2 to_e16x2(float lo, float hi) {
  return __floats2bfloat162_rn(lo, hi);
}
#endif

// two floats rounded to the 16-bit type, the first in the low half
__device__ __forceinline__ unsigned pack16(float lo, float hi) {
  e16x2 v = to_e16x2(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// four transposed 8x8 16-bit matrices: the B fragments of a product whose
// k dimension runs along the rows of a row-major [k][n] tile
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

#ifdef PTT_F16
// a - b on float16 pairs, rounded to nearest
__device__ __forceinline__ uint32_t f16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// four int8 (one word) as four float16 (two words), exact: a byte with
// its sign bit flipped, x + 128 in [0, 255], put by a byte permute into
// the low mantissa of the float16 1024 (0x6400) gives 1024 + x + 128, and
// one float16 pair subtraction of 1152 (0x6480) leaves x (integers below
// 2^11 are exact).  lo holds bytes 0 (low half) and 1, hi bytes 2 and 3.
__device__ __forceinline__ void int8x4_to_e16(uint32_t w, uint32_t& lo,
                                              uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  lo = f16x2_sub(__byte_perm(u, 0x64u, 0x4140), 0x64806480u);
  hi = f16x2_sub(__byte_perm(u, 0x64u, 0x4342), 0x64806480u);
}
#else
// a * b + c on bf16 pairs, rounded to nearest
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// four int8 (one word) as four bfloat16 (two words), exact: x = (128 +
// (x & 127)) - (128 + (x & 128)) in two's complement, each term a bf16 of
// exponent 2^7 whose mantissa is the byte's low bits (0x80 carries into
// 256), put together by byte permutes; one bf16 pair fma subtracts.  lo
// holds bytes 0 (low half) and 1, hi bytes 2 and 3.
__device__ __forceinline__ void int8x4_to_e16(uint32_t w, uint32_t& lo,
                                              uint32_t& hi) {
  const uint32_t m = w & 0x7F7F7F7Fu, n = w & 0x80808080u;
  const uint32_t one = 0x3F803F80u;
  lo = bf16x2_fma(__byte_perm(m, 0x43u, 0x4140), one,
                  __byte_perm(n, 0xC3u, 0x4140));
  hi = bf16x2_fma(__byte_perm(m, 0x43u, 0x4342), one,
                  __byte_perm(n, 0xC3u, 0x4342));
}
#endif

// d += a * b on the tensor cores, one warp: m16n8k16, e16 in, float32
// accumulate.  Fragments (g = lane / 4, c = lane % 4; the lower k or n
// index in the low half of a pair):
//   a[0] = (row g, k 2c..2c+1)  a[1] = (row g+8, k 2c..)
//   a[2] = (row g, k 2c+8..)    a[3] = (row g+8, k 2c+8..)
//   b0 = (k 2c..2c+1, col g)    b1 = (k 2c+8.., col g)
//   d[0..1] = (row g, cols 2c..2c+1)  d[2..3] = (row g+8, the same cols)
// so an accumulator over two 8-column tiles, packed to 16-bit pairs, is the
// A operand of the next product.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32." PTT_E16 "." PTT_E16 ".f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the transpose of an 8x8 matrix of 16-bit values held one register a lane
// in the fragment layout (lane (g, c): row g, columns 2c..2c+1)
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// ---- cp.async (global -> shared, no registers) ------------------------------
// copy `src_bytes` (16 or 0) bytes and zero the rest of the 16: a copy of
// 0 bytes reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 8 bytes (src_bytes 8 or 0), both addresses 8-byte aligned: the copy of a
// row that starts only 8-byte aligned
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// returns once at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace ptt
