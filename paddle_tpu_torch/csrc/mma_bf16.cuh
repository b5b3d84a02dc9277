// Tensor-core helpers shared by the flash-attention kernels
// (flash_attention_fwd.cu: K2, flash_attention_bwd.cu: K5 / K6).
//
// mma.sync.m16n8k16 with bf16 inputs and float32 accumulation, its
// fragment loads (ldmatrix, plain 32-bit shared-memory loads) and cp.async
// tile copies.  Fragment layout of m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..),
//                           a2 = (g, 2c+8..),   a3 = (g+8, 2c+8..);
//   B (16 x 8, "col"):      b0 = (k 2c..2c+1, n g), b1 = (k 2c+8.., n g);
//   C (16 x 8):             c0,c1 = (g, 2c..2c+1), c2,c3 = (g+8, 2c..).
// So an accumulator pair of n-blocks (2j, 2j+1), packed to bf16, is the A
// fragment of k step j: no shared-memory round trip between two products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt {

// 16-byte global -> shared copy; n = 0 zero-fills (past a ragged edge)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// d += a * b (m16n8k16, bf16 in, float32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four transposed 8x8 bf16 matrices: the B fragments of a product whose
// k dimension runs along the rows of a row-major [k][n] tile
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// B fragments (k = 2c.., n = g) of a product with a row-major [n][k] tile
// in shared memory (keys x head_dim as the B of Q.K^T): `row` points at
// element (n0 + g, k0 + 2c)
__device__ __forceinline__ void load_b_frag(unsigned& b0, unsigned& b1,
                                            const __nv_bfloat16* row) {
  b0 = *reinterpret_cast<const unsigned*>(row);
  b1 = *reinterpret_cast<const unsigned*>(row + 8);
}

// the A fragment of rows r0..r0+15, k columns k0..k0+15 of a row-major
// tile of row stride `stride`, `base` pointing at element (r0 + g, k0 + 2c)
__device__ __forceinline__ void load_a_frag(unsigned (&a)[4],
                                            const __nv_bfloat16* base,
                                            int stride) {
  a[0] = *reinterpret_cast<const unsigned*>(base);
  a[1] = *reinterpret_cast<const unsigned*>(base + 8 * stride);
  a[2] = *reinterpret_cast<const unsigned*>(base + 8);
  a[3] = *reinterpret_cast<const unsigned*>(base + 8 * stride + 8);
}

}  // namespace ptt
