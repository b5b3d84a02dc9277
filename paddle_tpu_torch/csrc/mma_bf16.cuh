// Register-level bf16 helpers shared by the Hopper kernels: pack_bf16
// (every bf16 kernel: a product's float32 accumulator, packed to bf16
// pairs, is the register A operand of the next wgmma) and ldmatrix's
// transposed 8x8 loads (K4 in int8_matmul.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt {

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
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

}  // namespace ptt
