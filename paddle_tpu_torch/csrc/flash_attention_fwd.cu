// Flash-attention forward: kernel K2 of paddle_tpu_torch.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py _fwd (:192) /
// _fwd_kernel (:128): blocked online-softmax attention returning out and the
// float32 log-sum-exp.  Layout: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D);
// out (B, Sq, Hq, D); lse (B, Hq, Sq).  Causal masking is bottom-right
// aligned: query i sees keys j <= i + (Skv - Sq).  GQA: kv head = h / G.  A
// row with every key masked gives out = 0 and lse = -1e30.  Any Sq and Skv:
// the ragged edges are masked here.
//
// Bound on the H100: max(causal FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s),
// the FLOPs at prefill shapes.  Common to both kernels below: one CTA per
// (64-query tile, q head, batch row); K and V stream through shared memory
// in 64-key tiles with an online softmax, so the score matrix never
// reaches device memory; causal tiles wholly above the diagonal are never
// loaded.  Two kernels, one for each case chip_smoke.py checks on the card
// (any other dtype or head dim is refused):
//   * bfloat16 at D = 128 (the serving path): tensor cores, see
//     flash_attention_fwd_mma_kernel;
//   * float32 at D = 16 (the tiny test model): products on the CUDA cores
//     -- each thread owns a 4x4 tile of scores (rows tr*4.., keys tc*4..)
//     and 4 rows x (D/16) output elements, fed by 16-byte shared-memory
//     reads of transposed Q and K tiles; the K tile's shared memory is
//     reused for the probabilities (26 KB at D = 16).
// wgmma/TMA and a warp-specialised pipeline are the next steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;             // queries per CTA
constexpr int kBK = 64;             // keys per tile
constexpr int kPad = 4;             // row padding (keeps float4 alignment)
constexpr int kPQ = kBQ + kPad;
constexpr int kPK = kBK + kPad;

template <int D>
constexpr size_t smem_floats() {
  // Qt [D][kPQ] + (Kt [D][kPK] | Pt [kBK][kPQ]) + Vs [kBK][D]
  return (size_t)D * kPQ + (size_t)(D > kBK ? D : kBK) * kPK +
         (size_t)kBK * D;
}

// float32 on the CUDA cores; at least two CTAs an SM (registers <= 128 a
// thread)
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Skv, int Hq,
                           int Hkv, float scale, int causal) {
  constexpr int NQ = (D + 63) / 64;   // 64-wide output slabs per thread
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = Skv - Sq;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                   // [D][kPQ]  scaled queries, transposed
  float* KP = Qt + D * kPQ;           // [D][kPK] keys, then [kBK][kPQ] probs
  float* Vs = KP + (D > kBK ? D : kBK) * kPK;   // [kBK][D]

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int qr = q0 + r;
    Qt[d * kPQ + r] =
        qr < Sq ? q[(((size_t)b * Sq + qr) * Hq + h) * D + d] * scale : 0.f;
  }

  float acc[4][NQ][4];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }

  const int kv_hi = causal ? min(Skv, q0 + kBQ + offset) : Skv;
  for (int kv0 = 0; kv0 < kv_hi; kv0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      const int kc = kv0 + c;
      float kx = 0.f, vx = 0.f;
      if (kc < Skv) {
        const size_t g = (((size_t)b * Skv + kc) * Hkv + hk) * D + d;
        kx = k[g];
        vx = v[g];
      }
      KP[d * kPK + c] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * kPQ + tr * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&KP[d * kPK + tc * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online softmax; a row's 64 scores live in the 16
    // threads sharing tr (lanes of one half-warp)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + tr * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = kv0 + tc * 4 + j;
        const bool keep =
            qr < Sq && kc < Skv && (!causal || kc <= qr + offset);
        s[i][j] = keep ? s[i][j] : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_new = fmaxf(m_i[i], rmax);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= alpha;
    }

    __syncthreads();   // every thread is done reading the K tile
    float* Pt = KP;    // [kBK][kPQ]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Pt[(tc * 4 + j) * kPQ + tr * 4 + i] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * kPQ + tr * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int d0 = n * 64 + tc * 4;
        if (d0 < D) {
          const float4 va = *reinterpret_cast<const float4*>(&Vs[c * D + d0]);
          const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][n][e] = fmaf(pv[i], vv[e], acc[i][n][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + tr * 4 + i;
    if (qr >= Sq) continue;
    const float l = l_i[i];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = out + (((size_t)b * Sq + qr) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int d0 = n * 64 + tc * 4;
      if (d0 < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) orow[d0 + e] = acc[i][n][e] * inv;
      }
    }
    if (tc == 0)
      lse[((size_t)b * Hq + h) * Sq + qr] = l > 0.f ? m_i[i] + logf(l) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bfloat16, D = 128.
//
// One CTA per (64-query tile, q head, batch row), 4 warps of 16 query rows.
// Q.K^T and P.V run on mma.sync.m16n8k16 (bf16 in, float32 accumulate):
// a warp's Q fragments stay in registers for the whole key walk, the
// scores' accumulator fragments are re-packed in registers as the A
// operand of P.V (no shared-memory round trip for P), and V's B operand
// comes through ldmatrix.trans.  64-key K/V tiles arrive by cp.async
// (zero-filled past Skv); rows are padded by 8 elements so the fragment
// loads are free of bank conflicts.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;
constexpr int kMmaBQ = 64;
constexpr int kMmaBK = 64;

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kMmaBQ + 2 * kMmaBK) * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out,
                               float* __restrict__ lse, int Sq, int Skv,
                               int Hq, int Hkv, float scale, int causal) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int kStride = D + 8;       // padded row, in elements
  constexpr int kPieces = D / 8;       // 16-byte pieces of one row
  constexpr int kKSteps = D / 16;      // k steps of Q.K^T
  constexpr int kDBlocks = D / 8;      // 8-wide output column blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kMmaBQ * kStride;
  __nv_bfloat16* Vs = Ks + kMmaBK * kStride;

  const int q0 = blockIdx.x * kMmaBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = Skv - Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;

  for (int idx = tid; idx < kMmaBQ * kPieces; idx += kMmaThreads) {
    const int r = idx / kPieces, pc = idx - r * kPieces;
    const int qr = q0 + r;
    const __nv_bfloat16* src =
        q + (((size_t)b * Sq + min(qr, Sq - 1)) * Hq + h) * D + pc * 8;
    cp_async16_zfill(Qs + r * kStride + pc * 8, src, qr < Sq);
  }
  cp_async_commit_wait_all();
  __syncthreads();

  const int wr = warp * 16;
  unsigned qa[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const __nv_bfloat16* base = Qs + (wr + g) * kStride + kk * 16 + 2 * c;
    qa[kk][0] = *reinterpret_cast<const unsigned*>(base);
    qa[kk][1] = *reinterpret_cast<const unsigned*>(base + 8 * kStride);
    qa[kk][2] = *reinterpret_cast<const unsigned*>(base + 8);
    qa[kk][3] = *reinterpret_cast<const unsigned*>(base + 8 * kStride + 8);
  }

  float o[kDBlocks][4];
#pragma unroll
  for (int db = 0; db < kDBlocks; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[db][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const int kv_hi = causal ? min(Skv, q0 + kMmaBQ + offset) : Skv;

  for (int kv0 = 0; kv0 < kv_hi; kv0 += kMmaBK) {
    __syncthreads();   // every warp is done with the previous tile
    for (int idx = tid; idx < kMmaBK * kPieces; idx += kMmaThreads) {
      const int j = idx / kPieces, pc = idx - j * kPieces;
      const int kc = kv0 + j;
      const size_t gofs =
          (((size_t)b * Skv + min(kc, Skv - 1)) * Hkv + hk) * D + pc * 8;
      cp_async16_zfill(Ks + j * kStride + pc * 8, k + gofs, kc < Skv);
      cp_async16_zfill(Vs + j * kStride + pc * 8, v + gofs, kc < Skv);
    }
    cp_async_commit_wait_all();
    __syncthreads();

    // S = Q K^T: 8 column blocks of 8 keys
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const __nv_bfloat16* kp = Ks + (nb * 8 + g) * kStride + kk * 16 + 2 * c;
        mma_bf16(s[nb], qa[kk], *reinterpret_cast<const unsigned*>(kp),
                 *reinterpret_cast<const unsigned*>(kp + 8));
      }
    }

    // scale, mask, online softmax (rows row0 and row1; a row's 64 scores
    // live in the 4 lanes of one quad)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kv0 + nb * 8 + 2 * c + e;
        const bool k0 = row0 < Sq && col < Skv && (!causal || col <= row0 + offset);
        const bool k1 = row1 < Sq && col < Skv && (!causal || col <= row1 + offset);
        s[nb][e] = k0 ? s[nb][e] * scale : kNegInf;
        s[nb][2 + e] = k1 ? s[nb][2 + e] * scale : kNegInf;
        mx0 = fmaxf(mx0, s[nb][e]);
        mx1 = fmaxf(mx1, s[nb][2 + e]);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m_i[0], mx0), mn1 = fmaxf(m_i[1], mx1);
    const float al0 = expf(m_i[0] - mn0), al1 = expf(m_i[1] - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nb][e] = s[nb][e] > 0.5f * kNegInf ? expf(s[nb][e] - mn0) : 0.f;
        s[nb][2 + e] =
            s[nb][2 + e] > 0.5f * kNegInf ? expf(s[nb][2 + e] - mn1) : 0.f;
        rs0 += s[nb][e];
        rs1 += s[nb][2 + e];
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, o_);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, o_);
    }
    l_i[0] = l_i[0] * al0 + rs0;
    l_i[1] = l_i[1] * al1 + rs1;
    m_i[0] = mn0;
    m_i[1] = mn1;
#pragma unroll
    for (int db = 0; db < kDBlocks; ++db) {
      o[db][0] *= al0;
      o[db][1] *= al0;
      o[db][2] *= al1;
      o[db][3] *= al1;
    }

    // O += P V: the score fragments of key blocks 2j, 2j+1 are the A
    // fragment of k step j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int vrow = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, Vs + vrow * kStride + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  const float inv0 = l_i[0] > 0.f ? 1.f / l_i[0] : 0.f;
  const float inv1 = l_i[1] > 0.f ? 1.f / l_i[1] : 0.f;
#pragma unroll
  for (int db = 0; db < kDBlocks; ++db) {
    const int d = db * 8 + 2 * c;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((size_t)b * Sq + row0) * Hq + h) * D + d) =
          __floats2bfloat162_rn(o[db][0] * inv0, o[db][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((size_t)b * Sq + row1) * Hq + h) * D + d) =
          __floats2bfloat162_rn(o[db][2] * inv1, o[db][3] * inv1);
  }
  if (c == 0) {
    if (row0 < Sq)
      lse[((size_t)b * Hq + h) * Sq + row0] =
          l_i[0] > 0.f ? m_i[0] + logf(l_i[0]) : kNegInf;
    if (row1 < Sq)
      lse[((size_t)b * Hq + h) * Sq + row1] =
          l_i[1] > 0.f ? m_i[1] + logf(l_i[1]) : kNegInf;
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int Sq, int Skv, int Hq,
                       int Hkv, float scale, int causal, cudaStream_t st) {
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kernel = flash_attention_fwd_mma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, Hq, B);
  kernel<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, Sq, Skv, Hq, Hkv, scale, causal);
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                   float scale, int causal, cudaStream_t st) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_attention_fwd_kernel<D>;
  // above 48 KB only after opting in (per device, so on every launch)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Skv,
      Hq, Hkv, scale, causal);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  bfloat16 at D = 128 runs the
// tensor-core kernel, float32 at D = 16 the CUDA-core one; any other pair
// returns cudaErrorInvalidValue.  q, k, v 16-byte aligned.  Returns the
// launch's error (cudaGetLastError()).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int Sq, int Skv, int Hq, int Hkv,
                                   int D, float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (Hkv < 1 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0 && D == 128)
    e = launch_mma<128>(q, k, v, out, l, B, Sq, Skv, Hq, Hkv, scale, causal,
                        st);
  else if (dtype == 1 && D == 16)
    e = launch<16>(q, k, v, out, l, B, Sq, Skv, Hq, Hkv, scale, causal, st);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
