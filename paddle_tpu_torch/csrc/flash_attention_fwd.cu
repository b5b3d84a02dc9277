// Flash-attention forward: kernel K2 of paddle_tpu_torch, and its paged
// builds K2-paged and K2-paged-int8.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py _fwd (:192) /
// _fwd_kernel (:128): blocked online-softmax attention returning out and the
// float32 log-sum-exp.  Layout: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D);
// out (B, Sq, Hq, D); lse (B, Hq, Sq).  Causal masking is bottom-right
// aligned: query i sees keys j <= i + (Skv - Sq).  GQA: kv head = h / G.  A
// row with every key masked gives out = 0 and lse = -1e30.  Any Sq and Skv:
// the ragged edges are masked here.  Packed documents: optional int32
// segment ids seg_q (B, Sq) / seg_kv (B, Skv) (_mask_for :115); query i
// sees key j only where the two ids are equal.  SEG instantiates that test
// (the Hopper kernel stages each key tile's ids in shared memory); the
// unsegmented builds carry none of it.
//
// Paged suffix prefill (entries flash_attention_fwd_paged and
// flash_attention_fwd_paged_int8; replace the q-tiled mode of
// paddle_tpu/ops/pallas/decode_attention.py, body _kernel :120, grid
// :273-281, :319-335): the same attention with a per-row causal offset --
// query i of row b sees keys j <= pos[b] + i, and keys j < min(pos[b] +
// Sq, max_blocks * block_len) exist -- over one layer's (num_blocks,
// block_len, Hkv, D) pool through an int32 (B, max_blocks) block table:
// key j of row b lives at pool[table[b, j / block_len], j % block_len].
// The int8 pool comes with float32 scales k_scale / v_scale (num_blocks,
// Hkv), one per (block, kv head): K's scale is folded into the scores, V's
// into the tile's probabilities after the row sums took them unscaled
// (equal to scaling the tile's P.V before it joins the accumulator).  No
// lse is written on this path.
//
// Bound on the H100: max(causal FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s),
// the FLOPs at prefill shapes.  Common to every kernel below: K and V
// stream through shared memory in tiles with an online softmax, so the
// score matrix never reaches device memory, and causal tiles wholly above
// the diagonal are never loaded.  Two bodies (any other dtype / head dim
// is refused):
//   * 16-bit q (bfloat16; float16 in the library compiled with
//     -DPTT_F16) at any D <= 256 with D % 8 == 0 -- contiguous (the
//     serving waves and every training forward at D = 128, the DiT blocks
//     at D = 72; segmented or not), paged bf16 and paged int8 (the paged
//     engine's prefill waves, TinyLlama's at D = 64): the Hopper kernel,
//     flash_attention_fwd_wgmma_kernel -- 128-query tiles on two consumer
//     warpgroups, wgmma for Q.K^T and P.V, 128-key K/V tiles in an
//     mbarrier ring fed by TMA (paged: two 64-key boxes a tile, each at
//     its block's row; int8: boxes staged by TMA and converted to bf16 by
//     the producer warpgroup), exp2 with log2(e) in the scale, element
//     masks only on the tiles that cross the diagonal or the last key,
//     the heaviest q tiles first, and with segment ids every key tile
//     whose id range misses the q tile's skipped (see its notes).  Paged,
//     it takes block_len % 64 == 0;
//   * float32 at any D <= 256 with D % 8 == 0 (the tiny test models' 16,
//     float32 DiTs' 72 and the Qwen2-VL tower's 64, the reference's
//     float32 default configurations' 128 -- LlamaConfig(), the Qwen2-VL
//     decoder -- TinyLlama's 64, a Gemma-2B-wide Llama's 256), contiguous
//     or paged (any block_len, the table looked up per key, int8
//     dequantized per key): products on the CUDA cores -- each thread owns
//     a 4x4 tile of scores (rows tr*4.., keys tc*4..) and 4 rows x (D/16)
//     output elements, fed by 16-byte shared-memory reads of transposed Q
//     and K tiles; the K tile's shared memory is reused for the
//     probabilities (26 KB at D = 16, 58 KB at 72, 100 KB at 128: two CTAs
//     an SM still fit; 204.8 KB at 256, one).  D 16, 64, 72 and 128 have
//     instances of constant D (flash_attention_fwd_kernel), every other D
//     the same body at a runtime D in two width classes
//     (flash_attention_fwd_rt_kernel: D <= 128 and D <= 256).  wgmma has no
//     float32 input that keeps float32 numerics, so it stays here.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using ptt::pack16;
using namespace ptt;

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
// thread).  PAGED: pos/table addressing (see the top), else pos, table,
// max_blocks and block_len are unused.  KV: float, or int8_t for the int8
// pool (PAGED only), dequantized per key with its block's scales.
template <int D, bool PAGED, typename KV = float, bool SEG = false>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_fwd_kernel(const float* __restrict__ q,
                           const KV* __restrict__ k,
                           const KV* __restrict__ v,
                           float* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Skv, int Hq,
                           int Hkv, float scale, int causal,
                           const int* __restrict__ pos,
                           const int* __restrict__ table, int max_blocks,
                           int block_len,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ seg_q,
                           const int* __restrict__ seg_kv) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  static_assert(!INT8 || PAGED, "the int8 cache is paged only");
  constexpr int NQ = (D + 63) / 64;   // 64-wide output slabs per thread
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  // keys j < kv_len exist; query i sees j <= i + offset when causal
  int offset = Skv - Sq, kv_len = Skv;
  if constexpr (PAGED) {
    offset = pos[b];
    kv_len = min(offset + Sq, max_blocks * block_len);
  }
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
  int sq_i[4];   // segment id of each row (SEG)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + tr * 4 + i;
    sq_i[i] = (SEG && qr < Sq) ? seg_q[(size_t)b * Sq + qr] : 0;
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }

  const int kv_hi = causal ? min(kv_len, q0 + kBQ + offset) : kv_len;
  for (int kv0 = 0; kv0 < kv_hi; kv0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      const int kc = kv0 + c;
      float kx = 0.f, vx = 0.f;
      if (kc < kv_len) {
        size_t row = (size_t)b * Skv + kc;
        int blk = 0;
        if constexpr (PAGED) {
          blk = table[(size_t)b * max_blocks + kc / block_len];
          row = (size_t)blk * block_len + kc % block_len;
        }
        const size_t g = (row * Hkv + hk) * D + d;
        kx = static_cast<float>(k[g]);
        vx = static_cast<float>(v[g]);
        if constexpr (INT8) {
          kx *= k_scale[(size_t)blk * Hkv + hk];
          vx *= v_scale[(size_t)blk * Hkv + hk];
        }
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
        bool keep =
            qr < Sq && kc < kv_len && (!causal || kc <= qr + offset);
        if constexpr (SEG)
          keep = keep && sq_i[i] == seg_kv[(size_t)b * Skv + kc];
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
    if (!PAGED && tc == 0)
      lse[((size_t)b * Hq + h) * Sq + qr] = l > 0.f ? m_i[i] + logf(l) : kNegInf;
  }
}

template <int D, bool PAGED, typename KV = float, bool SEG = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                   float scale, int causal, cudaStream_t st,
                   const int* pos = nullptr, const int* table = nullptr,
                   int max_blocks = 0, int block_len = 0,
                   const float* k_scale = nullptr,
                   const float* v_scale = nullptr,
                   const int* seg_q = nullptr,
                   const int* seg_kv = nullptr) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_attention_fwd_kernel<D, PAGED, KV, SEG>;
  // above 48 KB only after opting in (per device, so on every launch)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<float*>(out), lse, Sq, Skv,
      Hq, Hkv, scale, causal, pos, table, max_blocks, block_len, k_scale,
      v_scale, seg_q, seg_kv);
  return cudaSuccess;
}

// float32 at a runtime head dim D (D % 8 == 0, D <= W): the body above with
// D an argument, for every D its constant-D instances (16, 64, 72, 128)
// leave out.  W, the output slabs a thread owns (NQ = W / 64, slabs past D
// neither accumulated nor stored), is 128 (D <= 128; two CTAs an SM, as
// the constant-D instances) or 256 (D <= 256: 64 accumulators a thread
// pass the 128 registers two CTAs allow, and the shared memory, D * 68 * 2
// + 64 * D floats, 204.8 KB at D 256, holds one CTA an SM above D 160
// anyway).  The Q.K^T loop runs over D, the tiles are sized by D (a
// launch's dynamic shared memory follows it), so nothing is computed or
// stored past D.
template <int W, bool PAGED, typename KV = float, bool SEG = false>
__global__ void __launch_bounds__(kThreads, W > 128 ? 1 : 2)
flash_attention_fwd_rt_kernel(const float* __restrict__ q,
                              const KV* __restrict__ k,
                              const KV* __restrict__ v,
                              float* __restrict__ out,
                              float* __restrict__ lse, int Sq, int Skv,
                              int Hq, int Hkv, int D, float scale,
                              int causal, const int* __restrict__ pos,
                              const int* __restrict__ table, int max_blocks,
                              int block_len,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ seg_q,
                              const int* __restrict__ seg_kv) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  static_assert(!INT8 || PAGED, "the int8 cache is paged only");
  static_assert(W == 128 || W == 256, "the float32 classes are 128 and 256");
  constexpr int NQ = W / 64;          // 64-wide output slabs per thread
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  int offset = Skv - Sq, kv_len = Skv;
  if constexpr (PAGED) {
    offset = pos[b];
    kv_len = min(offset + Sq, max_blocks * block_len);
  }
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
  int sq_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + tr * 4 + i;
    sq_i[i] = (SEG && qr < Sq) ? seg_q[(size_t)b * Sq + qr] : 0;
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }

  const int kv_hi = causal ? min(kv_len, q0 + kBQ + offset) : kv_len;
  for (int kv0 = 0; kv0 < kv_hi; kv0 += kBK) {
    __syncthreads();
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      const int kc = kv0 + c;
      float kx = 0.f, vx = 0.f;
      if (kc < kv_len) {
        size_t row = (size_t)b * Skv + kc;
        int blk = 0;
        if constexpr (PAGED) {
          blk = table[(size_t)b * max_blocks + kc / block_len];
          row = (size_t)blk * block_len + kc % block_len;
        }
        const size_t g = (row * Hkv + hk) * D + d;
        kx = static_cast<float>(k[g]);
        vx = static_cast<float>(v[g]);
        if constexpr (INT8) {
          kx *= k_scale[(size_t)blk * Hkv + hk];
          vx *= v_scale[(size_t)blk * Hkv + hk];
        }
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
    for (int d0 = 0; d0 < D; d0 += 8) {   // D % 8 == 0
#pragma unroll
      for (int d = d0; d < d0 + 8; ++d) {
        const float4 qa =
            *reinterpret_cast<const float4*>(&Qt[d * kPQ + tr * 4]);
        const float4 ka =
            *reinterpret_cast<const float4*>(&KP[d * kPK + tc * 4]);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + tr * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = kv0 + tc * 4 + j;
        bool keep =
            qr < Sq && kc < kv_len && (!causal || kc <= qr + offset);
        if constexpr (SEG)
          keep = keep && sq_i[i] == seg_kv[(size_t)b * Skv + kc];
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

    __syncthreads();
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
    if (!PAGED && tc == 0)
      lse[((size_t)b * Hq + h) * Sq + qr] = l > 0.f ? m_i[i] + logf(l) : kNegInf;
  }
}

// the float32 kernel at head dim D: its constant-D instance at 16, 64, 72
// and 128, else the runtime-D one of the least class W >= D
template <bool PAGED, typename KV = float, bool SEG = false>
cudaError_t launch_f32_at(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int Sq, int Skv,
                          int Hq, int Hkv, int D, float scale, int causal,
                          cudaStream_t st, const int* pos = nullptr,
                          const int* table = nullptr, int max_blocks = 0,
                          int block_len = 0, const float* k_scale = nullptr,
                          const float* v_scale = nullptr,
                          const int* seg_q = nullptr,
                          const int* seg_kv = nullptr) {
  if (D == 16 || D == 64 || D == 72 || D == 128) {
    const auto fn = D == 16   ? launch<16, PAGED, KV, SEG>
                    : D == 64 ? launch<64, PAGED, KV, SEG>
                    : D == 72 ? launch<72, PAGED, KV, SEG>
                              : launch<128, PAGED, KV, SEG>;
    return fn(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, scale, causal, st,
              pos, table, max_blocks, block_len, k_scale, v_scale, seg_q,
              seg_kv);
  }
  const auto kernel = D <= 128
                          ? flash_attention_fwd_rt_kernel<128, PAGED, KV, SEG>
                          : flash_attention_fwd_rt_kernel<256, PAGED, KV, SEG>;
  const size_t smem =
      ((size_t)D * kPQ + (size_t)(D > kBK ? D : kBK) * kPK + (size_t)kBK * D) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<float*>(out), lse, Sq, Skv, Hq,
      Hkv, D, scale, causal, pos, table, max_blocks, block_len, k_scale,
      v_scale, seg_q, seg_kv);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Hopper path: 16-bit q (the library's e16: bfloat16, or float16 where
// compiled with -DPTT_F16; mma_bf16.cuh) at any D <= 256 with D % 8 == 0
// -- K2 over contiguous K/V (segmented or not), K2-paged over a 16-bit
// pool and K2-paged-int8 over an int8 pool.
//
// The body is built for tiles HD = 128 wide (D <= 128) or HD = 256 wide
// (128 < D <= 256; Wg<HD> below).  At D < HD the tensor maps have D
// columns (bshd_map; the int8 pool's bshd_map_int8, or at D % 16 == 8 the
// cp.async staging, zero-fills the staged row past D), so columns D..HD-1
// of every Q, K and V tile hold zeros (a 64-wide box wholly past D too)
// and each box still completes its full byte count on the mbarrier (the
// staging's copies count as arrivals): Q K^T sums zero products over the
// pad, P V writes zeros into the output's pad columns, and the out map's
// store drops them.  The products then do HD / D times the useful work
// (1.78x at D = 72, 1.88x at D = 136).  The wide tiles narrow the key
// tile to 64, as the reference narrows its blocks by D / 128
// (flash_attention.py:56-71): a 128 x 256 Q tile (64 KB) and two stages of
// 64-key K and V tiles (2 x 64 KB) fit where two stages of 128 x 256 ones
// would not (320 KB), and the int8 build keeps one staging stage of 2 x
// 16 KB (230.6 KB in all, of the 227 KB a block may take).  A consumer's
// out tile is then m64n256 (128 float32 registers a thread), its score
// tile m64n64.
//
// One CTA per (128-query tile, q head, batch row); a 1-D grid that starts
// the heaviest causal q tiles (the last: the most keys, whatever the
// offset) of every head first.  Three warpgroups: consumers 0 and 1 own
// query rows [64w, 64w + 64) of the tile; warpgroup 2 feeds them K and V
// through a ring of two stages of 128-key tiles (64-key at HD 256; bf16,
// 128-byte swizzle, a 64-wide box a 64 columns of a row) with full and
// empty mbarriers for K
// and for V, and writes into the stage's slot which tile it holds and
// whether that tile needs the element mask (it crosses the causal
// diagonal or the last key, or, with segment ids, its ids and the q
// tile's are not all one value); a slot of -1 ends the walk.  The walk
// goes from the diagonal down.  Who fills the ring:
//   * contiguous: one producer warp, K/V by TMA (4-d maps over (B, S, H,
//     D); rows past Skv load as zero).  With segment ids it skips every
//     key tile whose [min, max] id range misses the q tile's (the ranges
//     come from segment_tile_ranges on the host; exact for any ids), and
//     stages the tile's ids by TMA beside K;
//   * paged bf16: the same warp with the block table: the pool
//     (num_blocks, block_len, Hkv, D) has the rank and order of (B, S,
//     Hkv, D) with the block id in the batch's place, so a tile is two
//     64-key boxes a tensor half (one at HD 256) at (row in block, block
//     id) (TMA has no gather); 64 divides block_len, so no box crosses a
//     block, and a half at or past the row's last key repeats the first
//     half's box, so no dead table column is read.  Box rows past the
//     last key hold stale pool data: the tile is flagged and its element
//     mask hides them;
//   * paged int8: the producer's lane 0 loads the int8 boxes the same way
//     by TMA into a staging ring of two stages, one at HD 256 (at D % 16
//     == 8 the pool's
//     D-byte head stride is no multiple of 16, which a TMA map needs: the
//     whole warpgroup stages the boxes by 8-byte cp.async copies, zeros
//     past D, and each thread's copies arrive on the unit's barrier when
//     they land); the whole warpgroup then
//     converts each tile to 16 bits (exact for [-128, 127]: the bytes
//     into 16-bit mantissas, one pair subtraction; int8x4_to_e16) in the swizzled
//     layout TMA would write, and releases it to the consumers after a
//     proxy fence.  Each 64-key half carries its block's K and V scales in
//     the slot (two blocks a tile at block_len 64).
// Consumers: S = Q K^T on wgmma.m64n128k16 (m64n64k16 at HD 256; Q and K
// from shared memory,
// K-major), the online softmax in registers in the log2 domain (exp2,
// log2(e) folded into the scale; the row max of the raw scores -- int8:
// of the scores times each half's K scale), P rounded to bf16 in
// registers as the register A operand of O += P V (int8: P times each
// half's V scale, after the row sums took it unscaled; at float16 relative
// to the tile's larger V scale, O kept in units of it), with V MN-major
// from shared memory (the transpose flag).  Each consumer issues the next
// tile's Q K^T and this tile's P V back to back and runs the next softmax
// while P V is in flight (K and V have separate empty barriers, so K is
// released as soon as its scores are masked); two named barriers order
// the two warpgroups' issues so that one's softmax runs under the other's
// products.  The out tile goes through Q's shared memory (a warpgroup's
// own rows, after its last Q K^T) and a TMA store that drops rows past
// Sq.  Paged: query i of row b sees keys j <= pos[b] + i, keys j <
// min(pos[b] + Sq, max_blocks * block_len) exist, and no lse is written.
// ---------------------------------------------------------------------------
constexpr int kHQ = 128;              // queries per CTA (2 x 64)
constexpr int kHStages = 2;
constexpr int kHThreads = 384;        // consumers: warpgroups 0, 1; producer 2
constexpr int kHConsumers = 256;
constexpr int kHBox = 64;             // key rows of a paged box
constexpr int kRange = 128;           // tokens of a segment range (kv_rng)
constexpr float kLn2 = 0.6931471805599453f;
// setmaxnreg moves registers only within the CTA: launched at 168 a
// thread, the three warpgroups share 3 x 168.  bf16: consumers 240, the
// producer 24; int8: consumers 216, the converting warpgroup 72 (at 56
// its loop spills).
constexpr int kConvRegs = 72;
constexpr int kInt8ConsumerRegs = (3 * 168 - kConvRegs) / 2;
static_assert(kConvRegs % 8 == 0 && kInt8ConsumerRegs % 8 == 0,
              "setmaxnreg takes multiples of 8");

// The tile shapes at tile width HD (128: D <= 128; 256: D <= 256).  A
// tile row is HD / 64 boxes of 64 bf16 columns (128 bytes, 128-byte
// swizzle), each box a stack of rows.
template <int HD>
struct Wg {
  static_assert(HD == 128 || HD == 256, "tiles are 128 or 256 wide");
  static constexpr int kBoxes = HD / 64;          // boxes a tile row
  static constexpr int kK = HD == 128 ? 128 : 64; // keys a tile
  static constexpr int kKBoxes = kK / kHBox;      // paged boxes a key tile
  static constexpr int kQBox = kHQ * 128;         // bytes of a Q box
  static constexpr int kKBox = kK * 128;          // of a K or V box
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kKTile = kBoxes * kKBox;
  static constexpr int k8Tile = kK * HD;          // a staged int8 tile
  static constexpr int kStages8 = HD == 128 ? 2 : 1;   // int8 staging
  static constexpr int kSeg = stage_ints(kK + kLead1d);   // a tile's ids
  static constexpr int kQSteps = HD / 16;         // k steps of Q K^T
  static constexpr int kPSteps = kK / 16;         // k steps of P V
  static constexpr int kS = kK / 2;   // score floats a consumer thread
  static constexpr int kO = HD / 2;   // out floats a consumer thread
};

// what warpgroup 2 tells the consumers about the tile of a stage
struct Slot {
  int tile;       // key tile index, -1: the walk is over
  int masked;     // the tile needs the element mask
  float ks[2];    // int8: K's scale of keys [0, 64) and [64, 128)
                  //   (one 64-key box at HD 256: ks[0])
  float vs[2];    // int8: V's (float16: over the tile's larger, vm; the
                  //   slot that ends the walk: the last tile's vm)
#ifdef PTT_F16
  float ra;       // int8: the previous tile's vm over this one's
#endif
};

template <bool SEG, bool INT8, int HD>
constexpr size_t hopper_smem() {
  using W = Wg<HD>;
  return 1024 + (size_t)W::kQTile + 2 * kHStages * (size_t)W::kKTile +
         (INT8 ? (size_t)W::kStages8 * 2 * W::k8Tile : 0) +
         (SEG ? (size_t)kHStages * W::kSeg * 4 : 0) +
         kHStages * sizeof(Slot) + (1 + 4 * kHStages + 2 * W::kStages8) * 8 +
         (INT8 ? kHStages * 8 * sizeof(float) : 0);
}
static_assert(hopper_smem<false, true, 128>() <= 232448 &&
                  hopper_smem<true, false, 128>() <= 232448 &&
                  hopper_smem<false, true, 256>() <= 232448 &&
                  hopper_smem<true, false, 256>() <= 232448,
              "every build fits the 227 KB a block may take");

// the kernel's scalar arguments
struct HopperArgs {
  float* lse;                  // contiguous: (B, Hq, Sq)
  const int* seg_q;            // SEG: (B, Sq)
  const int* q_rng;            // SEG: (B, ceil(Sq / 128), 2)
  const int* kv_rng;           // SEG: (B, ceil(Skv / 128), 2)
  const int* pos;              // paged: (B,)
  const int* table;            // paged: (B, max_blocks)
  const float* k_scale;        // int8: (num_blocks, Hkv)
  const float* v_scale;
  const unsigned char* k8;     // int8 at D % 16 == 8: the pools, staged by
  const unsigned char* v8;     //   cp.async (no TMA map)
  int B, Sq, Skv, Hq, Hkv, max_blocks, block_len, D;
  float scale_log2;
  int causal;
};

// paged: the pool coordinates (block id, row in block) of the N (1 or 2)
// 64-key boxes of the key tile at k0 of a row whose table row is `trow`; a
// second box at or past kv_len repeats the first's
template <int N>
__device__ __forceinline__ void paged_boxes(const int* trow, int block_len,
                                            int k0, int kv_len, int (&blk)[N],
                                            int (&row)[N]) {
  blk[0] = trow[k0 / block_len];
  row[0] = k0 % block_len;
  if constexpr (N == 2) {
    if (k0 + kHBox >= kv_len) {
      blk[1] = blk[0];
      row[1] = row[0];
    } else if (row[0] + kHBox < block_len) {
      blk[1] = blk[0];
      row[1] = row[0] + kHBox;
    } else {
      blk[1] = trow[(k0 + kHBox) / block_len];
      row[1] = 0;
    }
  }
}

// a staged int8 tile (kK rows of HD bytes, unswizzled) as the bf16 tile
// the consumers read (HD / 64 boxes of 64 columns, 128-byte swizzle).
// Each thread of the warpgroup converts 8 of the tile's 1024 16-byte int8
// pieces into two 16-byte bf16 chunks.  The 8 lanes of a quarter warp (one
// shared-memory wavefront of 16-byte accesses) take 4 pieces of one row
// and 4 of the next, of boxes of opposite parity (HD 128: pieces 0-3 and
// 4-7; HD 256: boxes q and q ^ 1): they read 128 bytes on distinct banks
// and write 8 distinct swizzled chunk positions, free of bank conflicts.
template <int HD>
__device__ __forceinline__ void convert_tile(const unsigned char* src,
                                             unsigned char* dst, int t) {
  using W = Wg<HD>;
  constexpr int kRowsPass = 128 * 16 / HD;   // rows the 128 threads take
  const int lane = t & 31, hi = (lane >> 2) & 1;
  const int c = HD == 128 ? 4 * (hi ^ ((lane >> 3) & 1)) + (lane & 3)
                          : 4 * (((lane >> 3) & 3) ^ hi) + (lane & 3);
  const int r_base = HD == 128 ? 4 * (t >> 5) + 2 * (lane >> 4) + hi
                               : 2 * (t >> 5) + hi;
  unsigned char* box = dst + (c >> 2) * W::kKBox;
  const int p = 2 * (c & 3);
#pragma unroll 2
  for (int i = 0; i < W::kK / kRowsPass; ++i) {
    const int r = kRowsPass * i + r_base;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * HD + c * 16);
    uint4 a, b;
    int8x4_to_e16(raw.x, a.x, a.y);
    int8x4_to_e16(raw.y, a.z, a.w);
    int8x4_to_e16(raw.z, b.x, b.y);
    int8x4_to_e16(raw.w, b.z, b.w);
    unsigned char* row = box + r * 128;
    *reinterpret_cast<uint4*>(row + ((p ^ (r & 7)) << 4)) = a;
    *reinterpret_cast<uint4*>(row + (((p + 1) ^ (r & 7)) << 4)) = b;
  }
}

// CP8 (INT8 only): the int8 pool at D % 16 == 8, staged by cp.async; HD:
// the tile width (Wg)
template <bool SEG, bool PAGED, bool INT8, bool CP8, int HD>
__global__ void __launch_bounds__(kHThreads, 1)
flash_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap o_map,
                                 const __grid_constant__ CUtensorMap seg_map,
                                 const HopperArgs a) {
  static_assert(PAGED || !INT8, "the int8 cache is paged only");
  static_assert(!(PAGED && SEG), "the paged builds take no segment ids");
  static_assert(INT8 || !CP8, "only the int8 pool is staged by cp.async");
  using W = Wg<HD>;
  constexpr int kK = W::kK, kS8 = W::kStages8;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = Qs + W::kQTile;                   // [stage]
  unsigned char* Vs = Ks + kHStages * W::kKTile;        // [stage]
  // int8: [staging stage][K, V] staged int8 tiles
  unsigned char* S8 = Vs + kHStages * W::kKTile;
  // [stage][W::kSeg]: a key tile's ids, read (b * Skv + k0) & 3 in
  int* seg_s =
      reinterpret_cast<int*>(S8 + (INT8 ? kS8 * 2 * W::k8Tile : 0));
  Slot* slot = reinterpret_cast<Slot*>(seg_s + (SEG ? kHStages * W::kSeg : 0));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(slot + kHStages);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kHStages;
  uint64_t* k_empty = v_full + kHStages;
  uint64_t* v_empty = k_empty + kHStages;
  uint64_t* s_full = v_empty + kHStages;   // int8: [staging][K, V]
  // int8, thread 0 of the producer warpgroup: [stage][ks 0, 1, vs 0, 1]
  // and [stage][block 0, 1, row 0, 1] of the tile staged next
  float* scl = reinterpret_cast<float*>(s_full + 2 * kS8);
  int* bx = reinterpret_cast<int*>(scl + 4 * kHStages);

  const int Sq = a.Sq, Hq = a.Hq, causal = a.causal;
  const int n_qt = (Sq + kHQ - 1) / kHQ;
  const int bh = blockIdx.x % (Hq * a.B);
  const int qt = n_qt - 1 - blockIdx.x / (Hq * a.B);
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / a.Hkv);
  const int q0 = qt * kHQ;
  // query i sees keys j <= i + offset; keys j < kv_len exist
  int offset = a.Skv - Sq, kv_len = a.Skv;
  if constexpr (PAGED) {
    offset = a.pos[b];
    kv_len = min(offset + Sq, a.max_blocks * a.block_len);
  }
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(&k_full[s], INT8 ? 128 : 1);
      mbar_init(&v_full[s], INT8 ? 128 : 1);
      mbar_init(&k_empty[s], kHConsumers);
      mbar_init(&v_empty[s], kHConsumers);
    }
    for (int u = 0; u < 2 * kS8; ++u) mbar_init(&s_full[u], CP8 ? 128 : 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int kv_hi = causal ? min(kv_len, q0 + kHQ + offset) : kv_len;
  const int n_kt = kv_hi > 0 ? (kv_hi + kK - 1) / kK : 0;
  if (wg == 2) {
    if constexpr (INT8) {
      // ---- int8: TMA into the staging ring, the warpgroup converts -------
      reg_dealloc<kConvRegs>();
      const int* trow = a.table + (size_t)b * a.max_blocks;
      // Staging unit 2u + x holds tensor x (0: K, 1: V) of a tile in
      // staging stage u (of kS8); tile t is the walk's t-th (from the
      // diagonal down).  Thread 0 reads the table and the scales; the
      // others only convert (CP8: every thread also reads the table and
      // stages its share of the boxes).
      constexpr int kKB = W::kKBoxes;
      auto load = [&](int t, int x, const int* blk, const int* row) {
        const int u = 2 * (t % kS8) + x;
        if (CP8) {
          // kK rows x HD / 8 pieces of 8 bytes; pieces at or past D zero
          constexpr int kPieces = HD / 8;
          const unsigned char* src = x ? a.v8 : a.k8;
          unsigned char* dst = S8 + u * W::k8Tile;
          for (int i = tid; i < kK * kPieces; i += 128) {
            const int r = i / kPieces, pc = i % kPieces, e = r / kHBox;
            const bool in = 8 * pc < a.D;
            const size_t off =
                (((size_t)blk[e] * a.block_len + row[e] + r % kHBox) * a.Hkv +
                 hk) * a.D + 8 * pc;
            cp_async8(dst + r * HD + 8 * pc, in ? src + off : src,
                      in ? 8 : 0);
          }
          mbar_arrive_cp_async(&s_full[u]);
          return;
        }
        fence_proxy_async();
        mbar_expect_tx(&s_full[u], W::k8Tile);
#pragma unroll
        for (int e = 0; e < kKB; ++e)
          tma_load_4d(S8 + u * W::k8Tile + e * kHBox * HD,
                      x ? &v_map : &k_map, &s_full[u], 0, hk, row[e], blk[e]);
      };
      auto boxes = [&](int t, int (&blk)[kKB], int (&row)[kKB]) {
        paged_boxes<kKB>(trow, a.block_len, (n_kt - 1 - t) * kK, kv_len, blk,
                         row);
      };
      // the K and V scales of each 64-key box (one box: both slots its)
      auto scales = [&](const int* blk, float (&dst)[4]) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const size_t i = (size_t)blk[e % kKB] * a.Hkv + hk;
          dst[e] = a.k_scale[i];
          dst[2 + e] = a.v_scale[i];
        }
      };
      // thread 0: a tile's scales are loaded when its K is staged and
      // stored into scl after the next conversion, or when step_k reaches
      // the tile (pend_t: that tile, or -1); its boxes wait in bx for its
      // V staging
      float pend[4];
      int pend_t = -1;
#ifdef PTT_F16
      // thread 0: the V scale of the last tile given (a Slot's ra)
      float vref = 0.f;
#endif
      auto store_pending = [&] {
        if (pend_t < 0) return;
#pragma unroll
        for (int x = 0; x < 4; ++x) scl[(pend_t % kHStages) * 4 + x] = pend[x];
        pend_t = -1;
      };
      if (tid == 0) {
        mbar_expect_tx(q_full, W::kQTile);
#pragma unroll
        for (int x = 0; x < W::kBoxes; ++x)
          tma_load_4d(Qs + x * W::kQBox, &q_map, q_full, 64 * x, h, q0, b);
      }
      if (tid == 0 || CP8) {
        for (int t = 0; t < kS8 && t < n_kt; ++t) {
          int blk[kKB], row[kKB];
          boxes(t, blk, row);
          load(t, 0, blk, row);
          load(t, 1, blk, row);
          if (tid == 0) {
            scales(blk, pend);
            pend_t = t;
            store_pending();
          }
        }
      }
      // K of tile t: it may run a tile ahead of V (its slot frees earlier).
      // Its scales were loaded when its K was staged; thread 0 stores them
      // (store_pending) before it reads them (one staging stage: tile t's
      // K was staged by step_k(t - 1))
      auto step_k = [&](int t) {
        const int s = t % kHStages, k0 = (n_kt - 1 - t) * kK;
        const int u = t % kS8;
        const unsigned ph = (t / kHStages) & 1;
        const bool refill = t + kS8 < n_kt;
        int nblk[kKB], nrow[kKB];
        mbar_wait(&s_full[2 * u], (t / kS8) & 1);
        mbar_wait(&k_empty[s], ph ^ 1);
        if (tid == 0) {
          store_pending();
          Slot sl;
          sl.tile = n_kt - 1 - t;
          sl.masked = k0 + kK - 1 > q0 + offset || k0 + kK > kv_len;
          sl.ks[0] = scl[s * 4];
          sl.ks[1] = scl[s * 4 + 1];
          sl.vs[0] = scl[s * 4 + 2];
          sl.vs[1] = scl[s * 4 + 3];
#ifdef PTT_F16
          // the V scales over the tile's larger, and the change of unit
          // from the previous tile's (the consumers' pack)
          const float vm = fmaxf(sl.vs[0], sl.vs[1]);
          const float inv = vm > 0.f ? 1.f / vm : 0.f;
          sl.ra = vm > 0.f ? vref * inv : 1.f;
          sl.vs[0] *= inv;
          sl.vs[1] *= inv;
          vref = vm > 0.f ? vm : vref;
#endif
          slot[s] = sl;
        }
        // the next tile's table entries, read under the conversion
        if (refill && (tid == 0 || CP8)) boxes(t + kS8, nblk, nrow);
        convert_tile<HD>(S8 + 2 * u * W::k8Tile, Ks + s * W::kKTile, tid);
        fence_proxy_async();
        mbar_arrive(&k_full[s]);
        if (refill) {
          named_barrier(5, 128);   // every thread is done with the unit
          if (CP8) load(t + kS8, 0, nblk, nrow);
          if (tid == 0) {
            if (!CP8) load(t + kS8, 0, nblk, nrow);
            for (int e = 0; e < kKB; ++e) {
              bx[s * 4 + e] = nblk[e];
              bx[s * 4 + 2 + e] = nrow[e];
            }
            store_pending();
            scales(nblk, pend);
            pend_t = t + kS8;
          }
        }
      };
      auto step_v = [&](int t) {
        const int s = t % kHStages, u = t % kS8;
        const unsigned ph = (t / kHStages) & 1;
        const bool refill = t + kS8 < n_kt;
        int vblk[kKB], vrow[kKB];   // CP8: the boxes of V's next tile
        if (CP8 && refill) boxes(t + kS8, vblk, vrow);
        mbar_wait(&s_full[2 * u + 1], (t / kS8) & 1);
        mbar_wait(&v_empty[s], ph ^ 1);
        convert_tile<HD>(S8 + (2 * u + 1) * W::k8Tile, Vs + s * W::kKTile,
                         tid);
        fence_proxy_async();
        mbar_arrive(&v_full[s]);
        if (refill) {
          named_barrier(5, 128);
          if (CP8)
            load(t + kS8, 1, vblk, vrow);
          else if (tid == 0)
            load(t + kS8, 1, bx + s * 4, bx + s * 4 + 2);
        }
        if (tid == 0) store_pending();
      };
      if (n_kt > 0) step_k(0);
      for (int t = 0; t < n_kt; ++t) {
        if (t + 1 < n_kt) step_k(t + 1);
        step_v(t);
      }
      const int s = n_kt % kHStages;
      mbar_wait(&k_empty[s], ((n_kt / kHStages) & 1) ^ 1);
      if (tid == 0) {
        slot[s].tile = -1;
#ifdef PTT_F16
        slot[s].vs[0] = vref;   // the unit o ends in
#endif
      }
      mbar_arrive(&k_full[s]);
    } else {
      // ---- producer warp: K/V by TMA ---------------------------------------
      reg_dealloc<24>();
      if (tid >= 32) return;
      const int lane = tid;
      const int n_kvt = (a.Skv + kRange - 1) / kRange;
      if (lane == 0) {   // Q first: the ranges below wait on global loads
        mbar_expect_tx(q_full, W::kQTile);
#pragma unroll
        for (int x = 0; x < W::kBoxes; ++x)
          tma_load_4d(Qs + x * W::kQBox, &q_map, q_full, 64 * x, h, q0, b);
      }
      int qmin = 0, qmax = 0;
      if constexpr (SEG) {
        qmin = a.q_rng[((size_t)b * n_qt + qt) * 2];
        qmax = a.q_rng[((size_t)b * n_qt + qt) * 2 + 1];
      }
      int it = 0;
      // 32 key tiles at a time, lane l deciding tile base - l
      for (int base = n_kt - 1; base >= 0; base -= 32) {
        const int j = base - lane;
        bool vis = j >= 0;
        bool masked = vis && ((causal && j * kK + kK - 1 > q0 + offset) ||
                              j * kK + kK > kv_len);
        if constexpr (SEG) {
          if (vis) {
            // the range of the kRange-token tile holding key tile j (at
            // kK 64 a superset of its own: exact all the same)
            const int jr = j * kK / kRange;
            const int kmin = a.kv_rng[((size_t)b * n_kvt + jr) * 2];
            const int kmax = a.kv_rng[((size_t)b * n_kvt + jr) * 2 + 1];
            vis = kmax >= qmin && kmin <= qmax;
            masked = masked || kmin != kmax || qmin != qmax || kmin != qmin;
          }
        }
        unsigned todo = __ballot_sync(0xffffffffu, vis);
        const unsigned mask_bits = __ballot_sync(0xffffffffu, masked);
        if (lane != 0) continue;
        while (todo) {
          const int l = __ffs(todo) - 1;
          todo &= todo - 1;
          const int jt = base - l, k0 = jt * kK;
          const int s = it % kHStages;
          const unsigned free_parity = ((it / kHStages) & 1) ^ 1;
          unsigned char* kd = Ks + s * W::kKTile;
          unsigned char* vd = Vs + s * W::kKTile;
          int blk[W::kKBoxes], row[W::kKBoxes];
          if constexpr (PAGED)
            paged_boxes<W::kKBoxes>(a.table + (size_t)b * a.max_blocks,
                                    a.block_len, k0, kv_len, blk, row);
          // the tile's boxes: d box x of every row; paged, key box e (64
          // rows) of each at its block's row
          auto load_tile = [&](unsigned char* dst, const CUtensorMap* m,
                               uint64_t* bar) {
#pragma unroll
            for (int x = 0; x < W::kBoxes; ++x) {
              if constexpr (PAGED) {
#pragma unroll
                for (int e = 0; e < W::kKBoxes; ++e)
                  tma_load_4d(dst + x * W::kKBox + e * kHBox * 128, m, bar,
                              64 * x, hk, row[e], blk[e]);
              } else {
                tma_load_4d(dst + x * W::kKBox, m, bar, 64 * x, hk, k0, b);
              }
            }
          };
          mbar_wait(&k_empty[s], free_parity);
          slot[s].tile = jt;
          slot[s].masked = (mask_bits >> l) & 1;
          mbar_expect_tx(&k_full[s],
                         W::kKTile + (SEG ? (kK + kLead1d) * 4 : 0));
          load_tile(kd, &k_map, &k_full[s]);
          if constexpr (SEG)
            tma_load_1d(seg_s + s * W::kSeg, &seg_map, &k_full[s],
                        (b * a.Skv + k0) & ~3);
          mbar_wait(&v_empty[s], free_parity);
          mbar_expect_tx(&v_full[s], W::kKTile);
          load_tile(vd, &v_map, &v_full[s]);
          ++it;
        }
      }
      if (lane == 0) {
        const int s = it % kHStages;
        mbar_wait(&k_empty[s], ((it / kHStages) & 1) ^ 1);
        slot[s].tile = -1;
        mbar_arrive(&k_full[s]);
      }
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  reg_alloc<INT8 ? kInt8ConsumerRegs : 240>();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int rl = wg * 64 + warp * 16 + g;   // rows rl, rl + 8 of the tile
  const int r0 = q0 + rl, r1 = r0 + 8;
  int sq0 = 0, sq1 = 0;
  if constexpr (SEG) {
    sq0 = r0 < Sq ? a.seg_q[(size_t)b * Sq + r0] : 0;
    sq1 = r1 < Sq ? a.seg_q[(size_t)b * Sq + r1] : 0;
  }
  // s * scale == (-s) * (-scale): the row max is taken on raw scores
  const bool negate = a.scale_log2 < 0.f;
  const float sl2 = fabsf(a.scale_log2);
  constexpr int kSN = W::kS, kON = W::kO;
  float o[kON];
#pragma unroll
  for (int i = 0; i < kON; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float al0 = 0.f, al1 = 0.f;   // the last softmax's rescale of the sums
  // float16 int8: the V scale o is in units of (see pack), from the slot
  // that ends the walk
  float vref = 0.f;
  const unsigned char* qa = Qs + wg * 64 * 128;

  // S = Q K^T of the key tile in stage s: k step t reads 32 bytes into
  // d box t / 4 of Q and of K
  auto issue_s = [&](float (&sc)[kSN], int s) {
    const unsigned char* kt = Ks + s * W::kKTile;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < W::kQSteps; ++t) {
      const int col = (t % 4) * 32;
      wgmma_ss<0, 0>(sc, gmma_desc(qa + (t / 4) * W::kQBox + col, 16, 1024),
                     gmma_desc(kt + (t / 4) * W::kKBox + col, 16, 1024),
                     t > 0);
    }
    wgmma_commit();
  };
  // a key tile's ids start `lead` into their stage, the same for every
  // tile of the CTA (k0 is a multiple of 4)
  const int lead = SEG ? (b * a.Skv) & 3 : 0;
  auto mask_ids = [&](float (&sc)[kSN], int k0, const int* ids) {
#pragma unroll
    for (int j = 0; j < kK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * j + 2 * c + (e & 1);
        const int col = k0 + cl;
        bool keep = col < kv_len &&
                    (!causal || col <= (e < 2 ? r0 : r1) + offset);
        if constexpr (SEG) keep = keep && ids[cl] == (e < 2 ? sq0 : sq1);
        if (!keep) sc[4 * j + e] = -INFINITY;
      }
    }
  };
  // the scores' sign (int8: times each half's K scale), then the element
  // mask of a tile the producer flagged; at lead 0 the ids' loads pair up
  // (sc[i] holds keys 8 (i / 4) + ..: those of 64-key box i / 32)
  auto mask = [&](float (&sc)[kSN], const Slot& sl, int s) {
    if constexpr (INT8) {
      const float k0s = negate ? -sl.ks[0] : sl.ks[0];
      const float k1s = negate ? -sl.ks[1] : sl.ks[1];
#pragma unroll
      for (int i = 0; i < kSN; ++i) sc[i] *= i < 32 ? k0s : k1s;
    } else if (negate) {
#pragma unroll
      for (int i = 0; i < kSN; ++i) sc[i] = -sc[i];
    }
    if (!sl.masked) return;
    const int* ids = seg_s + s * W::kSeg;
    if (lead == 0)
      mask_ids(sc, sl.tile * kK, ids);
    else
      mask_ids(sc, sl.tile * kK, ids + lead);
  };
  // online softmax: row r0 holds sc[4j], sc[4j + 1], row r1 sc[4j + 2],
  // sc[4j + 3]; a row's kK scores live in the 4 lanes of a quad.  sc
  // becomes the probabilities; al0 / al1 the rescale of the sums so far.
  auto softmax = [&](float (&sc)[kSN]) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    // a row with no key seen yet keeps 0 as its base: exp2(-inf) = 0
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    al0 = exp2_approx(m0 - mu0);
    al1 = exp2_approx(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kK / 8; ++j) {
      sc[4 * j] = exp2_approx(fmaf(sc[4 * j], sl2, -mu0));
      sc[4 * j + 1] = exp2_approx(fmaf(sc[4 * j + 1], sl2, -mu0));
      sc[4 * j + 2] = exp2_approx(fmaf(sc[4 * j + 2], sl2, -mu1));
      sc[4 * j + 3] = exp2_approx(fmaf(sc[4 * j + 3], sl2, -mu1));
      rs0 += sc[4 * j] + sc[4 * j + 1];
      rs1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    // per-thread partial row sums; the quad's are added at the end
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
  };
  // P rounded to 16 bits (int8: times each half's V scale): the register
  // A operand of k step t is sc[8t..8t+7]
  auto pack = [&](float (&sc)[kSN], const Slot& sl,
                  uint32_t (&pa)[W::kPSteps][4]) {
    if constexpr (INT8) {
#pragma unroll
      for (int i = 0; i < kSN; ++i) sc[i] *= i < 32 ? sl.vs[0] : sl.vs[1];
#ifdef PTT_F16
      // float16 has 5 exponent bits: P times a small V scale (1e-4) would
      // round into its subnormals.  The producer gives the halves' V
      // scales relative to the tile's larger, vm, and o is kept in units
      // of the latest tile's vm (the change of unit, sl.ra, rides on the
      // softmax's rescale before this tile's P V), so P keeps its float16
      // precision and the scale itself is applied in float32, as the
      // reference scales the float32 P.V product (decode_attention.py
      // :185-187)
      al0 *= sl.ra;
      al1 *= sl.ra;
#endif
    }
#pragma unroll
    for (int t = 0; t < W::kPSteps; ++t) {
      pa[t][0] = pack16(sc[8 * t], sc[8 * t + 1]);
      pa[t][1] = pack16(sc[8 * t + 2], sc[8 * t + 3]);
      pa[t][2] = pack16(sc[8 * t + 4], sc[8 * t + 5]);
      pa[t][3] = pack16(sc[8 * t + 6], sc[8 * t + 7]);
    }
  };

  // Scheduler barriers 3 + w: warpgroup w issues its products once the
  // other has issued its own, so one's softmax runs under the other's
  // products.  Warpgroup 0 goes first.
  mbar_wait(q_full, 0);
  if (wg == 1) named_barrier_arrive(3, 256);
  mbar_wait(&k_full[0], 0);
  const Slot sl0 = slot[0];
  if (sl0.tile >= 0) {
    float sc[kSN];
    uint32_t pa[W::kPSteps][4];
    named_barrier(3 + wg, 256);
    issue_s(sc, 0);
    named_barrier_arrive(4 - wg, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    mask(sc, sl0, 0);
    mbar_arrive(&k_empty[0]);
    softmax(sc);
    pack(sc, sl0, pa);
    // tile `cur` (stage cur % 2) has its P in pa; per iteration: issue S
    // of the next tile, rescale O (idle: the last P V is done) under it,
    // issue P V of this tile, then run the next tile's softmax while P V
    // is in flight
    auto rescale_o = [&] {
#pragma unroll
      for (int j = 0; j < kON / 4; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
    };
    // V MN-major: k step t starts 16 key rows (2048 bytes) in, the d
    // boxes kKBox apart
    auto issue_pv = [&](int sv) {
      const unsigned char* vt = Vs + sv * W::kKTile;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < W::kPSteps; ++t)
        wgmma_rs<1>(o, pa[t], gmma_desc(vt + t * 2048, W::kKBox, 1024), 1);
      wgmma_commit();
    };
    // At HD 256 the int8 consumers (216 registers: o 128, S 32, P 16 and
    // the rest) and the segmented ones (the ids' registers besides) run
    // this tile's P V to its end before the next tile's Q K^T, so P and S
    // are never held at once (both spilled otherwise); the two warpgroups
    // still take turns
    constexpr bool kSerial = HD == 256 && (INT8 || SEG);
    int cur = 0;
    for (;; ++cur) {
      const int nxt = cur + 1, sn = nxt % kHStages, sv = cur % kHStages;
      mbar_wait(&k_full[sn], (nxt / kHStages) & 1);
      const Slot sl = slot[sn];
      if (sl.tile < 0) {
        if constexpr (INT8 && kHalf) vref = sl.vs[0];
        break;
      }
      named_barrier(3 + wg, 256);
      if constexpr (kSerial) {
        rescale_o();
        mbar_wait(&v_full[sv], (cur / kHStages) & 1);
        issue_pv(sv);
        named_barrier_arrive(4 - wg, 256);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&v_empty[sv]);
        issue_s(sc, sn);
        wgmma_wait<0>();
      } else {
        issue_s(sc, sn);
        rescale_o();
        mbar_wait(&v_full[sv], (cur / kHStages) & 1);
        issue_pv(sv);
        named_barrier_arrive(4 - wg, 256);
        wgmma_wait<1>();
      }
      fence_regs(sc);
      mask(sc, sl, sn);
      mbar_arrive(&k_empty[sn]);
      softmax(sc);
      if constexpr (!kSerial) {
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&v_empty[sv]);
      }
      pack(sc, sl, pa);
    }
    // the last tile's P V
    named_barrier(3 + wg, 256);
    rescale_o();
    mbar_wait(&v_full[cur % kHStages], (cur / kHStages) & 1);
    issue_pv(cur % kHStages);
    named_barrier_arrive(4 - wg, 256);
    wgmma_wait<0>();
    fence_regs(o);
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if constexpr (INT8 && kHalf) {
    inv0 *= vref;
    inv1 *= vref;
  }
  // the out tile into this warpgroup's rows of Q's shared memory, in the
  // swizzled layout the out map stores from
#pragma unroll
  for (int j = 0; j < kON / 4; ++j) {
    unsigned char* base = Qs + (j / 8) * W::kQBox +
                          (((j % 8) ^ (rl & 7)) << 4) + 4 * c;
    *reinterpret_cast<uint32_t*>(base + rl * 128) =
        pack16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(base + (rl + 8) * 128) =
        pack16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (tid == 0 && q0 + wg * 64 < Sq) {
#pragma unroll
    for (int x = 0; x < W::kBoxes; ++x)
      tma_store_4d(&o_map, Qs + x * W::kQBox + wg * 64 * 128, 64 * x, h,
                   q0 + wg * 64, b);
    tma_store_commit_wait();
  }
  if (!PAGED && c == 0) {
    float* lrow = a.lse + ((size_t)b * Hq + h) * Sq;
    if (r0 < Sq) lrow[r0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : kNegInf;
    if (r1 < Sq) lrow[r1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : kNegInf;
  }
}

// Encodes the maps and launches the Hopper kernel at tile width HD.  q,
// out (B, Sq, Hq, D) bf16, D <= HD and D % 8 == 0.  Contiguous: k, v (B,
// Skv, Hkv, D) bf16.  Paged: k, v one layer's (num_blocks, block_len, Hkv,
// D) pool, bf16 or (INT8) int8, with a.pos / a.table set and block_len %
// 64 == 0; an int8 pool at D % 16 == 8 has no map (the kernel stages it by
// cp.async).
template <bool SEG, bool PAGED, bool INT8, int HD>
cudaError_t launch_wgmma_at(const void* q, const void* k, const void* v,
                            void* out, const int* seg_kv, HopperArgs a,
                            int num_blocks, float scale, cudaStream_t st,
                            int D) {
  using W = Wg<HD>;
  a.D = D;
  a.k8 = static_cast<const unsigned char*>(k);
  a.v8 = static_cast<const unsigned char*>(v);
  CUtensorMap qm, km, vm, om, sm;
  memset(&sm, 0, sizeof(sm));
  cudaError_t e = bshd_map(&qm, q, a.B, a.Sq, a.Hq, kHQ, D);
  if (e == cudaSuccess) e = bshd_map(&om, out, a.B, a.Sq, a.Hq, kHQ / 2, D);
  // K / V: (B, Skv) rows of kK-key boxes, or the pool's (num_blocks,
  // block_len) rows of 64-key boxes
  auto kv_map = [&](CUtensorMap* m, const void* p) {
    if (INT8 && D % 16 != 0) {
      memset(m, 0, sizeof(*m));
      return cudaSuccess;
    }
    if (INT8)
      return bshd_map_int8(m, p, num_blocks, a.block_len, a.Hkv, kHBox, D,
                           HD);
    if (PAGED)
      return bshd_map(m, p, num_blocks, a.block_len, a.Hkv, kHBox, D);
    return bshd_map(m, p, a.B, a.Skv, a.Hkv, W::kK, D);
  };
  if (e == cudaSuccess) e = kv_map(&km, k);
  if (e == cudaSuccess) e = kv_map(&vm, v);
  if (e == cudaSuccess && SEG)
    e = flat_map(&sm, CU_TENSOR_MAP_DATA_TYPE_INT32, seg_kv,
                 (size_t)a.B * a.Skv, W::kK + kLead1d);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = hopper_smem<SEG, INT8, HD>();
  auto kernel = flash_attention_fwd_wgmma_kernel<SEG, PAGED, INT8, false, HD>;
  if constexpr (INT8) {
    if (D % 16 != 0)
      kernel = flash_attention_fwd_wgmma_kernel<SEG, PAGED, INT8, true, HD>;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const long long ctas = (long long)((a.Sq + kHQ - 1) / kHQ) * a.Hq * a.B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.scale_log2 = scale * 1.4426950408889634f;
  kernel<<<(unsigned)ctas, kHThreads, smem, st>>>(qm, km, vm, om, sm, a);
  return cudaSuccess;
}

// the Hopper kernel at any D <= 256 with D % 8 == 0: 128-wide tiles up to
// D 128, 256-wide ones above
template <bool SEG, bool PAGED, bool INT8>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, const int* seg_kv, HopperArgs a,
                         int num_blocks, float scale, cudaStream_t st,
                         int D) {
  if (D < 8 || D > 256 || D % 8 != 0) return cudaErrorInvalidValue;
  return D <= 128 ? launch_wgmma_at<SEG, PAGED, INT8, 128>(
                        q, k, v, out, seg_kv, a, num_blocks, scale, st, D)
                  : launch_wgmma_at<SEG, PAGED, INT8, 256>(
                        q, k, v, out, seg_kv, a, num_blocks, scale, st, D);
}

}  // namespace

#ifndef PTT_F16
// the float32 CUDA-core kernel over contiguous K/V at head dim D, with or
// without segment ids
static cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                       int D, float scale, int causal, const int* seg_q,
                       const int* seg_kv, cudaStream_t st) {
  if (seg_q != nullptr)
    return launch_f32_at<false, float, true>(
        q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D, scale, causal, st, nullptr,
        nullptr, 0, 0, nullptr, nullptr, seg_q, seg_kv);
  return launch_f32_at<false>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, D,
                              scale, causal, st);
}

// the head dims the float32 builds take: D <= 256, D % 8 == 0
static bool head_dim_built(int D) {
  return D >= 8 && D <= 256 && D % 8 == 0;
}
#endif

// dtype: 0 = bfloat16, 1 = float32, 2 = float16.  The library's 16-bit
// type (bfloat16; float16 alone in the library compiled with -DPTT_F16) at
// any D <= 256 with D % 8 == 0 runs the Hopper kernel (q, k, v, out
// 16-byte aligned), float32 at the same head dims (the default library)
// the CUDA-core one; any other pair returns cudaErrorInvalidValue.  seg_q (B, Sq) and seg_kv (B, Skv): int32
// packed-document ids, or both null; query i sees key j only where
// seg_q[b, i] == seg_kv[b, j] (and causally).  With ids the 16-bit build
// also takes q_rng (B, ceil(Sq / 128), 2) and kv_rng (B, ceil(Skv / 128),
// 2): the int32 [min, max] id of each 128-token tile
// (segment_tile_ranges); the float32 build ignores them.  Returns the
// launch's error (cudaGetLastError()).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const void* seg_q, const void* seg_kv,
                                   const void* q_rng, const void* kv_rng,
                                   int B, int Sq, int Skv, int Hq, int Hkv,
                                   int D, float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int* sq = static_cast<const int*>(seg_q);
  const int* skv = static_cast<const int*>(seg_kv);
  if (Hkv < 1 || Hq % Hkv != 0 || (sq == nullptr) != (skv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  HopperArgs a = {};
  a.lse = l;
  a.seg_q = sq;
  a.q_rng = static_cast<const int*>(q_rng);
  a.kv_rng = static_cast<const int*>(kv_rng);
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  // segment ids select their own instantiation: the unsegmented one
  // carries no segment test
  cudaError_t e;
  if (dtype == kE16Code && sq != nullptr)
    e = (a.q_rng == nullptr || a.kv_rng == nullptr)
            ? cudaErrorInvalidValue
            : launch_wgmma<true, false, false>(q, k, v, out, skv, a, 0,
                                               scale, st, D);
  else if (dtype == kE16Code)
    e = launch_wgmma<false, false, false>(q, k, v, out, nullptr, a, 0, scale,
                                          st, D);
#ifndef PTT_F16
  else if (dtype == 1 && head_dim_built(D))
    e = launch_f32(q, k, v, out, l, B, Sq, Skv, Hq, Hkv, D, scale, causal, sq,
                   skv, st);
#endif
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the Hopper kernel's arguments of a paged suffix prefill
static HopperArgs paged_args(const void* pos, const void* table, int B,
                             int S, int Hq, int Hkv, int max_blocks,
                             int block_len) {
  HopperArgs a = {};
  a.pos = static_cast<const int*>(pos);
  a.table = static_cast<const int*>(table);
  a.B = B;
  a.Sq = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.max_blocks = max_blocks;
  a.block_len = block_len;
  a.causal = 1;
  return a;
}

// Paged suffix prefill: q (B, S, Hq, D) at per-row offsets pos (B,)
// int32; k, v one layer's (num_blocks, block_len, Hkv, D) pool; table the
// int32 (B, max_blocks) block table (every entry a valid block id).  Query
// i of row b sees keys j <= pos[b] + i, j < max_blocks * block_len.
// The library's 16-bit type at any D <= 256 with D % 8 == 0 (the Hopper
// kernel) needs block_len % 64 == 0; float32 at the same head dims takes
// any block_len >= 1; other cases return cudaErrorInvalidValue.
extern "C" int flash_attention_fwd_paged(const void* q, const void* k,
                                         const void* v, const void* pos,
                                         const void* table, void* out, int B,
                                         int S, int Hq, int Hkv, int D,
                                         int num_blocks, int max_blocks,
                                         int block_len, float scale,
                                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(table);
  if (Hkv < 1 || Hq % Hkv != 0 || max_blocks < 1 || block_len < 1 ||
      num_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == kE16Code && block_len % kHBox == 0)
    e = launch_wgmma<false, true, false>(
        q, k, v, out, nullptr,
        paged_args(pos, table, B, S, Hq, Hkv, max_blocks, block_len),
        num_blocks, scale, st, D);
#ifndef PTT_F16
  else if (dtype == 1 && head_dim_built(D))
    e = launch_f32_at<true>(q, k, v, out, nullptr, B, S, 0, Hq, Hkv, D, scale,
                            1, st, p, t, max_blocks, block_len);
#endif
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Paged int8 suffix prefill: as flash_attention_fwd_paged with k, v one
// layer's int8 (num_blocks, block_len, Hkv, D) pool and k_scale, v_scale
// float32 (num_blocks, Hkv).  16-bit q at any D <= 256 with D % 8 == 0
// needs block_len % 64 == 0; float32 q at the same head dims takes any
// block_len >= 1.
extern "C" int flash_attention_fwd_paged_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* pos, const void* table, void* out,
    int B, int S, int Hq, int Hkv, int D, int num_blocks, int max_blocks,
    int block_len, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(table);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (Hkv < 1 || Hq % Hkv != 0 || max_blocks < 1 || block_len < 1 ||
      num_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == kE16Code && block_len % kHBox == 0) {
    HopperArgs a = paged_args(pos, table, B, S, Hq, Hkv, max_blocks,
                              block_len);
    a.k_scale = ks;
    a.v_scale = vs;
    e = launch_wgmma<false, true, true>(q, k, v, out, nullptr, a, num_blocks,
                                        scale, st, D);
#ifndef PTT_F16
  } else if (dtype == 1 && head_dim_built(D)) {
    e = launch_f32_at<true, int8_t>(q, k, v, out, nullptr, B, S, 0, Hq, Hkv,
                                    D, scale, 1, st, p, t, max_blocks,
                                    block_len, ks, vs);
#endif
  } else {
    e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
