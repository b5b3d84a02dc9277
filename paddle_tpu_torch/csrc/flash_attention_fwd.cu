// Flash-attention forward: kernel K2 of paddle_tpu_torch.
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
// Bound on the H100: max(causal FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s),
// the FLOPs at prefill shapes.  Common to every kernel below: K and V
// stream through shared memory in tiles with an online softmax, so the
// score matrix never reaches device memory, and causal tiles wholly above
// the diagonal are never loaded.  Three bodies (any other dtype / head dim
// is refused):
//   * bfloat16 at D = 128, contiguous K/V (the serving waves and every
//     training forward; segmented or not): the Hopper kernel,
//     flash_attention_fwd_wgmma_kernel -- 128-query tiles on two consumer
//     warpgroups, wgmma for Q.K^T and P.V, K/V by TMA into an mbarrier
//     ring fed by a producer warp, exp2 with log2(e) in the scale, element
//     masks only on the tiles that cross the diagonal or the ragged end,
//     the heaviest q tiles first, and with segment ids every key tile
//     whose id range misses the q tile's skipped (see its notes);
//   * bfloat16 at D = 128, paged (below): mma.sync.m16n8k16, one CTA per
//     64-query tile, 64-key tiles by cp.async or converted from int8 --
//     flash_attention_fwd_mma_kernel, the earlier body less its
//     segment-id branch; it is the counterpart of another TPU kernel (the
//     q-tiled mode of decode_attention.py), whose redesign is a later
//     step;
//   * float32 at D = 16 (the tiny test model): products on the CUDA cores
//     -- each thread owns a 4x4 tile of scores (rows tr*4.., keys tc*4..)
//     and 4 rows x (D/16) output elements, fed by 16-byte shared-memory
//     reads of transposed Q and K tiles; the K tile's shared memory is
//     reused for the probabilities (26 KB at D = 16).  wgmma has no
//     float32 input that keeps float32 numerics, so it stays here.
//
// Paged suffix prefill (entry flash_attention_fwd_paged; replaces the
// q-tiled mode of paddle_tpu/ops/pallas/decode_attention.py, body _kernel
// :120, grid :273-281, :319-335).  The mma.sync and float32 kernels with
// PAGED = true, two changes:
//   * the causal offset is per row: query i of row b sees keys
//     j <= pos[b] + i, and keys j < min(pos[b] + Sq, max_blocks *
//     block_len) exist (instead of the shared Skv - Sq and Skv); tile
//     skipping keys off the row's own offset;
//   * K and V come from one layer's (num_blocks, block_len, Hkv, D) pool
//     through an int32 (B, max_blocks) block table: key j of row b lives
//     at pool[table[b, j / block_len], j % block_len].  The tensor-core
//     kernel looks the table up once per 64-key tile, so it takes
//     block_len % 64 == 0; the CUDA-core kernel looks it up per key.
//   No lse is written on this path.
//
// Paged int8 suffix prefill (entry flash_attention_fwd_paged_int8;
// replaces the quantized mode of the same Pallas kernel): the pool holds
// int8 K/V and float32 scales k_scale / v_scale (num_blocks, Hkv), one
// per (block, kv head).  The tensor-core kernel loads each 64-key int8
// tile through the table into registers (16 bytes a load), converts it to
// bf16 (exact for [-127, 127]) into the same shared-memory tiles, folds
// K's block scale into the score scale and V's into the tile's
// probabilities before their bf16 packing (equal to scaling the tile's
// P.V before it joins the accumulator; the row sums take the unscaled
// probabilities).  The float32 kernel dequantizes per key.  INT8 = false
// leaves the two kernels above unchanged.
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

using ptt::cp_async16_zfill;
using ptt::cp_async_commit_wait_all;
using ptt::ldmatrix_x4_trans;
using ptt::mma_bf16;
using ptt::pack_bf16;
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

// ---------------------------------------------------------------------------
// Tensor-core path of the paged builds: bfloat16, D = 128.
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

template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kMmaBQ + 2 * kMmaBK) * (D + 8) * sizeof(__nv_bfloat16);
}

// 16 int8 values (one 16-byte load) as 16 bfloat16 at dst (32 bytes,
// 16-byte aligned); exact for [-128, 127]
__device__ __forceinline__ void int8x16_to_bf16(const uint4 raw,
                                                __nv_bfloat16* dst) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  uint4 lo, hi;
  unsigned* l = reinterpret_cast<unsigned*>(&lo);
  unsigned* h = reinterpret_cast<unsigned*>(&hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = pack_bf16(static_cast<float>(e[2 * i]),
                     static_cast<float>(e[2 * i + 1]));
    h[i] = pack_bf16(static_cast<float>(e[8 + 2 * i]),
                     static_cast<float>(e[8 + 2 * i + 1]));
  }
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

// KV: __nv_bfloat16, or int8_t for the int8 pool (PAGED only; see the
// top) with its scales k_scale / v_scale.  Only the paged builds are
// instantiated (the contiguous ones run the Hopper kernel below).
template <int D, bool PAGED, typename KV = __nv_bfloat16>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const KV* __restrict__ k,
                               const KV* __restrict__ v,
                               __nv_bfloat16* __restrict__ out,
                               float* __restrict__ lse, int Sq, int Skv,
                               int Hq, int Hkv, float scale, int causal,
                               const int* __restrict__ pos,
                               const int* __restrict__ table, int max_blocks,
                               int block_len,
                               const float* __restrict__ k_scale,
                               const float* __restrict__ v_scale) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  static_assert(!INT8 || PAGED, "the int8 cache is paged only");
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
  // keys j < kv_len exist; query i sees j <= i + offset when causal
  int offset = Skv - Sq, kv_len = Skv;
  if constexpr (PAGED) {
    offset = pos[b];
    kv_len = min(offset + Sq, max_blocks * block_len);
  }
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
  const int kv_hi = causal ? min(kv_len, q0 + kMmaBQ + offset) : kv_len;

  for (int kv0 = 0; kv0 < kv_hi; kv0 += kMmaBK) {
    __syncthreads();   // every warp is done with the previous tile
    // paged: the pool row of key kv0 (block_len % 64 == 0, so the whole
    // tile lies in one block and every address is inside the pool)
    size_t tile_row = 0;
    int blk = 0;
    if constexpr (PAGED) {
      blk = table[(size_t)b * max_blocks + kv0 / block_len];
      tile_row = (size_t)blk * block_len + kv0 % block_len;
    }
    float k_mul = scale;   // the score scale (int8: times K's block scale)
    float v_mul = 1.f;     // int8: V's block scale
    if constexpr (INT8) {
      // int8 tile: 16-byte register loads (all in flight before the
      // conversion), converted to bf16 into the same tiles
      constexpr int kP8 = D / 16;   // 16-byte pieces of an int8 row
      constexpr int kPer = kMmaBK * kP8 / kMmaThreads;
      static_assert(kMmaBK * kP8 % kMmaThreads == 0, "tile split");
      uint4 kr[kPer], vr[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + i * kMmaThreads;
        const int j = idx / kP8, pc = idx - j * kP8;
        const size_t gofs = ((tile_row + j) * Hkv + hk) * D + pc * 16;
        const bool on = kv0 + j < kv_len;
        kr[i] = on ? *reinterpret_cast<const uint4*>(k + gofs)
                   : make_uint4(0u, 0u, 0u, 0u);
        vr[i] = on ? *reinterpret_cast<const uint4*>(v + gofs)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + i * kMmaThreads;
        const int j = idx / kP8, pc = idx - j * kP8;
        int8x16_to_bf16(kr[i], Ks + j * kStride + pc * 16);
        int8x16_to_bf16(vr[i], Vs + j * kStride + pc * 16);
      }
      k_mul = scale * k_scale[(size_t)blk * Hkv + hk];
      v_mul = v_scale[(size_t)blk * Hkv + hk];
    } else {
      for (int idx = tid; idx < kMmaBK * kPieces; idx += kMmaThreads) {
        const int j = idx / kPieces, pc = idx - j * kPieces;
        const int kc = kv0 + j;
        size_t row = (size_t)b * Skv + min(kc, Skv - 1);
        if constexpr (PAGED) row = tile_row + j;
        const size_t gofs = (row * Hkv + hk) * D + pc * 8;
        cp_async16_zfill(Ks + j * kStride + pc * 8, k + gofs, kc < kv_len);
        cp_async16_zfill(Vs + j * kStride + pc * 8, v + gofs, kc < kv_len);
      }
      cp_async_commit_wait_all();
    }
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
        const bool k0 =
            row0 < Sq && col < kv_len && (!causal || col <= row0 + offset);
        const bool k1 =
            row1 < Sq && col < kv_len && (!causal || col <= row1 + offset);
        s[nb][e] = k0 ? s[nb][e] * k_mul : kNegInf;
        s[nb][2 + e] = k1 ? s[nb][2 + e] * k_mul : kNegInf;
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

    // int8: V's block scale weights the tile's probabilities (after the
    // row sums took them unscaled)
    if constexpr (INT8) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] *= v_mul;
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
  if (!PAGED && c == 0) {
    if (row0 < Sq)
      lse[((size_t)b * Hq + h) * Sq + row0] =
          l_i[0] > 0.f ? m_i[0] + logf(l_i[0]) : kNegInf;
    if (row1 < Sq)
      lse[((size_t)b * Hq + h) * Sq + row1] =
          l_i[1] > 0.f ? m_i[1] + logf(l_i[1]) : kNegInf;
  }
}

template <int D, bool PAGED, typename KV = __nv_bfloat16>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int Sq, int Skv, int Hq,
                       int Hkv, float scale, int causal, cudaStream_t st,
                       const int* pos = nullptr, const int* table = nullptr,
                       int max_blocks = 0, int block_len = 0,
                       const float* k_scale = nullptr,
                       const float* v_scale = nullptr) {
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kernel = flash_attention_fwd_mma_kernel<D, PAGED, KV>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, Hq, B);
  kernel<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<__nv_bfloat16*>(out),
      lse, Sq, Skv, Hq, Hkv, scale, causal, pos, table, max_blocks,
      block_len, k_scale, v_scale);
  return cudaSuccess;
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

// ---------------------------------------------------------------------------
// Hopper path: bfloat16, D = 128, contiguous K/V (K2, segmented or not).
//
// One CTA per (128-query tile, q head, batch row); a 1-D grid that starts
// the heaviest causal q tiles (the last) of every head first.  Three
// warpgroups: consumers 0 and 1 own query rows [64w, 64w + 64) of the
// tile; one warp of warpgroup 2 is the producer, which loads Q once and
// then streams 128-key K and V tiles by TMA (4-d tensor maps over the
// (B, S, H, D) tensors, two 64-wide boxes a 128-wide row, 128-byte
// swizzle; rows past Sq / Skv load as zero) into a ring of two stages
// with full and empty mbarriers for K and for V.  The producer walks the
// key tiles from the diagonal down, and writes into the stage's slot which
// tile it loaded and whether that tile needs the element mask (it crosses
// the causal diagonal or the ragged end, or, with segment ids, its ids
// and the q tile's are not all one value); a slot of -1 ends the walk.
// With segment ids it skips every key tile whose [min, max] id range
// misses the q tile's (the ranges come from segment_tile_ranges on the
// host; exact for any ids), and stages the tile's ids by TMA beside K.
// Consumers: S = Q K^T on wgmma.m64n128k16 (Q and K from shared memory,
// K-major), the online softmax in registers in the log2 domain (exp2,
// log2(e) folded into the scale; the row max of the raw scores), P
// rounded to bf16 in registers as the register A operand of O += P V,
// with V MN-major from shared memory (the transpose flag).  Each consumer
// issues the next tile's Q K^T and this tile's P V back to back and runs
// the next softmax while P V is in flight (K and V have separate empty
// barriers, so K is released as soon as its scores are masked); two named
// barriers order the two warpgroups' issues so that one's softmax runs
// under the other's products.  The out tile goes through Q's shared
// memory (a warpgroup's own rows, after its last Q K^T) and a TMA store
// that drops rows past Sq.
// ---------------------------------------------------------------------------
constexpr int kHD = 128;              // head_dim of the build
constexpr int kHQ = 128;              // queries per CTA (2 x 64)
constexpr int kHK = 128;              // keys per tile
constexpr int kHStages = 2;
constexpr int kHThreads = 384;        // consumers: warpgroups 0, 1; producer 2
constexpr int kHConsumers = 256;
constexpr int kHHalf = 128 * 128;     // a 128-row x 64-wide bf16 box, bytes
constexpr int kHTile = 2 * kHHalf;    // a 128-row x 128-wide tile
constexpr size_t kHSmem = 1024 + (size_t)(1 + 2 * kHStages) * kHTile +
                          kHStages * kHK * 4 + kHStages * 8 +
                          (1 + 4 * kHStages) * 8;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool SEG>
__global__ void __launch_bounds__(kHThreads, 1)
flash_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap o_map,
                                 const __grid_constant__ CUtensorMap seg_map,
                                 float* __restrict__ lse,
                                 const int* __restrict__ seg_q,
                                 const int* __restrict__ q_rng,
                                 const int* __restrict__ kv_rng, int B,
                                 int Sq, int Skv, int Hq, int Hkv,
                                 float scale_log2, int causal) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = Qs + kHTile;                      // [stage]
  unsigned char* Vs = Ks + kHStages * kHTile;           // [stage]
  int* seg_s = reinterpret_cast<int*>(Vs + kHStages * kHTile);  // [stage][128]
  int2* slot = reinterpret_cast<int2*>(seg_s + kHStages * kHK);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(slot + kHStages);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kHStages;
  uint64_t* k_empty = v_full + kHStages;
  uint64_t* v_empty = k_empty + kHStages;

  const int n_qt = (Sq + kHQ - 1) / kHQ;
  const int bh = blockIdx.x % (Hq * B);
  const int qt = n_qt - 1 - blockIdx.x / (Hq * B);
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kHQ;
  const int offset = Skv - Sq;   // query i sees keys j <= i + offset
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kHConsumers);
      mbar_init(&v_empty[s], kHConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer --------------------------------------------------------
    reg_dealloc<24>();
    if (tid >= 32) return;
    const int lane = tid;
    const int kv_hi = causal ? min(Skv, q0 + kHQ + offset) : Skv;
    const int n_kt = kv_hi > 0 ? (kv_hi + kHK - 1) / kHK : 0;
    const int n_kvt = (Skv + kHK - 1) / kHK;
    int qmin = 0, qmax = 0;
    if constexpr (SEG) {
      qmin = q_rng[((size_t)b * n_qt + qt) * 2];
      qmax = q_rng[((size_t)b * n_qt + qt) * 2 + 1];
    }
    if (lane == 0) {
      mbar_expect_tx(q_full, kHTile);
      tma_load_4d(Qs, &q_map, q_full, 0, h, q0, b);
      tma_load_4d(Qs + kHHalf, &q_map, q_full, 64, h, q0, b);
    }
    int it = 0;
    // 32 key tiles at a time, lane l deciding tile base - l
    for (int base = n_kt - 1; base >= 0; base -= 32) {
      const int j = base - lane;
      bool vis = j >= 0;
      bool masked = vis && ((causal && j * kHK + kHK - 1 > q0 + offset) ||
                            j * kHK + kHK > Skv);
      if constexpr (SEG) {
        if (vis) {
          const int kmin = kv_rng[((size_t)b * n_kvt + j) * 2];
          const int kmax = kv_rng[((size_t)b * n_kvt + j) * 2 + 1];
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
        const int jt = base - l, k0 = jt * kHK;
        const int s = it % kHStages;
        const unsigned free_parity = ((it / kHStages) & 1) ^ 1;
        mbar_wait(&k_empty[s], free_parity);
        slot[s] = make_int2(jt, (mask_bits >> l) & 1);
        unsigned char* kd = Ks + s * kHTile;
        unsigned char* vd = Vs + s * kHTile;
        mbar_expect_tx(&k_full[s], kHTile + (SEG ? kHK * 4 : 0));
        tma_load_4d(kd, &k_map, &k_full[s], 0, hk, k0, b);
        tma_load_4d(kd + kHHalf, &k_map, &k_full[s], 64, hk, k0, b);
        if constexpr (SEG)
          tma_load_1d(seg_s + s * kHK, &seg_map, &k_full[s], b * Skv + k0);
        mbar_wait(&v_empty[s], free_parity);
        mbar_expect_tx(&v_full[s], kHTile);
        tma_load_4d(vd, &v_map, &v_full[s], 0, hk, k0, b);
        tma_load_4d(vd + kHHalf, &v_map, &v_full[s], 64, hk, k0, b);
        ++it;
      }
    }
    if (lane == 0) {
      const int s = it % kHStages;
      mbar_wait(&k_empty[s], ((it / kHStages) & 1) ^ 1);
      slot[s] = make_int2(-1, 0);
      mbar_arrive(&k_full[s]);
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  reg_alloc<240>();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int rl = wg * 64 + warp * 16 + g;   // rows rl, rl + 8 of the tile
  const int r0 = q0 + rl, r1 = r0 + 8;
  int sq0 = 0, sq1 = 0;
  if constexpr (SEG) {
    sq0 = r0 < Sq ? seg_q[(size_t)b * Sq + r0] : 0;
    sq1 = r1 < Sq ? seg_q[(size_t)b * Sq + r1] : 0;
  }
  // s * scale == (-s) * (-scale): the row max is taken on raw scores
  const bool negate = scale_log2 < 0.f;
  const float sl2 = fabsf(scale_log2);
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float al0 = 0.f, al1 = 0.f;   // the last softmax's rescale of the sums
  const unsigned char* qa = Qs + wg * 64 * 128;

  // S = Q K^T of the key tile in stage s
  auto issue_s = [&](float (&sc)[64], int s) {
    const unsigned char* kt = Ks + s * kHTile;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int off = (t / 4) * kHHalf + (t % 4) * 32;
      wgmma_ss<0, 0>(sc, gmma_desc(qa + off, 16, 1024),
                     gmma_desc(kt + off, 16, 1024), t > 0);
    }
    wgmma_commit();
  };
  // the element mask of a tile the producer flagged (sl.y)
  auto mask = [&](float (&sc)[64], int2 sl, int s) {
    if (negate) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = -sc[i];
    }
    if (!sl.y) return;
    const int k0 = sl.x * kHK;
    const int* ids = seg_s + s * kHK;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * j + 2 * c + (e & 1);
        const int col = k0 + cl;
        bool keep = col < Skv &&
                    (!causal || col <= (e < 2 ? r0 : r1) + offset);
        if constexpr (SEG) keep = keep && ids[cl] == (e < 2 ? sq0 : sq1);
        if (!keep) sc[4 * j + e] = -INFINITY;
      }
    }
  };
  // online softmax: row r0 holds sc[4j], sc[4j + 1], row r1 sc[4j + 2],
  // sc[4j + 3]; a row's 128 scores live in the 4 lanes of a quad.  sc
  // becomes the probabilities; al0 / al1 the rescale of the sums so far.
  auto softmax = [&](float (&sc)[64]) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
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
    for (int j = 0; j < 16; ++j) {
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
  // P rounded to bf16: the register A operand of k step t is sc[8t..8t+7]
  auto pack = [&](const float (&sc)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      pa[t][0] = pack_bf16(sc[8 * t], sc[8 * t + 1]);
      pa[t][1] = pack_bf16(sc[8 * t + 2], sc[8 * t + 3]);
      pa[t][2] = pack_bf16(sc[8 * t + 4], sc[8 * t + 5]);
      pa[t][3] = pack_bf16(sc[8 * t + 6], sc[8 * t + 7]);
    }
  };

  // Scheduler barriers 3 + w: warpgroup w issues its products once the
  // other has issued its own, so one's softmax runs under the other's
  // products.  Warpgroup 0 goes first.
  mbar_wait(q_full, 0);
  if (wg == 1) named_barrier_arrive(3, 256);
  mbar_wait(&k_full[0], 0);
  const int2 sl0 = slot[0];
  if (sl0.x >= 0) {
    float sc[64];
    uint32_t pa[8][4];
    named_barrier(3 + wg, 256);
    issue_s(sc, 0);
    named_barrier_arrive(4 - wg, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    mask(sc, sl0, 0);
    mbar_arrive(&k_empty[0]);
    softmax(sc);
    pack(sc, pa);
    // tile `cur` (stage cur % 2) has its P in pa; per iteration: issue S
    // of the next tile, rescale O (idle: the last P V is done) under it,
    // issue P V of this tile, then run the next tile's softmax while P V
    // is in flight
    auto rescale_o = [&] {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
    };
    auto issue_pv = [&](int sv) {
      const unsigned char* vt = Vs + sv * kHTile;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 8; ++t)
        wgmma_rs<1>(o, pa[t], gmma_desc(vt + t * 2048, kHHalf, 1024), 1);
      wgmma_commit();
    };
    int cur = 0;
    for (;; ++cur) {
      const int nxt = cur + 1, sn = nxt % kHStages, sv = cur % kHStages;
      mbar_wait(&k_full[sn], (nxt / kHStages) & 1);
      const int2 sl = slot[sn];
      if (sl.x < 0) break;
      named_barrier(3 + wg, 256);
      issue_s(sc, sn);
      rescale_o();
      mbar_wait(&v_full[sv], (cur / kHStages) & 1);
      issue_pv(sv);
      named_barrier_arrive(4 - wg, 256);
      wgmma_wait<1>();
      fence_regs(sc);
      mask(sc, sl, sn);
      mbar_arrive(&k_empty[sn]);
      softmax(sc);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&v_empty[sv]);
      pack(sc, pa);
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
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  // the out tile into this warpgroup's rows of Q's shared memory, in the
  // swizzled layout the out map stores from
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    unsigned char* base = Qs + (j / 8) * kHHalf + (((j % 8) ^ (rl & 7)) << 4) +
                          4 * c;
    *reinterpret_cast<uint32_t*>(base + rl * 128) =
        pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(base + (rl + 8) * 128) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (tid == 0 && q0 + wg * 64 < Sq) {
    tma_store_4d(&o_map, Qs + wg * 64 * 128, 0, h, q0 + wg * 64, b);
    tma_store_4d(&o_map, Qs + kHHalf + wg * 64 * 128, 64, h, q0 + wg * 64, b);
    tma_store_commit_wait();
  }
  if (c == 0) {
    float* lrow = lse + ((size_t)b * Hq + h) * Sq;
    if (r0 < Sq) lrow[r0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : kNegInf;
    if (r1 < Sq) lrow[r1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : kNegInf;
  }
}

// a tensor map over one (B, S, H, 128) bf16 tensor: boxes of `rows`
// consecutive s and 64 of the 128 d, 128-byte swizzle
cudaError_t bshd_map(CUtensorMap* m, const void* p, int B, int S, int H,
                     int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)kHD, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)kHD * 2;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, dims, strides,
                    box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool SEG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, const int* seg_q,
                         const int* seg_kv, const int* q_rng,
                         const int* kv_rng, int B, int Sq, int Skv, int Hq,
                         int Hkv, float scale, int causal, cudaStream_t st) {
  CUtensorMap qm, km, vm, om, sm;
  memset(&sm, 0, sizeof(sm));
  cudaError_t e = bshd_map(&qm, q, B, Sq, Hq, kHQ);
  if (e == cudaSuccess) e = bshd_map(&km, k, B, Skv, Hkv, kHK);
  if (e == cudaSuccess) e = bshd_map(&vm, v, B, Skv, Hkv, kHK);
  if (e == cudaSuccess) e = bshd_map(&om, out, B, Sq, Hq, kHQ / 2);
  if (e == cudaSuccess && SEG) {
    const cuuint64_t dims[1] = {(cuuint64_t)B * Skv};
    const cuuint64_t no_strides[1] = {0};
    const cuuint32_t box[1] = {kHK};
    e = encode_map(&sm, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, seg_kv, dims,
                   no_strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (e != cudaSuccess) return e;
  auto kernel = flash_attention_fwd_wgmma_kernel<SEG>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kHSmem);
  if (e != cudaSuccess) return e;
  const long long ctas = (long long)((Sq + kHQ - 1) / kHQ) * Hq * B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)ctas, kHThreads, kHSmem, st>>>(
      qm, km, vm, om, sm, lse, seg_q, q_rng, kv_rng, B, Sq, Skv, Hq, Hkv,
      scale * 1.4426950408889634f, causal);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  bfloat16 at D = 128 runs the
// Hopper kernel (q, k, v, out 16-byte aligned), float32 at D = 16 the
// CUDA-core one; any other pair returns cudaErrorInvalidValue.  seg_q (B,
// Sq) and seg_kv (B, Skv): int32 packed-document ids, or both null; query
// i sees key j only where seg_q[b, i] == seg_kv[b, j] (and causally).
// With ids the bfloat16 build also takes q_rng (B, ceil(Sq / 128), 2) and
// kv_rng (B, ceil(Skv / 128), 2): the int32 [min, max] id of each
// 128-token tile (segment_tile_ranges); the float32 build ignores them.
// Returns the launch's error (cudaGetLastError()).
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
  const int* qr = static_cast<const int*>(q_rng);
  const int* kr = static_cast<const int*>(kv_rng);
  if (Hkv < 1 || Hq % Hkv != 0 || (sq == nullptr) != (skv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // segment ids select their own instantiation: the unsegmented one
  // carries no segment test
  cudaError_t e;
  if (dtype == 0 && D == kHD && sq != nullptr)
    e = (qr == nullptr || kr == nullptr)
            ? cudaErrorInvalidValue
            : launch_wgmma<true>(q, k, v, out, l, sq, skv, qr, kr, B, Sq,
                                 Skv, Hq, Hkv, scale, causal, st);
  else if (dtype == 0 && D == kHD)
    e = launch_wgmma<false>(q, k, v, out, l, nullptr, nullptr, nullptr,
                            nullptr, B, Sq, Skv, Hq, Hkv, scale, causal, st);
  else if (dtype == 1 && D == 16 && sq != nullptr)
    e = launch<16, false, float, true>(q, k, v, out, l, B, Sq, Skv, Hq, Hkv,
                                       scale, causal, st, nullptr, nullptr, 0,
                                       0, nullptr, nullptr, sq, skv);
  else if (dtype == 1 && D == 16)
    e = launch<16, false>(q, k, v, out, l, B, Sq, Skv, Hq, Hkv, scale, causal,
                          st);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Paged suffix prefill: q (B, S, Hq, D) at per-row offsets pos (B,)
// int32; k, v one layer's (num_blocks, block_len, Hkv, D) pool; table the
// int32 (B, max_blocks) block table (every entry a valid block id).  Query
// i of row b sees keys j <= pos[b] + i, j < max_blocks * block_len.
// bfloat16 at D = 128 needs block_len % 64 == 0; float32 at D = 16 takes
// any block_len >= 1; other cases return cudaErrorInvalidValue.
extern "C" int flash_attention_fwd_paged(const void* q, const void* k,
                                         const void* v, const void* pos,
                                         const void* table, void* out, int B,
                                         int S, int Hq, int Hkv, int D,
                                         int max_blocks, int block_len,
                                         float scale, int dtype,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(table);
  if (Hkv < 1 || Hq % Hkv != 0 || max_blocks < 1 || block_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0 && D == 128 && block_len % kMmaBK == 0)
    e = launch_mma<128, true>(q, k, v, out, nullptr, B, S, 0, Hq, Hkv, scale,
                              1, st, p, t, max_blocks, block_len);
  else if (dtype == 1 && D == 16)
    e = launch<16, true>(q, k, v, out, nullptr, B, S, 0, Hq, Hkv, scale, 1,
                         st, p, t, max_blocks, block_len);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Paged int8 suffix prefill: as flash_attention_fwd_paged with k, v one
// layer's int8 (num_blocks, block_len, Hkv, D) pool and k_scale, v_scale
// float32 (num_blocks, Hkv).  bfloat16 q at D = 128 needs block_len % 64
// == 0; float32 q at D = 16 takes any block_len >= 1.
extern "C" int flash_attention_fwd_paged_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* pos, const void* table, void* out,
    int B, int S, int Hq, int Hkv, int D, int max_blocks, int block_len,
    float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(table);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (Hkv < 1 || Hq % Hkv != 0 || max_blocks < 1 || block_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0 && D == 128 && block_len % kMmaBK == 0)
    e = launch_mma<128, true, int8_t>(q, k, v, out, nullptr, B, S, 0, Hq,
                                      Hkv, scale, 1, st, p, t, max_blocks,
                                      block_len, ks, vs);
  else if (dtype == 1 && D == 16)
    e = launch<16, true, int8_t>(q, k, v, out, nullptr, B, S, 0, Hq, Hkv,
                                 scale, 1, st, p, t, max_blocks, block_len,
                                 ks, vs);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
