// Flash-attention backward: kernels K5 (dq) and K6 (dk, dv) of
// paddle_tpu_torch.
//
// Replace paddle_tpu/ops/pallas/flash_attention.py _bwd_dq_kernel (:252,
// pallas_call :377) and _bwd_dkv_kernel (:299, pallas_call :407): the
// Flash-2 backward, scores recomputed blockwise from (q, k, v, lse):
//   P  = exp(S * scale - lse)          (0 where masked)
//   dP = dO . V^T,  dS = P o (dP - delta) * scale
//   dq = dS . K,  dk = dS^T . Q,  dv = P^T . dO
// with delta = rowsum(dO o O) - dlse computed by the caller.  Layouts as
// K2's: q, dO, dq (B, Sq, Hq, D); k, v, dk, dv (B, Skv, Hkv, D); lse,
// delta (B, Hq, Sq) float32.  Causal masking is bottom-right aligned
// (query i sees keys j <= i + Skv - Sq), GQA maps q head h to kv head
// h / G, optional int32 segment ids seg_q (B, Sq) / seg_kv (B, Skv) mask
// pairs of different packed documents, ragged Sq / Skv are masked here,
// and tiles wholly above the diagonal are skipped.  A row with every key
// masked gets zero gradient.
//
// Bound on the H100: operations, at training shapes: 14 * D FLOPs a
// visible (query, key) pair (6 D for dq, 8 D for dk / dv) against the
// 989 TFLOP/s bf16 tensor cores.  Design, simple first:
//   * K5: one CTA per (64-query tile, q head, batch row), 4 warps of 16
//     query rows; a warp's Q and dO fragments stay in registers, 64-key
//     K / V tiles stream through shared memory, dq accumulates in float32
//     registers and is rounded once;
//   * K6: one CTA per (64-key tile, KV head, batch row), 4 warps of 16
//     keys; it walks the G q heads of its group and the 64-query tiles at
//     or below the diagonal, so dk and dv of the group are summed in
//     float32 registers and rounded once (the reference writes per-q-head
//     (B, Hq, Skv, D) partials, rounds them and sums the group outside the
//     kernel, :428-440).  It computes S^T = K . Q^T and dP^T = V . dO^T
//     directly, so P^T and dS^T are accumulator fragments that re-pack in
//     registers as the A operand of P^T . dO and dS^T . Q; dO and Q enter
//     those products through ldmatrix.trans.  P and dS are rounded to bf16
//     for the products (the main source of error against the float32
//     plain version).
//   Both at bfloat16, D = 128 on mma.sync.m16n8k16; float32 at D = 16 (the
//   tiny model) runs two CUDA-core kernels of one thread per query row
//   (K5) or key row (K6).  Any other pair is refused.
// wgmma/TMA, a cp.async ring and a persistent schedule are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using ptt::cp_async16_zfill;
using ptt::cp_async_commit_wait_all;
using ptt::ldmatrix_x4_trans;
using ptt::load_a_frag;
using ptt::load_b_frag;
using ptt::mma_bf16;
using ptt::pack_bf16;

constexpr int kTile = 64;   // queries or keys per tile, both kernels

// ---------------------------------------------------------------------------
// float32 on the CUDA cores (the tiny model's D = 16)
// ---------------------------------------------------------------------------
constexpr int kF32Threads = kTile;   // one thread per row of the CTA's tile

// K5 f32: thread = query row; K / V tiles of 64 keys in shared memory.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ seg_q,
                  const int* __restrict__ seg_kv, float* __restrict__ dq,
                  int Sq, int Skv, int Hq, int Hkv, float scale, int causal) {
  __shared__ float Ks[kTile][D], Vs[kTile][D];
  __shared__ int Ss[kTile];
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, q0 = blockIdx.x * kTile, i = q0 + tid;
  const int offset = Skv - Sq;
  const bool live = i < Sq;
  float qr[D], dor[D], acc[D];
  float l = 0.f, dl = 0.f;
  int sq = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = dor[d] = acc[d] = 0.f;
  if (live) {
    const size_t row = (((size_t)b * Sq + i) * Hq + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = q[row + d];
      dor[d] = dout[row + d];
    }
    l = lse[((size_t)b * Hq + h) * Sq + i];
    dl = delta[((size_t)b * Hq + h) * Sq + i];
    if (seg_q != nullptr) sq = seg_q[(size_t)b * Sq + i];
  }
  const int q_last = min(Sq, q0 + kTile) - 1;
  const int kv_hi = causal ? min(Skv, q_last + offset + 1) : Skv;
  for (int kv0 = 0; kv0 < kv_hi; kv0 += kTile) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < kTile * D; idx += kF32Threads) {
      const int c = idx / D, d = idx - c * D, kc = kv0 + c;
      const size_t g = (((size_t)b * Skv + kc) * Hkv + hk) * D + d;
      Ks[c][d] = kc < Skv ? k[g] : 0.f;
      Vs[c][d] = kc < Skv ? v[g] : 0.f;
    }
    if (seg_q != nullptr)
      Ss[tid] = kv0 + tid < Skv ? seg_kv[(size_t)b * Skv + kv0 + tid] : 0;
    __syncthreads();
    if (!live) continue;
    const int jn = min(kTile, kv_hi - kv0);
    for (int j = 0; j < jn; ++j) {
      const int kc = kv0 + j;
      bool keep = !causal || kc <= i + offset;
      if (seg_q != nullptr) keep = keep && Ss[j] == sq;
      if (!keep) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], Ks[j][d], s);
        dp = fmaf(dor[d], Vs[j][d], dp);
      }
      const float p = expf(s * scale - l);
      const float ds = p * (dp - dl) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, Ks[j][d], acc[d]);
    }
  }
  if (live) {
    float* o = dq + (((size_t)b * Sq + i) * Hq + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = acc[d];
  }
}

// K6 f32: thread = key row; it walks the G q heads of its KV head and the
// 64-query tiles that see any of the CTA's keys.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ seg_q,
                   const int* __restrict__ seg_kv, float* __restrict__ dk,
                   float* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv,
                   float scale, int causal) {
  __shared__ float Qs[kTile][D], Os[kTile][D];
  __shared__ float Ls[kTile], Ds[kTile];
  __shared__ int Ss[kTile];
  const int hk = blockIdx.y, b = blockIdx.z, G = Hq / Hkv;
  const int tid = threadIdx.x, kv0 = blockIdx.x * kTile, j = kv0 + tid;
  const int offset = Skv - Sq;
  const bool live = j < Skv;
  float kr[D], vr[D], dka[D], dva[D];
  int sk = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) kr[d] = vr[d] = dka[d] = dva[d] = 0.f;
  if (live) {
    const size_t row = (((size_t)b * Skv + j) * Hkv + hk) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = k[row + d];
      vr[d] = v[row + d];
    }
    if (seg_q != nullptr) sk = seg_kv[(size_t)b * Skv + j];
  }
  // queries i >= key - offset see the key: the first tile that can
  int q_lo = causal ? max(0, kv0 - offset) : 0;
  q_lo -= q_lo % kTile;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    for (int q0 = q_lo; q0 < Sq; q0 += kTile) {
      __syncthreads();   // the previous tile's readers are done
      for (int idx = tid; idx < kTile * D; idx += kF32Threads) {
        const int r = idx / D, d = idx - r * D, qi = q0 + r;
        const size_t g = (((size_t)b * Sq + qi) * Hq + h) * D + d;
        Qs[r][d] = qi < Sq ? q[g] : 0.f;
        Os[r][d] = qi < Sq ? dout[g] : 0.f;
      }
      {
        const int qi = q0 + tid;
        const size_t lr = ((size_t)b * Hq + h) * Sq + qi;
        Ls[tid] = qi < Sq ? lse[lr] : 0.f;
        Ds[tid] = qi < Sq ? delta[lr] : 0.f;
        if (seg_q != nullptr)
          Ss[tid] = qi < Sq ? seg_q[(size_t)b * Sq + qi] : 0;
      }
      __syncthreads();
      if (!live) continue;
      const int in = min(kTile, Sq - q0);
      for (int r = 0; r < in; ++r) {
        bool keep = !causal || j <= q0 + r + offset;
        if (seg_q != nullptr) keep = keep && Ss[r] == sk;
        if (!keep) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(Qs[r][d], kr[d], s);
          dp = fmaf(Os[r][d], vr[d], dp);
        }
        const float p = expf(s * scale - Ls[r]);
        const float ds = p * (dp - Ds[r]) * scale;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dva[d] = fmaf(p, Os[r][d], dva[d]);
          dka[d] = fmaf(ds, Qs[r][d], dka[d]);
        }
      }
    }
  }
  if (live) {
    const size_t row = (((size_t)b * Skv + j) * Hkv + hk) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[row + d] = dka[d];
      dv[row + d] = dva[d];
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bfloat16, D = 128
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;   // 4 warps of 16 rows

template <int D>
constexpr size_t mma_smem_bytes() {   // four [64][D + 8] bf16 tiles
  return (size_t)4 * kTile * (D + 8) * sizeof(__nv_bfloat16);
}

// rows r of a (B, S, H, D) tensor at head h into a [64][D + 8] tile,
// zero-filled past S (16 bytes a copy)
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int b,
                                          int r0, int S, int H, int h,
                                          int tid) {
  constexpr int kPieces = D / 8, kStride = D + 8;
  for (int idx = tid; idx < kTile * kPieces; idx += kMmaThreads) {
    const int r = idx / kPieces, pc = idx - r * kPieces, rr = r0 + r;
    const __nv_bfloat16* g =
        src + (((size_t)b * S + min(rr, S - 1)) * H + h) * D + pc * 8;
    cp_async16_zfill(dst + r * kStride + pc * 8, g, rr < S);
  }
}

// K5 bf16.  Each warp: query rows row0 = q0 + 16 w + g and row1 = row0 + 8
// in the accumulator layout; per 16-key chunk of a tile it computes S and
// dP (2 n-blocks each), forms dS, and adds dS . K (K through ldmatrix.trans).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ seg_q,
                  const int* __restrict__ seg_kv,
                  __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int Hq,
                  int Hkv, float scale, int causal) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int kStride = D + 8, kKSteps = D / 16, kDBlocks = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + kTile * kStride;
  __nv_bfloat16* Ks = Os + kTile * kStride;
  __nv_bfloat16* Vs = Ks + kTile * kStride;
  __shared__ int seg_s[kTile];   // the key tile's segment ids

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv), offset = Skv - Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3, wr = warp * 16;

  load_tile<D>(Qs, q, b, q0, Sq, Hq, h, tid);
  load_tile<D>(Os, dout, b, q0, Sq, Hq, h, tid);
  cp_async_commit_wait_all();
  __syncthreads();
  unsigned qa[kKSteps][4], oa[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    load_a_frag(qa[kk], Qs + (wr + g) * kStride + kk * 16 + 2 * c, kStride);
    load_a_frag(oa[kk], Os + (wr + g) * kStride + kk * 16 + 2 * c, kStride);
  }
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const size_t lrow = ((size_t)b * Hq + h) * Sq;
  const float l0 = row0 < Sq ? lse[lrow + row0] : 0.f;
  const float l1 = row1 < Sq ? lse[lrow + row1] : 0.f;
  const float d0 = row0 < Sq ? delta[lrow + row0] : 0.f;
  const float d1 = row1 < Sq ? delta[lrow + row1] : 0.f;
  const bool segmented = seg_q != nullptr;
  const int sq0 = segmented && row0 < Sq ? seg_q[(size_t)b * Sq + row0] : 0;
  const int sq1 = segmented && row1 < Sq ? seg_q[(size_t)b * Sq + row1] : 0;

  float acc[kDBlocks][4];
#pragma unroll
  for (int db = 0; db < kDBlocks; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.f;

  const int kv_hi = causal ? min(Skv, q0 + kTile + offset) : Skv;
  for (int kv0 = 0; kv0 < kv_hi; kv0 += kTile) {
    __syncthreads();   // every warp is done with the previous tile
    load_tile<D>(Ks, k, b, kv0, Skv, Hkv, hk, tid);
    load_tile<D>(Vs, v, b, kv0, Skv, Hkv, hk, tid);
    if (segmented && tid < kTile)
      seg_s[tid] = kv0 + tid < Skv ? seg_kv[(size_t)b * Skv + kv0 + tid] : 0;
    cp_async_commit_wait_all();
    __syncthreads();

#pragma unroll 1
    for (int j = 0; j < kTile / 16; ++j) {   // 16-key chunks
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int off = (j * 16 + n * 8 + g) * kStride + kk * 16 + 2 * c;
          unsigned b0, b1;
          load_b_frag(b0, b1, Ks + off);
          mma_bf16(s[n], qa[kk], b0, b1);
          load_b_frag(b0, b1, Vs + off);
          mma_bf16(dp[n], oa[kk], b0, b1);
        }
      }
      // P = exp(S scale - lse) where visible, dS = P (dP - delta) scale
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = j * 16 + n * 8 + 2 * c + e, col = kv0 + cl;
          bool k0 = row0 < Sq && col < Skv && (!causal || col <= row0 + offset);
          bool k1 = row1 < Sq && col < Skv && (!causal || col <= row1 + offset);
          if (segmented) {
            k0 = k0 && seg_s[cl] == sq0;
            k1 = k1 && seg_s[cl] == sq1;
          }
          const float p0 = k0 ? expf(s[n][e] * scale - l0) : 0.f;
          const float p1 = k1 ? expf(s[n][2 + e] * scale - l1) : 0.f;
          s[n][e] = p0 * (dp[n][e] - d0) * scale;
          s[n][2 + e] = p1 * (dp[n][2 + e] - d1) * scale;
        }
      }
      const unsigned da[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      const int krow = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dpi = 0; dpi < D / 16; ++dpi) {
        unsigned kb[4];
        ldmatrix_x4_trans(kb, Ks + krow * kStride + dpi * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dpi], da, kb[0], kb[1]);
        mma_bf16(acc[2 * dpi + 1], da, kb[2], kb[3]);
      }
    }
  }

#pragma unroll
  for (int db = 0; db < kDBlocks; ++db) {
    const int d = db * 8 + 2 * c;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + (((size_t)b * Sq + row0) * Hq + h) * D + d) =
          __floats2bfloat162_rn(acc[db][0], acc[db][1]);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + (((size_t)b * Sq + row1) * Hq + h) * D + d) =
          __floats2bfloat162_rn(acc[db][2], acc[db][3]);
  }
}

// K6 bf16.  Each warp: keys key0 = kv0 + 16 w + g and key1 = key0 + 8 as
// the accumulator rows; per 16-query chunk of a Q tile it computes S^T and
// dP^T (2 n-blocks each, K / V as the A operand from shared memory), forms
// P^T and dS^T, and adds P^T . dO and dS^T . Q (dO, Q through
// ldmatrix.trans).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ seg_q,
                   const int* __restrict__ seg_kv,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int Hq,
                   int Hkv, float scale, int causal) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int kStride = D + 8, kKSteps = D / 16, kDBlocks = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile * kStride;
  __nv_bfloat16* Qs = Vs + kTile * kStride;
  __nv_bfloat16* Os = Qs + kTile * kStride;
  __shared__ float lse_s[kTile], dl_s[kTile];   // the query tile's rows
  __shared__ int seg_s[kTile];

  const int kv0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, offset = Skv - Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3, wr = warp * 16;

  load_tile<D>(Ks, k, b, kv0, Skv, Hkv, hk, tid);
  load_tile<D>(Vs, v, b, kv0, Skv, Hkv, hk, tid);
  cp_async_commit_wait_all();
  const int key0 = kv0 + wr + g, key1 = key0 + 8;
  const bool segmented = seg_q != nullptr;
  const int sk0 = segmented && key0 < Skv ? seg_kv[(size_t)b * Skv + key0] : 0;
  const int sk1 = segmented && key1 < Skv ? seg_kv[(size_t)b * Skv + key1] : 0;

  float dka[kDBlocks][4], dva[kDBlocks][4];
#pragma unroll
  for (int db = 0; db < kDBlocks; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[db][e] = dva[db][e] = 0.f;

  // queries i >= key - offset see the key: the first tile that can
  int q_lo = causal ? max(0, kv0 - offset) : 0;
  q_lo -= q_lo % kTile;
#pragma unroll 1
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const size_t lrow = ((size_t)b * Hq + h) * Sq;
#pragma unroll 1
    for (int q0 = q_lo; q0 < Sq; q0 += kTile) {
      __syncthreads();   // every warp is done with the previous tile
      load_tile<D>(Qs, q, b, q0, Sq, Hq, h, tid);
      load_tile<D>(Os, dout, b, q0, Sq, Hq, h, tid);
      if (tid < kTile) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < Sq ? lse[lrow + qi] : 0.f;
        dl_s[tid] = qi < Sq ? delta[lrow + qi] : 0.f;
        if (segmented) seg_s[tid] = qi < Sq ? seg_q[(size_t)b * Sq + qi] : 0;
      }
      cp_async_commit_wait_all();
      __syncthreads();

#pragma unroll 1
      for (int j = 0; j < kTile / 16; ++j) {   // 16-query chunks
        float s[2][4], dp[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          unsigned ka[4], va[4];
          const int aoff = (wr + g) * kStride + kk * 16 + 2 * c;
          load_a_frag(ka, Ks + aoff, kStride);
          load_a_frag(va, Vs + aoff, kStride);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int off = (j * 16 + n * 8 + g) * kStride + kk * 16 + 2 * c;
            unsigned b0, b1;
            load_b_frag(b0, b1, Qs + off);
            mma_bf16(s[n], ka, b0, b1);
            load_b_frag(b0, b1, Os + off);
            mma_bf16(dp[n], va, b0, b1);
          }
        }
        // rows: keys key0 / key1; columns: queries
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = j * 16 + n * 8 + 2 * c + e, qi = q0 + cl;
            bool k0 = qi < Sq && key0 < Skv && (!causal || key0 <= qi + offset);
            bool k1 = qi < Sq && key1 < Skv && (!causal || key1 <= qi + offset);
            if (segmented) {
              k0 = k0 && seg_s[cl] == sk0;
              k1 = k1 && seg_s[cl] == sk1;
            }
            const float lq = lse_s[cl], dq_ = dl_s[cl];
            const float p0 = k0 ? expf(s[n][e] * scale - lq) : 0.f;
            const float p1 = k1 ? expf(s[n][2 + e] * scale - lq) : 0.f;
            s[n][e] = p0;
            s[n][2 + e] = p1;
            dp[n][e] = p0 * (dp[n][e] - dq_) * scale;
            dp[n][2 + e] = p1 * (dp[n][2 + e] - dq_) * scale;
          }
        }
        const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]),
                                pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]),
                                pack_bf16(s[1][2], s[1][3])};
        const unsigned da[4] = {pack_bf16(dp[0][0], dp[0][1]),
                                pack_bf16(dp[0][2], dp[0][3]),
                                pack_bf16(dp[1][0], dp[1][1]),
                                pack_bf16(dp[1][2], dp[1][3])};
        const int qrow = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int dpi = 0; dpi < D / 16; ++dpi) {
          const int off = qrow * kStride + dpi * 16 + (lane >> 4) * 8;
          unsigned fb[4];
          ldmatrix_x4_trans(fb, Os + off);
          mma_bf16(dva[2 * dpi], pa, fb[0], fb[1]);
          mma_bf16(dva[2 * dpi + 1], pa, fb[2], fb[3]);
          ldmatrix_x4_trans(fb, Qs + off);
          mma_bf16(dka[2 * dpi], da, fb[0], fb[1]);
          mma_bf16(dka[2 * dpi + 1], da, fb[2], fb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int db = 0; db < kDBlocks; ++db) {
    const int d = db * 8 + 2 * c;
    if (key0 < Skv) {
      const size_t o = (((size_t)b * Skv + key0) * Hkv + hk) * D + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(dka[db][0], dka[db][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(dva[db][0], dva[db][1]);
    }
    if (key1 < Skv) {
      const size_t o = (((size_t)b * Skv + key1) * Hkv + hk) * D + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(dka[db][2], dka[db][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(dva[db][2], dva[db][3]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  // above 48 KB only after opting in (per device, so on every launch)
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_args(int B, int Sq, int Skv, int Hq, int Hkv, const void* seg_q,
              const void* seg_kv) {
  return B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 ||
         (seg_q == nullptr) != (seg_kv == nullptr);
}

}  // namespace

// K5: dq (B, Sq, Hq, D) in q's dtype.  dtype: 0 = bfloat16 (D = 128,
// tensor cores), 1 = float32 (D = 16, CUDA cores); any other pair, or
// only one of seg_q / seg_kv, returns cudaErrorInvalidValue.  Tensors
// contiguous, bf16 ones 16-byte aligned.  Returns cudaGetLastError().
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* seg_q, const void* seg_kv,
                                      void* dq, int B, int Sq, int Skv,
                                      int Hq, int Hkv, int D, float scale,
                                      int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(B, Sq, Skv, Hq, Hkv, seg_q, seg_kv))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* sq = static_cast<const int*>(seg_q);
  const int* skv = static_cast<const int*>(seg_kv);
  const dim3 grid((Sq + kTile - 1) / kTile, Hq, B);
  if (dtype == 0 && D == 128) {
    constexpr size_t smem = mma_smem_bytes<128>();
    cudaError_t e = allow_smem(bwd_dq_mma_kernel<128>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    bwd_dq_mma_kernel<128><<<grid, kMmaThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), l, dl, sq, skv,
        static_cast<__nv_bfloat16*>(dq), Sq, Skv, Hq, Hkv, scale, causal);
  } else if (dtype == 1 && D == 16) {
    bwd_dq_f32_kernel<16><<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        sq, skv, static_cast<float*>(dq), Sq, Skv, Hq, Hkv, scale, causal);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6: dk, dv (B, Skv, Hkv, D) in k's dtype, each summed over the GQA
// group of its KV head.  Arguments and refusals as K5's.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* seg_q, const void* seg_kv,
                                       void* dk, void* dv, int B, int Sq,
                                       int Skv, int Hq, int Hkv, int D,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(B, Sq, Skv, Hq, Hkv, seg_q, seg_kv))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* sq = static_cast<const int*>(seg_q);
  const int* skv = static_cast<const int*>(seg_kv);
  const dim3 grid((Skv + kTile - 1) / kTile, Hkv, B);
  if (dtype == 0 && D == 128) {
    constexpr size_t smem = mma_smem_bytes<128>();
    cudaError_t e = allow_smem(bwd_dkv_mma_kernel<128>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    bwd_dkv_mma_kernel<128><<<grid, kMmaThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), l, dl, sq, skv,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq,
        Skv, Hq, Hkv, scale, causal);
  } else if (dtype == 1 && D == 16) {
    bwd_dkv_f32_kernel<16><<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        sq, skv, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv,
        Hq, Hkv, scale, causal);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
