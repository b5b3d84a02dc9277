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
// Bound on the H100: max(causal FLOPs / 989 TFLOP/s (float32: 165),
// bytes / 3.35 TB/s), the FLOPs at prefill shapes.  Common to every
// kernel below: K and V stream through shared memory in tiles with an
// online softmax, so the score matrix never reaches device memory, and
// causal tiles wholly above the diagonal are never loaded.  Two bodies (any other dtype / head dim
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
//     (segmented or not) or paged (any block_len, the table looked up per
//     key row; int8 staged as bytes, each key's block scales beside): one
//     body, flash_fwd_tf32_kernel, whose products run on the tensor cores
//     in three TF32 passes (mma_tf32.cuh: each float32 operand split into
//     a TF32 hi and lo, lo hi + hi lo + hi hi on mma.sync m16n8k8; an int8
//     operand is exact in TF32 and takes two).  wgmma takes TF32 only
//     K-major with B from shared memory, where the split's lo half would
//     need a copy of its own; mma.sync keeps both operands in registers,
//     where the split is made.  Bound: operations, 4 D FLOPs a visible
//     pair at a third of the 494.7 TFLOP/s TF32 rate, 165 TFLOP/s (the
//     CUDA cores' 67 is 2.5x slower).  See its notes below.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "sm90.cuh"

namespace {

using ptt::pack16;
using namespace ptt;

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

#ifndef PTT_F16
// ---------------------------------------------------------------------------
// float32: one body for K2, K2-segmented, K2-paged and K2-paged-int8 at
// every D <= 256 with D % 8 == 0, its products in three TF32 passes on
// mma.sync m16n8k8 (mma_tf32.cuh).
//
// A CTA is 8 warps over one q tile of one (batch row, q head); each warp
// owns 16 query rows (lane 4 g + t: rows g and g + 8 of them).  Up to D
// 128 the tile is 128 queries, one row group a warp, and key tiles are 64
// keys; above it 64 queries and key tiles of 32 keys, two warps a row
// group (16 x D float32 accumulators a warp would pass the registers a
// thread has): each forms S over half of the tile's keys, the two
// exchange their row maxima and then P (in C-fragment order) through
// shared memory under a named barrier of the pair, and each owns half of
// O's columns (on the H100 this ran faster at D 136 - 256 than each warp
// forming the whole S, which takes half as many products again).
// Q stays in shared memory for the CTA's walk; K and V tiles come by
// cp.async into a ring of two stages (the next tile's copies in flight
// under this tile's products); paged, each key row's address goes through
// the block table, so any block_len works; an int8 pool is staged as its
// bytes with each key's block scales beside.  Per tile and warp:
//   S = Q K^T: the warp's 16 rows x the tile's keys, summed over D in
//     partials of 32 columns (a long chain on one tensor-core accumulator
//     loses float32 accuracy), then scaled by scale * log2(e) (int8: times
//     each key's K scale; an int8 K is exact in TF32, so two passes, lo hi
//     and hi hi, give its product);
//   the online softmax on the C fragments in exp2 units: a row's max over
//     its quad (lanes 4 g .. 4 g + 3; two warps a group: and the other
//     warp's), O rescaled only where a row's max moved, each lane keeping
//     its own partial row sums (added over the quad, and the pair, once at
//     the end); element masks only on tiles that cross the diagonal or the
//     last key or, with ids, whose ids are not one value;
//   O += P V: the S C fragment is P's A operand under the permuted k order
//     (mma_tf32.cuh; V's B rows are keys 2t and 2t + 1 of each step of
//     8), so up to D 128 P never leaves registers (int8: P times each
//     key's V scale first, after the row sums took it unscaled; V exact in
//     TF32: two passes).  O's n-tiles 2m and 2m + 1 cover columns 16 m ..
//     16 m + 15, lane g's column pair 2g, 2g + 1 of them, so each B
//     fragment pair is one 8-byte load and each lane stores 4 consecutive
//     columns.
// A warp skips a tile in which its rows see no key.  The grid is 1-D,
// the heaviest causal q tiles (the last) of every (row, head) first; with
// segment ids every key tile whose id range misses the q tile's is never
// loaded (q_rng / kv_rng: the [min, max] id of every 64 tokens).  No
// atomics and no split over keys: the same bits on every call.
// ---------------------------------------------------------------------------
constexpr int kFtThreads = 256;     // 8 warps
constexpr int kFtChunk = 4;         // k steps (32 columns of D) an S partial
constexpr int kFtSlack = 1024;      // bytes past the ring that O's columns
                                    // past D may read (never stored)

// Q and K rows (float32: floats; int8 K and V: bytes) are ft_ld(D) = 8
// (mod 32) apart, so each half-warp's 8-byte fragment loads (rows g, at
// columns 2t, 2t + 1) and the int8 2-byte ones hit distinct banks; float32
// V rows are D + 4 apart, so its loads (rows 2t and 2t + 1, columns 2g,
// 2g + 1) do
__host__ __device__ constexpr int ft_ld(int D) {
  return D + ((8 - D) % 32 + 32) % 32;
}
__host__ __device__ constexpr int ft_vld(int D, bool int8) {
  return int8 ? ft_ld(D) : D + 4;
}

// the bytes of one ring stage: NK key rows of K and of V, the int8 scales
// of each key (K, V), with ids each key's id
__host__ __device__ constexpr int ft_stage(int NK, int D, bool int8,
                                           bool seg) {
  return NK * ((int8 ? 1 : 4) * (ft_ld(D) + ft_vld(D, int8)) +
               (int8 ? 8 : 0) + (seg ? 4 : 0));
}

// a CTA's dynamic shared memory: the q tile, two warps a row group the
// exchange of P (RG x NT x 32 float4) and of the row maxima (RG x 2 x 16
// floats), two stages, the slack
__host__ __device__ constexpr int ft_smem(int BQ, int NK, int D, bool int8,
                                          bool seg) {
  return 4 * BQ * ft_ld(D) +
         (BQ < 128 ? (BQ / 16) * ((NK / 8) * 32 * 16 + 2 * 16 * 4) : 0) +
         2 * ft_stage(NK, D, int8, seg) + kFtSlack;
}
static_assert(ft_smem(128, 64, 128, false, true) <= 232448 &&
                  ft_smem(64, 32, 256, false, true) <= 232448,
              "every float32 build fits the 227 KB a block may take");

// the bytes that O's column tiles (cols of them a row group) read past a
// stage's last V row at head dim D: into its scales or ids, the other
// stage and the slack; fewest at the largest D an instance serves
__host__ __device__ constexpr int ft_overread(int cols, int D, bool int8) {
  return (int8 ? 1 : 4) * (cols - ft_vld(D, int8));
}

// the kernel's arguments, passed by value
struct FtArgs {
  const float* q;           // (B, Sq, Hq, D)
  const void* k;            // (B, Skv, Hkv, D), or the paged pool
  const void* v;            //   (num_blocks, block_len, Hkv, D): float / int8
  float* out;               // q's layout
  float* lse;               // contiguous: (B, Hq, Sq)
  const int* seg_q;         // SEG: (B, Sq)
  const int* seg_kv;        // SEG: (B, Skv)
  const int* q_rng;         // SEG: (B, ceil(Sq / 64), 2)
  const int* kv_rng;        // SEG: (B, ceil(Skv / 64), 2)
  const int* pos;           // paged: (B,)
  const int* table;         // paged: (B, max_blocks)
  const float* k_scale;     // int8: (num_blocks, Hkv)
  const float* v_scale;
  int B, Sq, Skv, Hq, Hkv, D, max_blocks, block_len, causal;
  float scale_log2;         // scale * log2(e)
};

// two int8 values (the low bytes of w) as floats, exactly: (2^23 + (x ^
// 0x80)) - (2^23 + 128), the byte placed in a float's mantissa
__device__ __forceinline__ float2 ft_int8x2(uint32_t w) {
  const uint32_t x = w ^ 0x8080u;
  return make_float2(
      __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540)) - 8388736.f,
      __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7541)) - 8388736.f);
}

// d += a b with b exact in TF32 (an int8 value): lo_a b, then hi_a b
__device__ __forceinline__ void mma_2xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           float b0, float b1) {
  mma_tf32(d, alo, __float_as_uint(b0), __float_as_uint(b1));
  mma_tf32(d, ahi, __float_as_uint(b0), __float_as_uint(b1));
}

// RG row groups of 16 queries (BQ = 16 RG: 8 up to D 128, 4 above, where
// the two warps of a group split S's keys and O's columns), key tiles of
// NT x 8 keys, CS n-tiles of O's columns a warp (chosen by the launcher:
// the products' loops carry no guard; columns past D are formed from
// whatever lies past the V rows and never stored)
template <int RG, int NT, int CS, bool SEG, bool PAGED, bool INT8>
__global__ void __launch_bounds__(kFtThreads, 1)
flash_fwd_tf32_kernel(const FtArgs a) {
  constexpr int WPR = 8 / RG;          // warps a row group
  constexpr int BQ = 16 * RG;          // queries a CTA
  constexpr int NK = 8 * NT;           // keys a tile
  constexpr int NS = NT / WPR;         // S's n-tiles a warp forms
  static_assert(CS % 2 == 0, "O's n-tiles come in pairs");
  static_assert(!SEG || !PAGED, "segment ids are contiguous only");
  static_assert(!INT8 || PAGED, "the int8 cache is paged only");
  extern __shared__ __align__(16) unsigned char ftsm[];
  const int D = a.D, nk = D / 8, ld = ft_ld(D), vld = ft_vld(D, INT8);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / WPR, wi = warp % WPR, j0 = wi * NS;
  // the CTA: the heaviest (last) q tiles of every (row, head) first
  const int hb = a.Hq * a.B;
  const int qt = (a.Sq + BQ - 1) / BQ - 1 - (int)(blockIdx.x / hb);
  const int h = blockIdx.x % a.Hq, b = (blockIdx.x / a.Hq) % a.B;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  // keys j < kv_len exist; query i sees j <= i + off when causal
  int off = a.Skv - a.Sq, kv_len = a.Skv;
  if (PAGED) {
    off = __ldg(a.pos + b);
    kv_len = min(off + a.Sq, a.max_blocks * a.block_len);
  }
  const int q_last = min(a.Sq, q0 + BQ) - 1;
  const int kv_hi = a.causal ? min(kv_len, q_last + off + 1) : kv_len;
  const int n_kt = kv_hi > 0 ? (kv_hi + NK - 1) / NK : 0;
  // the warp's rows r_lo .. r_lo + 15; the lane's rA and rA + 8
  const int r_lo = q0 + rg * 16, rA = r_lo + g;
  const int r_top = min(a.Sq - 1, r_lo + 15);
  const int nqr = (a.Sq + kIdRange - 1) / kIdRange;
  const int nkr = (a.Skv + kIdRange - 1) / kIdRange;
  int2 cr = make_int2(0, 0), wr = make_int2(0, 0);
  int idr[2] = {0, 0};
  if (SEG) {
    cr = id_range(a.q_rng, b, nqr, q0, q_last);
    if (r_lo < a.Sq) wr = id_range(a.q_rng, b, nqr, r_lo, r_top);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rA + 8 * i < a.Sq)
        idr[i] = __ldg(a.seg_q + (size_t)b * a.Sq + rA + 8 * i);
  }
  auto key_range = [&](int u) {
    return id_range(a.kv_rng, b, nkr, u * NK, min(a.Skv, u * NK + NK) - 1);
  };
  auto next_live = [&](int u) {
    if (SEG)
      while (u < n_kt) {
        const int2 kr = key_range(u);
        if (kr.y >= cr.x && kr.x <= cr.y) break;
        ++u;
      }
    return u;
  };

  float* Qs = reinterpret_cast<float*>(ftsm);            // [BQ][ld]
  // two warps a row group: their P fragments [RG][NT][32] and row maxima
  // (at the end, row sums) [RG][2][16]
  float4* xp = reinterpret_cast<float4*>(ftsm + 4 * BQ * ld);
  float* xm = reinterpret_cast<float*>(xp + (WPR == 2 ? RG * NT * 32 : 0));
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      xm + (WPR == 2 ? RG * 2 * 16 : 0));
  constexpr int ESZ = INT8 ? 1 : 4;
  // a stage: K [NK][ld], V [NK][vld], then int8 the scales [2][NK] or,
  // with ids, the keys' ids [NK]
  const int kv_bytes = NK * ESZ * ld, vt_end = NK * ESZ * (ld + vld);
  const int stage = ft_stage(NK, D, INT8, SEG);
  auto stage_tile = [&](int u, int slot) {
    unsigned char* st = ring + slot * stage;
    constexpr int TPR = kFtThreads / NK;   // threads a key row
    const int r = tid / TPR, sub = tid % TPR, kc = u * NK + r;
    const bool in = kc < kv_len;
    size_t row;
    int blk = 0;
    if (PAGED) {
      blk = in ? __ldg(a.table + (size_t)b * a.max_blocks + kc / a.block_len)
               : 0;
      row = (size_t)blk * a.block_len + (in ? kc % a.block_len : 0);
    } else {
      row = (size_t)b * a.Skv + (in ? kc : 0);
    }
    const size_t base = (row * a.Hkv + hk) * D;
    unsigned char* kd = st + r * ESZ * ld;
    unsigned char* vd = st + kv_bytes + r * ESZ * vld;
    if (INT8) {
      const int8_t* k8 = static_cast<const int8_t*>(a.k) + base;
      const int8_t* v8 = static_cast<const int8_t*>(a.v) + base;
      for (int c = sub; c < D / 8; c += TPR) {
        cp_async8(kd + 8 * c, k8 + 8 * c, in ? 8 : 0);
        cp_async8(vd + 8 * c, v8 + 8 * c, in ? 8 : 0);
      }
      if (sub == 0) {
        float* sc = reinterpret_cast<float*>(st + vt_end);
        const size_t si = (size_t)blk * a.Hkv + hk;
        cp_async4(sc + r, a.k_scale + si, in ? 4 : 0);
        cp_async4(sc + NK + r, a.v_scale + si, in ? 4 : 0);
      }
    } else {
      const float* kf = static_cast<const float*>(a.k) + base;
      const float* vf = static_cast<const float*>(a.v) + base;
      for (int c = sub; c < D / 4; c += TPR) {
        cp_async16(kd + 16 * c, kf + 4 * c, in ? 16 : 0);
        cp_async16(vd + 16 * c, vf + 4 * c, in ? 16 : 0);
      }
    }
    if (SEG && sub == 0)
      cp_async4(st + vt_end + 4 * r, a.seg_kv + row, in ? 4 : 0);
  };

  float o[CS][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < CS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int cur = next_live(0);
  if (cur < n_kt) {
    constexpr int TPQ = kFtThreads / BQ;   // threads a q row
    const int r = tid / TPQ, sub = tid % TPQ, qr = q0 + r;
    const bool in = qr < a.Sq;
    const float* src =
        a.q + (((size_t)b * a.Sq + (in ? qr : 0)) * a.Hq + h) * D;
    for (int c = sub; c < D / 4; c += TPQ)
      cp_async16(Qs + r * ld + 4 * c, src + 4 * c, in ? 16 : 0);
    stage_tile(cur, 0);
  }
  cp_async_commit();
  const int colbase = wi * CS * 8;   // the warp's first column of O
  int slot = 0;
  while (cur < n_kt) {
    const int nxt = next_live(cur + 1);
    cp_async_wait<0>();
    __syncthreads();   // tile cur is in; every warp is done with the other
    if (nxt < n_kt) stage_tile(nxt, slot ^ 1);
    cp_async_commit();
    const unsigned char* st = ring + slot * stage;
    const int u = cur, k0 = u * NK;
    cur = nxt;
    slot ^= 1;
    // does any row of the warp see a key of the tile, and does it need the
    // element mask
    bool any = r_lo < a.Sq && (!a.causal || k0 <= r_top + off);
    bool masked =
        k0 + NK > kv_len || (a.causal && k0 + NK - 1 > r_lo + off);
    if (SEG) {
      const int2 kr = key_range(u);
      any = any && kr.y >= wr.x && kr.x <= wr.y;
      masked = masked || !(wr.x == wr.y && kr.x == kr.y && wr.x == kr.x);
    }
    if (!any) continue;

    // ---- S = Q K^T over the warp's NS n-tiles of the tile (its half of
    // the keys with two warps a row group), in partials of kFtChunk k steps
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      const float* qw = Qs + (rg * 16 + g) * ld + 2 * t;
      const unsigned char* kw = st + ((8 * j0 + g) * ld + 2 * t) * ESZ;
      auto step = [&](float (&ts)[NS][4], int kk) {
        const float2 qa = *reinterpret_cast<const float2*>(qw + 8 * kk);
        const float2 qb =
            *reinterpret_cast<const float2*>(qw + 8 * ld + 8 * kk);
        uint32_t ah[4], al[4];
        split_tf32(qa.x, ah[0], al[0]);
        split_tf32(qb.x, ah[1], al[1]);
        split_tf32(qa.y, ah[2], al[2]);
        split_tf32(qb.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const unsigned char* kp = kw + (j * 8 * ld + 8 * kk) * ESZ;
          if (INT8) {
            const float2 kb = ft_int8x2(
                *reinterpret_cast<const unsigned short*>(kp));
            mma_2xtf32(ts[j], ah, al, kb.x, kb.y);
          } else {
            const float2 kb = *reinterpret_cast<const float2*>(kp);
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(kb.x, bh0, bl0);
            split_tf32(kb.y, bh1, bl1);
            mma_3xtf32(ts[j], ah, al, bh0, bh1, bl0, bl1);
          }
        }
      };
      for (int c0 = 0; c0 < nk; c0 += kFtChunk) {
        float ts[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ts[j][e] = 0.f;
        if (c0 + kFtChunk <= nk) {
#pragma unroll
          for (int kk = c0; kk < c0 + kFtChunk; ++kk) step(ts, kk);
        } else {
          for (int kk = c0; kk < nk; ++kk) step(ts, kk);
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += ts[j][e];
      }
    }
    // ---- scale (int8: times each key's K scale), mask; the lane's keys
    // of local n-tile j: k0 + 8 (j0 + j) + 2t + {0, 1}
    const float* ksc = reinterpret_cast<const float*>(st + vt_end);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float c0 = a.scale_log2, c1 = a.scale_log2;
      if (INT8) {
        const float2 kq =
            *reinterpret_cast<const float2*>(ksc + 8 * (j0 + j) + 2 * t);
        c0 *= kq.x;
        c1 *= kq.y;
      }
      s[j][0] *= c0;
      s[j][1] *= c1;
      s[j][2] *= c0;
      s[j][3] *= c1;
    }
    if (masked) {
      const int* ids = reinterpret_cast<const int*>(st + vt_end);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        int2 idk = make_int2(0, 0);
        if (SEG)
          idk = *reinterpret_cast<const int2*>(ids + 8 * (j0 + j) + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rA + 8 * (e >> 1);
          const int key = k0 + 8 * (j0 + j) + 2 * t + (e & 1);
          bool vis = key < kv_len && (!a.causal || key <= row + off);
          if (SEG) vis = vis && idr[e >> 1] == ((e & 1) ? idk.y : idk.x);
          if (!vis) s[j][e] = -INFINITY;
        }
      }
    }
    // ---- the online softmax in exp2 units (two warps a row group: the
    // row maxima of both halves through shared memory)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if (WPR == 2) {
      if (t == 0) {
        xm[(rg * 2 + wi) * 16 + g] = mx[0];
        xm[(rg * 2 + wi) * 16 + g + 8] = mx[1];
      }
      named_barrier(1 + rg, 64);
      mx[0] = fmaxf(mx[0], xm[(rg * 2 + 1 - wi) * 16 + g]);
      mx[1] = fmaxf(mx[1], xm[(rg * 2 + 1 - wi) * 16 + g + 8]);
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], mx[i]);
      mu[i] = mn == -INFINITY ? 0.f : mn;   // a row that sees no key yet
      alpha[i] = exp2f(m[i] - mu[i]);
      m[i] = mn;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mu[e >> 1]);
        ps[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ps[i];
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < CS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    }
    // P (int8: times each key's V scale, after the row sums took it
    // unscaled); two warps a row group: each writes its C fragments and
    // reads the group's
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (INT8) {
        const float2 vq = *reinterpret_cast<const float2*>(
            ksc + NK + 8 * (j0 + j) + 2 * t);
        s[j][0] *= vq.x;
        s[j][1] *= vq.y;
        s[j][2] *= vq.x;
        s[j][3] *= vq.y;
      }
      if (WPR == 2)
        xp[(rg * NT + j0 + j) * 32 + lane] =
            make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    }
    if (WPR == 2) named_barrier(1 + rg, 64);
    // ---- O += P V: P's C fragment as the A operand (k t <- key 2t, k t +
    // 4 <- key 2t + 1 of each step of 8), V's B rows 2t and 2t + 1
    const unsigned char* vw =
        st + kv_bytes + (2 * t * vld + colbase + 2 * g) * ESZ;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float4 c;
      if (WPR == 2)
        c = xp[(rg * NT + j) * 32 + lane];
      else
        c = make_float4(s[j % NS][0], s[j % NS][1], s[j % NS][2],
                        s[j % NS][3]);
      uint32_t ah[4], al[4];
      split_tf32(c.x, ah[0], al[0]);
      split_tf32(c.z, ah[1], al[1]);
      split_tf32(c.y, ah[2], al[2]);
      split_tf32(c.w, ah[3], al[3]);
      const unsigned char* vr = vw + 8 * j * vld * ESZ;
#pragma unroll
      for (int mm = 0; mm < CS / 2; ++mm) {
        if (INT8) {
          const float2 v0 = ft_int8x2(
              *reinterpret_cast<const unsigned short*>(vr + 16 * mm));
          const float2 v1 = ft_int8x2(
              *reinterpret_cast<const unsigned short*>(vr + vld + 16 * mm));
          mma_2xtf32(o[2 * mm], ah, al, v0.x, v1.x);
          mma_2xtf32(o[2 * mm + 1], ah, al, v0.y, v1.y);
        } else {
          const float2 v0 =
              *reinterpret_cast<const float2*>(vr + 4 * 16 * mm);
          const float2 v1 =
              *reinterpret_cast<const float2*>(vr + 4 * (vld + 16 * mm));
          uint32_t h0, l0, h1, l1;
          split_tf32(v0.x, h0, l0);
          split_tf32(v1.x, h1, l1);
          mma_3xtf32(o[2 * mm], ah, al, h0, h1, l0, l1);
          split_tf32(v0.y, h0, l0);
          split_tf32(v1.y, h1, l1);
          mma_3xtf32(o[2 * mm + 1], ah, al, h0, h1, l0, l1);
        }
      }
    }
  }

  // ---- out (and lse): every row the CTA owns; a row that saw no key
  // gives 0 and lse -1e30.  Each lane's partial row sums added over its
  // quad (and, two warps a row group, the two warps' sums)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (WPR == 2) {
    if (t == 0) {
      xm[(rg * 2 + wi) * 16 + g] = l[0];
      xm[(rg * 2 + wi) * 16 + g + 8] = l[1];
    }
    named_barrier(1 + rg, 64);
    l[0] += xm[(rg * 2 + 1 - wi) * 16 + g];
    l[1] += xm[(rg * 2 + 1 - wi) * 16 + g + 8];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rA + 8 * i;
    if (row >= a.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = a.out + (((size_t)b * a.Sq + row) * a.Hq + h) * D;
#pragma unroll
    for (int mm = 0; mm < CS / 2; ++mm) {
      const int col = colbase + 16 * mm + 4 * t;
      if (col < D)
        *reinterpret_cast<float4*>(orow + col) = make_float4(
            o[2 * mm][2 * i] * inv, o[2 * mm + 1][2 * i] * inv,
            o[2 * mm][2 * i + 1] * inv, o[2 * mm + 1][2 * i + 1] * inv);
    }
    if (!PAGED && wi == 0 && t == 0)
      a.lse[((size_t)b * a.Hq + h) * a.Sq + row] =
          l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : kNegInf;
  }
}

// DMIN: the least head dim the instance serves
template <int RG, int NT, int CS, int DMIN, bool SEG, bool PAGED, bool INT8>
cudaError_t ft_launch(const FtArgs& a, cudaStream_t st) {
  constexpr int BQ = 16 * RG;
  static_assert(ft_overread(8 * CS * (8 / RG), DMIN, INT8) <= kFtSlack,
                "O's columns past D stay inside the dynamic shared memory");
  const int smem = ft_smem(BQ, 8 * NT, a.D, INT8, SEG);
  const auto kernel = flash_fwd_tf32_kernel<RG, NT, CS, SEG, PAGED, INT8>;
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long ctas = (long long)((a.Sq + BQ - 1) / BQ) * a.Hq * a.B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (ctas > 0) kernel<<<(unsigned)ctas, kFtThreads, smem, st>>>(a);
  return cudaSuccess;
}

// the float32 body at any D <= 256 with D % 8 == 0: up to D 128 128
// queries a CTA and 64-key tiles, a warp all of O's columns (CS the least
// instance that covers D / 8); above, 64 queries, 32-key tiles, a warp
// half of them
template <bool SEG, bool PAGED, bool INT8>
cudaError_t launch_tf32(const FtArgs& a, cudaStream_t st) {
  const int D = a.D;
  if (D < 8 || D > 256 || D % 8 != 0) return cudaErrorInvalidValue;
  if (D > 192) return ft_launch<4, 4, 16, 200, SEG, PAGED, INT8>(a, st);
  if (D > 128) return ft_launch<4, 4, 12, 136, SEG, PAGED, INT8>(a, st);
  if (D > 96) return ft_launch<8, 8, 16, 104, SEG, PAGED, INT8>(a, st);
  if (D > 64) return ft_launch<8, 8, 12, 72, SEG, PAGED, INT8>(a, st);
  if (D > 16) return ft_launch<8, 8, 8, 24, SEG, PAGED, INT8>(a, st);
  return ft_launch<8, 8, 2, 8, SEG, PAGED, INT8>(a, st);
}
#endif

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
  a.scale_log2 = scale * kLog2e;
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
// the float32 body's arguments (the rest zero)
static FtArgs f32_args(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                       int D, float scale, int causal) {
  FtArgs a = {};
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
  a.causal = causal;
  a.scale_log2 = scale * kLog2e;
  return a;
}
#endif

// dtype: 0 = bfloat16, 1 = float32, 2 = float16.  The library's 16-bit
// type (bfloat16; float16 alone in the library compiled with -DPTT_F16) at
// any D <= 256 with D % 8 == 0 runs the Hopper kernel (q, k, v, out
// 16-byte aligned), float32 at the same head dims (the default library)
// the 3xTF32 one; any other pair returns cudaErrorInvalidValue.  seg_q (B,
// Sq) and seg_kv (B, Skv): int32 packed-document ids, or both null; query
// i sees key j only where seg_q[b, i] == seg_kv[b, j] (and causally).
// With ids every build also takes q_rng and kv_rng, the int32 [min, max]
// id of each tile of tokens (segment_tile_ranges): the 16-bit build's of
// 128 tokens, (B, ceil(Sq / 128), 2) and (B, ceil(Skv / 128), 2), the
// float32 build's of 64.  Returns the launch's error (cudaGetLastError()).
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
  else if (dtype == 1 && sq != nullptr) {
    FtArgs f = f32_args(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, scale, causal);
    f.lse = l;
    f.seg_q = sq;
    f.seg_kv = skv;
    f.q_rng = a.q_rng;
    f.kv_rng = a.kv_rng;
    e = (f.q_rng == nullptr || f.kv_rng == nullptr)
            ? cudaErrorInvalidValue
            : launch_tf32<true, false, false>(f, st);
  } else if (dtype == 1) {
    FtArgs f = f32_args(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, scale, causal);
    f.lse = l;
    e = launch_tf32<false, false, false>(f, st);
  }
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
  else if (dtype == 1) {
    FtArgs f = f32_args(q, k, v, out, B, S, 0, Hq, Hkv, D, scale, 1);
    f.pos = static_cast<const int*>(pos);
    f.table = static_cast<const int*>(table);
    f.max_blocks = max_blocks;
    f.block_len = block_len;
    e = launch_tf32<false, true, false>(f, st);
  }
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
  if (Hkv < 1 || Hq % Hkv != 0 || max_blocks < 1 || block_len < 1 ||
      num_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == kE16Code && block_len % kHBox == 0) {
    HopperArgs a = paged_args(pos, table, B, S, Hq, Hkv, max_blocks,
                              block_len);
    a.k_scale = static_cast<const float*>(k_scale);
    a.v_scale = static_cast<const float*>(v_scale);
    e = launch_wgmma<false, true, true>(q, k, v, out, nullptr, a, num_blocks,
                                        scale, st, D);
#ifndef PTT_F16
  } else if (dtype == 1) {
    FtArgs f = f32_args(q, k, v, out, B, S, 0, Hq, Hkv, D, scale, 1);
    f.pos = static_cast<const int*>(pos);
    f.table = static_cast<const int*>(table);
    f.k_scale = static_cast<const float*>(k_scale);
    f.v_scale = static_cast<const float*>(v_scale);
    f.max_blocks = max_blocks;
    f.block_len = block_len;
    e = launch_tf32<false, true, true>(f, st);
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
