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
// masked gets zero gradient (P = 0 on every masked pair).  dk and dv are
// summed over the G q heads of each GQA group in float32 registers and
// rounded once (the reference writes per-q-head (B, Hq, Skv, D) partials,
// rounds them and sums the group outside the kernel, :428-440).  Two
// kernels and no atomics, as the reference's two pallas_calls: every
// gradient is the same from run to run.
//
// Bound on the H100: operations, at training shapes: 14 * D FLOPs a
// visible (query, key) pair (6 D for dq, 8 D for dk / dv) against the
// 989 TFLOP/s bf16 tensor cores; with packed documents few pairs are
// visible and the bytes bind.  Bodies at K2's head dims (any other pair is
// refused):
//   * bfloat16 at any D <= 128 with D % 8 == 0 (every training backward
//     at 128, the DiT blocks at 72): Hopper kernels of 384 threads, two
//     consumer warpgroups of 64 rows and a producer warp (setmaxnreg 240 /
//     24), in the shape of K2's:
//       - K5 (bwd_dq_wgmma_kernel): a CTA owns 128 queries of one q head;
//         Q and dO come once by TMA; 64-key K / V tiles stream by TMA into
//         a 3-stage mbarrier ring.  A consumer computes S = Q K^T and
//         dP = dO V^T on wgmma m64n64k16 (both operands from shared
//         memory, K-major), P = exp2(S scale log2e - lse log2e) and dS in
//         registers (lse and delta of its two rows held in registers),
//         and dq += dS K on m64n128k16 with dS as the register A operand
//         and K read MN-major (the transpose flag); that product stays in
//         flight under the next tile's S and dP, and a stage is released
//         once it is done.  dq is rounded once and leaves through Q's
//         shared memory by a TMA store.
//       - K6 (bwd_dkv_wgmma_kernel): a CTA owns 128 keys of one KV head;
//         K and V come once; the producer walks the G q heads of the group
//         x the 64-query tiles at or below the diagonal, streaming Q, dO
//         (4-d maps) and the tile's lse, delta and, with ids, query ids
//         (1-d maps) into the ring.  A consumer computes S^T = K Q^T and
//         dP^T = V dO^T (m64n64k16), forms P^T while dP^T is in flight,
//         issues dV += P^T dO (P^T as the register A operand, dO MN-major),
//         forms dS^T under it and issues dK += dS^T Q.  dk and dv (64 + 64
//         float32 registers a thread) leave through K's and V's shared
//         memory by TMA stores.
//     Both apply the element mask only on the tiles the producer flags
//     (across the causal diagonal, the ragged end, or, with ids, a tile
//     pair whose ids are not all one value), and with ids skip every tile
//     pair whose [min, max] id ranges miss (q_rng / kv_rng: 64-token
//     ranges from segment_tile_ranges on the host; the 128-token tile of a
//     CTA takes the union of its two).  P and dS are rounded to bf16 for
//     the products (the main source of error against the float32 plain
//     version).  K5 starts the heaviest (last) q tiles first, K6 the
//     heaviest (first) key tiles.
//     Below D = 128 the same bodies run on 128-wide tiles: the tensor maps
//     have D columns (bshd_map), so TMA fills columns D..127 of every Q,
//     K, V and dO tile with zeros (the box at d 64 wholly so at D <= 64)
//     and still counts each box's full bytes on its mbarrier.  S and dP
//     sum zero products over the pad; dq = dS K, dk = dS^T Q and dv = P^T
//     dO are zero in the pad columns, since K, Q and dO are; the stores'
//     maps of D columns drop them.  The products do 128 / D times the
//     useful work (1.78x at D = 72).
//   * bfloat16 at 128 < D <= 256 with D % 8 == 0 (a Gemma-2B-wide Llama's
//     256): the same walks on 256-wide tiles (4 boxes of 64 columns, zeros
//     past D as above: 1.88x the useful work at D = 136), narrowed to fit
//     the 227 KB of shared memory and 240 registers a consumer thread, as
//     the reference narrows its blocks by D / 128 (:56-70):
//       - K5 (bwd_dq_wgmma_wide_kernel): a CTA still owns 128 queries (Q
//         and dO resident, 128 KB); K / V stream in 32-key tiles through a
//         3-stage ring (3 x 32 KB; 231,248 bytes in all).  S and dP are
//         m64n32k16 x 16 k steps, dq += dS K m64n256k16 x 2 with dq a 64 x
//         256 float32 accumulator (128 registers a thread), left in flight
//         under the next tile's S and dP as at D <= 128.
//       - K6 (bwd_dkv_wgmma_wide_kernel): a CTA owns 64 keys (K and V
//         resident, 64 KB); Q / dO stream in 64-query tiles through a
//         2-stage ring (199,992 bytes in all).  A 64 x 256 float32 dk and dv
//         would be 256 registers a thread, so the consumer warpgroups split
//         them: warpgroup 0 computes S^T = K Q^T, P^T and dV += P^T dO;
//         warpgroup 1 S^T, dP^T = V dO^T, dS^T and dK += dS^T Q (S^T is
//         computed twice: 5 products a tile pair for 4).  Each retires its
//         dV / dK product before the next tile; with ids the dK warpgroup
//         issues dP^T only once P^T is formed (the ids' mask beside S^T,
//         dP^T in flight and dK spilled 104 bytes).  The grid is B x Hkv
//         x Skv / 64: 64 CTAs for one KV head at B 2 x 2048, the first
//         walking every query tile of the causal triangle, the last one.
//   * float16 at the same head dims: the bfloat16 bodies above compiled
//     again with -DPTT_F16 into a library of its own (mma_bf16.cuh: the
//     element type, the wgmma operand type, TMA's element type), which
//     takes dtype code 2 only.  P <= 1 is rounded to float16 as to bf16.
//     dS is not bounded: dS = P o (dP - delta) * scale is linear in dO,
//     which a loss scale multiplies (2^15 by default), and float16 ends at
//     65504 where bf16 has float32's range; rounded as it is, a dS entry
//     past 65504 would be inf where the reference, which keeps dS in
//     float32, gives finite dq / dk (and a GradScaler would skip a step
//     the reference takes).  So each row of dS (a query's in K5, a key's
//     in K6) is formed and rounded in a unit of its own, 2^-k: the row's
//     first tile with a nonzero dS sets k so that its largest |dS| lies
//     in [2^14, 2^15), and a later tile whose largest reaches 2^15 lowers
//     it, the row's float32 dq (K5) or dk (K6) accumulator multiplied by
//     the change of unit first (ds_fit; the warp votes, so the common
//     tile pays a row maximum and no more: the unit is folded into the
//     scale the tile's dS is formed with).  dq = dS K and dk = dS^T Q are
//     linear in the row, so the accumulator holds the row's sum in units
//     of 2^-k and is multiplied by 2^k once, after the last product
//     (ds_units_out), before its rounding to float16.  Every factor is a
//     power of two: exact in float32, and the float16 rounding of 2^k dS
//     has the relative error of a float16 rounding of dS in its normal
//     range, which the row fills from the top (entries 2^-28 of the row's
//     largest still round as normals: the reference's float32 dS is met
//     at float16's 2^-11 rather than flushed), whatever the loss scale.
//     k stays in [-64, 64].  K5 retires each tile's dq += dS K before the
//     next tile's products (ptxas serialises every wgmma of the kernel
//     when ds_fit reads an accumulator whose product is in flight across
//     the loop's back edge); K6 retires its products every tile already.
//     K6 on 256-wide tiles keeps its dK warpgroup's units in shared
//     memory (in registers they spilled 4 bytes with ids).
//   * float32 at any D <= 256 with D % 8 == 0, on the CUDA cores (wgmma
//     has no float32 input that keeps float32 numerics):
//       - D = 16 (the tiny model), 64 and 72 (float32 DiTs): two kernels
//         of one thread per query row (K5) or key row (K6).  A thread's
//         rows are D-float register arrays (3 D in K5, 4 D in K6), so the
//         wider instances keep part of them in local memory.
//       - D = 128 (the reference's float32 default configurations:
//         LlamaConfig(), Qwen2-VL's decoder and cross layers): the same
//         two walks with each row split over a quad of threads (D / 4
//         columns a thread, dot products summed by two shuffles) and the
//         tiles in dynamic shared memory (bwd_dq_f32_split_kernel /
//         bwd_dkv_f32_split_kernel, below), so nothing spills.
//       - every other D (a Gemma-2B-wide Llama's 256 among them): that
//         split body at a runtime D
//         (bwd_dq_f32_rt_kernel / bwd_dkv_f32_rt_kernel), a quad a row up
//         to D 128 and an octet (D / 8 columns a thread, three shuffles,
//         32 rows a CTA) above, so that a thread holds at most 8 float4
//         chunks of a row.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace ptt;

constexpr int kTile = 64;   // queries or keys per tile, both kernels

// ---------------------------------------------------------------------------
// float32 on the CUDA cores (the tiny model's D = 16, float32 DiTs' 64 / 72)
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
// float32 at D = 128 (the reference's float32 default configurations): a
// row split across a quad of threads
// ---------------------------------------------------------------------------
// One thread a row would hold 3 D (K5) or 4 D (K6) floats of it in
// registers, 384 / 512 at D = 128, and stage two 64 x D tiles in static
// shared memory, 64 KB, past the 48 KB limit.  Here the 4 threads of a
// quad (lanes 4r..4r+3 of a warp) share row r: thread g of the quad owns
// the float4 chunks c = g + 4 e (e < D / 16) of every D-float row it
// touches -- columns [4c, 4c + 4) -- so each chunk has exactly one owner
// and the quad's chunks at step e are 16 contiguous floats (one broadcast
// 64-byte shared-memory read for the 8 quads of a warp, all on one key or
// query row).  A thread's partial dot products over its D / 4 columns are
// summed over the quad by two xor shuffles (1, then 2), whose sums are the
// same bits on all four threads, so p and dS -- and the row's masks --
// agree within the quad.  The tiles live in dynamic shared memory (2 x 64
// x D floats, 64 KB at D = 128, opted in past 48 KB).  Registers: 3 x D /
// 4 (K5) or 4 x D / 4 (K6) floats a thread, 96 / 128 at D = 128.
constexpr int kQuad = 4;                        // threads a row
constexpr int kSplitThreads = kTile * kQuad;    // 256

// float4 chunks of a row a thread owns
template <int D>
struct SplitChunks {
  static_assert(D % (4 * kQuad) == 0, "D / 4 chunks split over a quad");
  static constexpr int value = D / (4 * kQuad);
};

// the quad's sum of a thread's partial: the same bits on its 4 threads
__device__ __forceinline__ float quad_sum(unsigned mask, float x) {
  x += __shfl_xor_sync(mask, x, 1);
  return x + __shfl_xor_sync(mask, x, 2);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void add4(float4 x, float4& acc) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

__device__ __forceinline__ void axpy4(float s, float4 x, float4& acc) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

// a 64-row tile of (rows, H, D) float32 rows [r0, r0 + 64) of head h into
// shared memory [64][D], rows at or past n zero
template <int D>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           float* dst, int b, int r0, int n,
                                           int H, int h, int tid) {
  for (int idx = tid; idx < kTile * D / 4; idx += kSplitThreads) {
    const int r = idx / (D / 4), c = idx - r * (D / 4), gr = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < n)
      x = __ldg(reinterpret_cast<const float4*>(
          src + (((size_t)b * n + gr) * H + h) * D) + c);
    reinterpret_cast<float4*>(dst)[idx] = x;
  }
}

// K5 f32 split: quad = query row; K / V tiles of 64 keys in shared memory.
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
bwd_dq_f32_split_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seg_q,
                        const int* __restrict__ seg_kv,
                        float* __restrict__ dq, int Sq, int Skv, int Hq,
                        int Hkv, float scale, int causal) {
  constexpr int kC = SplitChunks<D>::value;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;                                     // [kTile][D]
  float* Vs = Ks + kTile * D;                          // [kTile][D]
  int* Ss = reinterpret_cast<int*>(Vs + kTile * D);    // [kTile]
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, g = tid & (kQuad - 1);
  const unsigned quad = 0xfu << (tid & 28);
  const int q0 = blockIdx.x * kTile, i = q0 + tid / kQuad;
  const int offset = Skv - Sq;
  const bool live = i < Sq;
  float4 qr[kC], dor[kC], acc[kC];
  float l = 0.f, dl = 0.f;
  int sq = 0;
#pragma unroll
  for (int e = 0; e < kC; ++e)
    qr[e] = dor[e] = acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    const size_t row = (((size_t)b * Sq + i) * Hq + h) * D;
    const float4* qp = reinterpret_cast<const float4*>(q + row);
    const float4* op = reinterpret_cast<const float4*>(dout + row);
#pragma unroll
    for (int e = 0; e < kC; ++e) {
      qr[e] = __ldg(qp + g + kQuad * e);
      dor[e] = __ldg(op + g + kQuad * e);
    }
    l = lse[((size_t)b * Hq + h) * Sq + i];
    dl = delta[((size_t)b * Hq + h) * Sq + i];
    if (seg_q != nullptr) sq = seg_q[(size_t)b * Sq + i];
  }
  const int q_last = min(Sq, q0 + kTile) - 1;
  const int kv_hi = causal ? min(Skv, q_last + offset + 1) : Skv;
  for (int kv0 = 0; kv0 < kv_hi; kv0 += kTile) {
    __syncthreads();   // the previous tile's readers are done
    stage_rows<D>(k, Ks, b, kv0, Skv, Hkv, hk, tid);
    stage_rows<D>(v, Vs, b, kv0, Skv, Hkv, hk, tid);
    if (seg_q != nullptr && tid < kTile)
      Ss[tid] = kv0 + tid < Skv ? seg_kv[(size_t)b * Skv + kv0 + tid] : 0;
    __syncthreads();
    if (!live) continue;   // the quad's row: uniform across the quad
    const int jn = min(kTile, kv_hi - kv0);
    for (int j = 0; j < jn; ++j) {
      const int kc = kv0 + j;
      bool keep = !causal || kc <= i + offset;
      if (seg_q != nullptr) keep = keep && Ss[j] == sq;
      if (!keep) continue;
      const float4* kj = reinterpret_cast<const float4*>(Ks + j * D);
      const float4* vj = reinterpret_cast<const float4*>(Vs + j * D);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < kC; ++e) {
        s = dot4(qr[e], kj[g + kQuad * e], s);
        dp = dot4(dor[e], vj[g + kQuad * e], dp);
      }
      s = quad_sum(quad, s);
      dp = quad_sum(quad, dp);
      const float p = expf(s * scale - l);
      const float ds = p * (dp - dl) * scale;
#pragma unroll
      for (int e = 0; e < kC; ++e) axpy4(ds, kj[g + kQuad * e], acc[e]);
    }
  }
  if (live) {
    float4* o = reinterpret_cast<float4*>(dq + (((size_t)b * Sq + i) * Hq +
                                                h) * D);
#pragma unroll
    for (int e = 0; e < kC; ++e) o[g + kQuad * e] = acc[e];
  }
}

// K6 f32 split: quad = key row; it walks the G q heads of its KV head and
// the 64-query tiles that see any of the CTA's keys, dk / dv summed over
// the group in float32 registers.
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
bwd_dkv_f32_split_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_kv,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Sq, int Skv, int Hq, int Hkv, float scale,
                         int causal) {
  constexpr int kC = SplitChunks<D>::value;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                                     // [kTile][D]
  float* Os = Qs + kTile * D;                          // [kTile][D]
  float* Ls = Os + kTile * D;                          // [kTile]
  float* Ds = Ls + kTile;                              // [kTile]
  int* Ss = reinterpret_cast<int*>(Ds + kTile);        // [kTile]
  const int hk = blockIdx.y, b = blockIdx.z, G = Hq / Hkv;
  const int tid = threadIdx.x, g = tid & (kQuad - 1);
  const unsigned quad = 0xfu << (tid & 28);
  const int kv0 = blockIdx.x * kTile, j = kv0 + tid / kQuad;
  const int offset = Skv - Sq;
  const bool live = j < Skv;
  float4 kr[kC], vr[kC], dka[kC], dva[kC];
  int sk = 0;
#pragma unroll
  for (int e = 0; e < kC; ++e)
    kr[e] = vr[e] = dka[e] = dva[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    const size_t row = (((size_t)b * Skv + j) * Hkv + hk) * D;
    const float4* kp = reinterpret_cast<const float4*>(k + row);
    const float4* vp = reinterpret_cast<const float4*>(v + row);
#pragma unroll
    for (int e = 0; e < kC; ++e) {
      kr[e] = __ldg(kp + g + kQuad * e);
      vr[e] = __ldg(vp + g + kQuad * e);
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
      stage_rows<D>(q, Qs, b, q0, Sq, Hq, h, tid);
      stage_rows<D>(dout, Os, b, q0, Sq, Hq, h, tid);
      if (tid < kTile) {
        const int qi = q0 + tid;
        const size_t lr = ((size_t)b * Hq + h) * Sq + qi;
        Ls[tid] = qi < Sq ? lse[lr] : 0.f;
        Ds[tid] = qi < Sq ? delta[lr] : 0.f;
        if (seg_q != nullptr)
          Ss[tid] = qi < Sq ? seg_q[(size_t)b * Sq + qi] : 0;
      }
      __syncthreads();
      if (!live) continue;   // the quad's row: uniform across the quad
      const int in = min(kTile, Sq - q0);
      for (int r = 0; r < in; ++r) {
        bool keep = !causal || j <= q0 + r + offset;
        if (seg_q != nullptr) keep = keep && Ss[r] == sk;
        if (!keep) continue;
        const float4* qr = reinterpret_cast<const float4*>(Qs + r * D);
        const float4* orr = reinterpret_cast<const float4*>(Os + r * D);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < kC; ++e) {
          s = dot4(qr[g + kQuad * e], kr[e], s);
          dp = dot4(orr[g + kQuad * e], vr[e], dp);
        }
        s = quad_sum(quad, s);
        dp = quad_sum(quad, dp);
        const float p = expf(s * scale - Ls[r]);
        const float ds = p * (dp - Ds[r]) * scale;
#pragma unroll
        for (int e = 0; e < kC; ++e) {
          axpy4(p, orr[g + kQuad * e], dva[e]);
          axpy4(ds, qr[g + kQuad * e], dka[e]);
        }
      }
    }
  }
  if (live) {
    const size_t row = (((size_t)b * Skv + j) * Hkv + hk) * D;
    float4* kp = reinterpret_cast<float4*>(dk + row);
    float4* vp = reinterpret_cast<float4*>(dv + row);
#pragma unroll
    for (int e = 0; e < kC; ++e) {
      kp[g + kQuad * e] = dka[e];
      vp[g + kQuad * e] = dva[e];
    }
  }
}

// ---------------------------------------------------------------------------
// float32 at every other D <= 256 with D % 8 == 0: the split body at a
// runtime D
// ---------------------------------------------------------------------------
// The same two walks with D an argument and a row split over T threads (a
// group: lanes T r..T r + T - 1 of a warp): thread g owns the float4 chunks
// c = g + T e (e < C) with c < D / 4, every chunk of a row one owner (D is
// a multiple of 8, so a chunk lies wholly below D); a thread's registers
// hold C chunks, those past D zero and never read or written.  A dot
// product is summed over the group by log2(T) xor shuffles (1, 2, 4),
// whose sums are the same bits on every thread of the group: each step
// adds the same two floats on both partners, in either order, and float
// addition commutes.  T = 4 (a quad, C = 8: D <= 128, 64 rows a CTA) as
// the D 128 instance above; T = 8 above D 128 (C = 8: D <= 256), where a
// quad would hold 3 D / 4 (K5) or 4 D / 4 (K6) floats a thread, 192 / 256
// at D 256: an octet holds 96 / 128, and a CTA of kSplitThreads owns 32
// rows.  The staged tiles are 64 x D floats with rows D floats apart (2 x
// 64 KB at D 256, opted in past 48 KB).  K6 sums each 64-query tile's
// terms apart and adds the tile's sum to dk / dv, as the reference adds
// each block's dot (flash_attention.py:336-341).  One register a column
// summed over G x Sq terms in turn (16384 at B 4 x 2048, G 8), as the
// constant-D instances above sum, lies 2.0-6.5e-5 from the float64 plain
// version at B 4 x 2048 causal and B 2 x 2048 packed, past the 1e-5 bar;
// the tile sums lie 3.3-8.8e-6 from it, the float32 plain version
// 0.65-3.0e-5 (chip_f32_bwd_accuracy.py on an H100).
template <int T>
struct Group {
  static_assert(T == 4 || T == 8, "a row is split over 4 or 8 threads");
  static constexpr int kRows = kSplitThreads / T;   // rows a CTA
  // the group's lanes in the warp's mask
  static __device__ __forceinline__ unsigned mask(int tid) {
    return ((1u << T) - 1) << (tid & (32 - T));
  }
  // the group's sum of a thread's partial: the same bits on its T threads
  static __device__ __forceinline__ float sum(unsigned m, float x) {
#pragma unroll
    for (int o = 1; o < T; o <<= 1) x += __shfl_xor_sync(m, x, o);
    return x;
  }
};

// stage_rows at a runtime D (rows D floats apart)
__device__ __forceinline__ void stage_rows_rt(const float* __restrict__ src,
                                              float* dst, int b, int r0,
                                              int n, int H, int h, int D,
                                              int tid) {
  const int c4 = D / 4;
  for (int idx = tid; idx < kTile * c4; idx += kSplitThreads) {
    const int r = idx / c4, c = idx - r * c4, gr = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < n)
      x = __ldg(reinterpret_cast<const float4*>(
          src + (((size_t)b * n + gr) * H + h) * D) + c);
    reinterpret_cast<float4*>(dst)[idx] = x;
  }
}

// K5 f32 at a runtime D: group = query row; K / V tiles of 64 keys in
// shared memory.
template <int T, int C>
__global__ void __launch_bounds__(kSplitThreads)
bwd_dq_f32_rt_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, float* __restrict__ dq,
                     int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                     int causal) {
  using Grp = Group<T>;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;                                     // [kTile][D]
  float* Vs = Ks + kTile * D;                          // [kTile][D]
  int* Ss = reinterpret_cast<int*>(Vs + kTile * D);    // [kTile]
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, g = tid & (T - 1);
  const unsigned grp = Grp::mask(tid);
  const int q0 = blockIdx.x * Grp::kRows, i = q0 + tid / T;
  const int offset = Skv - Sq, nc = D / 4;
  const bool live = i < Sq;
  float4 qr[C], dor[C], acc[C];
  float l = 0.f, dl = 0.f;
  int sq = 0;
#pragma unroll
  for (int e = 0; e < C; ++e)
    qr[e] = dor[e] = acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    const size_t row = (((size_t)b * Sq + i) * Hq + h) * D;
    const float4* qp = reinterpret_cast<const float4*>(q + row);
    const float4* op = reinterpret_cast<const float4*>(dout + row);
#pragma unroll
    for (int e = 0; e < C; ++e) {
      if (g + T * e < nc) {
        qr[e] = __ldg(qp + g + T * e);
        dor[e] = __ldg(op + g + T * e);
      }
    }
    l = lse[((size_t)b * Hq + h) * Sq + i];
    dl = delta[((size_t)b * Hq + h) * Sq + i];
    if (seg_q != nullptr) sq = seg_q[(size_t)b * Sq + i];
  }
  const int q_last = min(Sq, q0 + Grp::kRows) - 1;
  const int kv_hi = causal ? min(Skv, q_last + offset + 1) : Skv;
  for (int kv0 = 0; kv0 < kv_hi; kv0 += kTile) {
    __syncthreads();   // the previous tile's readers are done
    stage_rows_rt(k, Ks, b, kv0, Skv, Hkv, hk, D, tid);
    stage_rows_rt(v, Vs, b, kv0, Skv, Hkv, hk, D, tid);
    if (seg_q != nullptr && tid < kTile)
      Ss[tid] = kv0 + tid < Skv ? seg_kv[(size_t)b * Skv + kv0 + tid] : 0;
    __syncthreads();
    if (!live) continue;   // the group's row: uniform across the group
    const int jn = min(kTile, kv_hi - kv0);
    for (int j = 0; j < jn; ++j) {
      const int kc = kv0 + j;
      bool keep = !causal || kc <= i + offset;
      if (seg_q != nullptr) keep = keep && Ss[j] == sq;
      if (!keep) continue;
      const float4* kj = reinterpret_cast<const float4*>(Ks + j * D);
      const float4* vj = reinterpret_cast<const float4*>(Vs + j * D);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < C; ++e) {
        if (g + T * e < nc) {
          s = dot4(qr[e], kj[g + T * e], s);
          dp = dot4(dor[e], vj[g + T * e], dp);
        }
      }
      s = Grp::sum(grp, s);
      dp = Grp::sum(grp, dp);
      const float p = expf(s * scale - l);
      const float ds = p * (dp - dl) * scale;
#pragma unroll
      for (int e = 0; e < C; ++e)
        if (g + T * e < nc) axpy4(ds, kj[g + T * e], acc[e]);
    }
  }
  if (live) {
    float4* o = reinterpret_cast<float4*>(dq + (((size_t)b * Sq + i) * Hq +
                                                h) * D);
#pragma unroll
    for (int e = 0; e < C; ++e)
      if (g + T * e < nc) o[g + T * e] = acc[e];
  }
}

// K6 f32 at a runtime D: group = key row; it walks the G q heads of its KV
// head and the 64-query tiles that see any of the CTA's keys, dk / dv
// summed over the group in float32 registers.
template <int T, int C>
__global__ void __launch_bounds__(kSplitThreads)
bwd_dkv_f32_rt_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ seg_q,
                      const int* __restrict__ seg_kv,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq,
                      int Skv, int Hq, int Hkv, int D, float scale,
                      int causal) {
  using Grp = Group<T>;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                                     // [kTile][D]
  float* Os = Qs + kTile * D;                          // [kTile][D]
  float* Ls = Os + kTile * D;                          // [kTile]
  float* Ds = Ls + kTile;                              // [kTile]
  int* Ss = reinterpret_cast<int*>(Ds + kTile);        // [kTile]
  const int hk = blockIdx.y, b = blockIdx.z, G = Hq / Hkv;
  const int tid = threadIdx.x, g = tid & (T - 1);
  const unsigned grp = Grp::mask(tid);
  const int kv0 = blockIdx.x * Grp::kRows, j = kv0 + tid / T;
  const int offset = Skv - Sq, nc = D / 4;
  const bool live = j < Skv;
  float4 kr[C], vr[C], dka[C], dva[C];
  int sk = 0;
#pragma unroll
  for (int e = 0; e < C; ++e)
    kr[e] = vr[e] = dka[e] = dva[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    const size_t row = (((size_t)b * Skv + j) * Hkv + hk) * D;
    const float4* kp = reinterpret_cast<const float4*>(k + row);
    const float4* vp = reinterpret_cast<const float4*>(v + row);
#pragma unroll
    for (int e = 0; e < C; ++e) {
      if (g + T * e < nc) {
        kr[e] = __ldg(kp + g + T * e);
        vr[e] = __ldg(vp + g + T * e);
      }
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
      stage_rows_rt(q, Qs, b, q0, Sq, Hq, h, D, tid);
      stage_rows_rt(dout, Os, b, q0, Sq, Hq, h, D, tid);
      if (tid < kTile) {
        const int qi = q0 + tid;
        const size_t lr = ((size_t)b * Hq + h) * Sq + qi;
        Ls[tid] = qi < Sq ? lse[lr] : 0.f;
        Ds[tid] = qi < Sq ? delta[lr] : 0.f;
        if (seg_q != nullptr)
          Ss[tid] = qi < Sq ? seg_q[(size_t)b * Sq + qi] : 0;
      }
      __syncthreads();
      if (!live) continue;   // the group's row: uniform across the group
      // the tile's sums, added to dk / dv once the tile is walked
      float4 tk[C], tv[C];
#pragma unroll
      for (int e = 0; e < C; ++e)
        tk[e] = tv[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int in = min(kTile, Sq - q0);
      for (int r = 0; r < in; ++r) {
        bool keep = !causal || j <= q0 + r + offset;
        if (seg_q != nullptr) keep = keep && Ss[r] == sk;
        if (!keep) continue;
        const float4* qrow = reinterpret_cast<const float4*>(Qs + r * D);
        const float4* orow = reinterpret_cast<const float4*>(Os + r * D);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < C; ++e) {
          if (g + T * e < nc) {
            s = dot4(qrow[g + T * e], kr[e], s);
            dp = dot4(orow[g + T * e], vr[e], dp);
          }
        }
        s = Grp::sum(grp, s);
        dp = Grp::sum(grp, dp);
        const float p = expf(s * scale - Ls[r]);
        const float ds = p * (dp - Ds[r]) * scale;
#pragma unroll
        for (int e = 0; e < C; ++e) {
          if (g + T * e < nc) {
            axpy4(p, orow[g + T * e], tv[e]);
            axpy4(ds, qrow[g + T * e], tk[e]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < C; ++e) {
        add4(tk[e], dka[e]);
        add4(tv[e], dva[e]);
      }
    }
  }
  if (live) {
    const size_t row = (((size_t)b * Skv + j) * Hkv + hk) * D;
    float4* kp = reinterpret_cast<float4*>(dk + row);
    float4* vp = reinterpret_cast<float4*>(dv + row);
#pragma unroll
    for (int e = 0; e < C; ++e) {
      if (g + T * e < nc) {
        kp[g + T * e] = dka[e];
        vp[g + T * e] = dva[e];
      }
    }
  }
}
// ---------------------------------------------------------------------------
// Hopper path: bfloat16, D <= 128 on 128-wide tiles (see the note at the top;
// 128 < D <= 256: the 256-wide kernels further down)
// ---------------------------------------------------------------------------
constexpr int kHThreads = 384;     // consumers: warpgroups 0, 1; producer 2
constexpr int kHConsumers = 256;
constexpr int kBig = 128;          // the CTA's own tile (K5 queries, K6 keys)
constexpr int kSmall = 64;         // the streamed tile (K5 keys, K6 queries)
constexpr int kRT = 64;            // tokens a segment range covers
constexpr int kStages = 3;
constexpr int kBigHalf = kBig * 128;       // a 128-row x 64-wide bf16 box
constexpr int kSmallHalf = kSmall * 128;   // a 64-row x 64-wide bf16 box
constexpr int kBigTile = 2 * kBigHalf;     // 128 rows x 128 d, bytes
constexpr int kSmallTile = 2 * kSmallHalf;
constexpr int kVec = kSmall + kLead1d;     // a 1-d box: lse, delta or ids
constexpr int kVecStride = stage_ints(kVec);   // its stride a stage
constexpr float kLog2e = 1.4426950408889634f;
// 1024 of alignment slack, the two resident tiles, the ring, per stage the
// lse, delta and ids of 64 rows (K6; K5 uses the ids only), a slot, a full
// and an empty barrier, and one barrier for the resident tiles
constexpr size_t kHSmem = 1024 + 2 * (size_t)kBigTile +
                          kStages * (2 * (size_t)kSmallTile + 3 * kVecStride * 4 +
                                     8 + 16) + 8;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// the [min, max] segment id of 128-token tile t: the union of the ranges
// of its two 64-token halves (rng: (B, n, 2), n = ceil(S / 64))
__device__ __forceinline__ int2 big_range(const int* rng, int b, int n,
                                          int t) {
  const int* r = rng + ((size_t)b * n + 2 * t) * 2;
  int2 out = make_int2(r[0], r[1]);
  if (2 * t + 1 < n) {
    out.x = min(out.x, r[2]);
    out.y = max(out.y, r[3]);
  }
  return out;
}

#ifdef PTT_F16
// float16 dS in units of its row (see the note at the top).  A row's dS is
// formed as P o (dP - delta) * su with su = scale * 2^k, so that it comes
// out in units of 2^-k.  su < 0 marks a row with no nonzero dS yet: its
// unit is 1 and its dS comes out negated until it takes a unit.  kDsTop -
// (the biased exponent of a value in units of 2^-k) is the change of k
// that puts the value in [2^14, 2^15); k stays in [-kDsMax, kDsMax]
constexpr int kDsTop = 127 + 14;
constexpr int kDsMax = 64;

__device__ __forceinline__ float pow2f(int k) {   // 2^k, -126 <= k <= 127
  return __int_as_float((k + 127) << 23);
}

__device__ __forceinline__ int exponent_bits(float x) {
  return (__float_as_int(x) >> 23) & 0xff;
}

// the largest of x over the quad of lanes that hold one fragment row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// does a row whose largest |dS| this tile is `top` (in its unit) take a
// new unit: an unset row with a nonzero dS, a set one at 2^15 or more
__device__ __forceinline__ bool ds_moves(float top, float su) {
  return su < 0.f ? top > 0.f : top >= 32768.f;
}

// after a tile's dS is formed in its rows' units (rows rl, rl + 8 of a
// wgmma fragment, ds[i] of the second where i & 2): a row that moves
// (ds_moves) takes the unit that puts its largest |dS| in [2^14, 2^15),
// and its dS and its values in the float32 accumulator acc (rows as dS,
// no product in flight on it; zero while the row is unset) go into the
// new unit.  Rare after a row's first tile, so the warp votes and skips
template <int N, int M>
__device__ __forceinline__ void ds_fit(float (&ds)[N], float (&acc)[M],
                                       float (&su)[2], float scale) {
  float top[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i)
    top[(i >> 1) & 1] = fmaxf(top[(i >> 1) & 1], fabsf(ds[i]));
  top[0] = quad_max(top[0]);
  top[1] = quad_max(top[1]);
  if (!__any_sync(0xffffffffu,
                  ds_moves(top[0], su[0]) || ds_moves(top[1], su[1])))
    return;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float r = 1.f;
    if (ds_moves(top[j], su[j])) {
      // a set row only lowers k, by at most kDsTop - 254 = -113, so
      // k1 - k0 lies in [-113, 0] for it, in [-64, 64] for an unset one
      const int k0 = exponent_bits(fabsf(su[j])) - exponent_bits(scale);
      const int k1 = min(max(k0 + kDsTop - exponent_bits(top[j]), -kDsMax),
                         kDsMax);
      r = su[j] < 0.f ? -pow2f(k1 - k0) : pow2f(k1 - k0);
      su[j] = scale * pow2f(k1);
    }
#pragma unroll
    for (int i = 2 * j; i < M; i += 4) {
      acc[i] *= r;
      acc[i + 1] *= r;
    }
#pragma unroll
    for (int i = 2 * j; i < N; i += 4) {
      ds[i] *= r;
      ds[i + 1] *= r;
    }
  }
}

// the accumulator out of its rows' units (times 2^-k = scale / |su|,
// exact), after its last product
template <int M>
__device__ __forceinline__ void ds_units_out(float (&acc)[M],
                                             const float (&su)[2],
                                             float scale) {
  const float f0 = scale / fabsf(su[0]), f1 = scale / fabsf(su[1]);
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] *= (i & 2) ? f1 : f0;
}
#endif

// the 64 x N / 2 accumulator `a` of warpgroup-row rl (rows rl, rl + 8) as
// bf16 into a tile of 64-wide boxes `box` bytes apart, in the 128-byte
// swizzled layout TMA stores from
template <int N>
__device__ __forceinline__ void stage_acc(unsigned char* tile,
                                          const float (&a)[N], int rl, int c,
                                          int box) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    unsigned char* base = tile + (j / 8) * box +
                          (((j % 8) ^ (rl & 7)) << 4) + 4 * c;
    *reinterpret_cast<uint32_t*>(base + rl * 128) =
        pack16(a[4 * j], a[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(base + (rl + 8) * 128) =
        pack16(a[4 * j + 2], a[4 * j + 3]);
  }
}

// a 64 x 16 KS accumulator, rounded to bf16, as the register A operand of
// KS k steps: k step t takes d[8t..8t+7]
template <int KS>
__device__ __forceinline__ void pack_a(const float (&d)[8 * KS],
                                       uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int t = 0; t < KS; ++t) {
    a[t][0] = pack16(d[8 * t], d[8 * t + 1]);
    a[t][1] = pack16(d[8 * t + 2], d[8 * t + 3]);
    a[t][2] = pack16(d[8 * t + 4], d[8 * t + 5]);
    a[t][3] = pack16(d[8 * t + 6], d[8 * t + 7]);
  }
}

// X = A . B^T over 64 BOXES d for a 64-row A and an N / 2-row B, both
// K-major tiles of BOXES 64-wide boxes (`a_box`, `b_box` bytes apart; a
// 128-byte swizzled row of a box): m64n(N/2)k16 x 4 BOXES k steps, one
// commit group
template <int BOXES, int N>
__device__ __forceinline__ void issue_abt(float (&x)[N],
                                          const unsigned char* a, int a_box,
                                          const unsigned char* bt,
                                          int b_box) {
#pragma unroll
  for (int t = 0; t < 4 * BOXES; ++t)
    wgmma_ss<0, 0>(x, gmma_desc(a + (t / 4) * a_box + (t % 4) * 32, 16, 1024),
                   gmma_desc(bt + (t / 4) * b_box + (t % 4) * 32, 16, 1024),
                   t > 0);
  wgmma_commit();
}

// acc += A . T for A in registers (64 x 16 KS, KS k steps) and T a 16
// KS-row tile read MN-major (its rows are the k dimension; its 64-wide
// boxes `t_box` bytes apart): m64n(N/2)k16 x KS
template <int KS, int N>
__device__ __forceinline__ void issue_at(float (&acc)[N],
                                         const uint32_t (&a)[KS][4],
                                         const unsigned char* t, int t_box) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
    wgmma_rs<1>(acc, a[k], gmma_desc(t + k * 2048, t_box, 1024), 1);
}

// K5 on Hopper: one CTA per (128-query tile, q head, batch row), the
// heaviest (last) q tiles of every head first.  Warpgroup w < 2 owns query
// rows [64w, 64w + 64); one warp of warpgroup 2 loads Q and dO once, then
// streams 64-key K / V tiles (and, with ids, the tile's key ids) into the
// ring and writes each stage's slot: (key tile, needs the element mask),
// or (-1, 0) to end.
template <bool SEG>
__global__ void __launch_bounds__(kHThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap dq_map,
                    const __grid_constant__ CUtensorMap seg_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg_q,
                    const int* __restrict__ q_rng,
                    const int* __restrict__ kv_rng, int B, int Sq, int Skv,
                    int Hq, int Hkv, float scale, int causal) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* Qs = align1024(wg_smem);
  unsigned char* Os = Qs + kBigTile;
  unsigned char* Ks = Os + kBigTile;                    // [stage]
  unsigned char* Vs = Ks + kStages * kSmallTile;        // [stage]
  int* seg_s = reinterpret_cast<int*>(Vs + kStages * kSmallTile);  // [stage]
  int2* slot = reinterpret_cast<int2*>(seg_s + kStages * kVecStride);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(slot + kStages);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int n_qt = (Sq + kBig - 1) / kBig;
  const int bh = blockIdx.x % (Hq * B);
  const int qt = n_qt - 1 - blockIdx.x / (Hq * B);
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBig;
  const int offset = Skv - Sq;   // query i sees keys j <= i + offset
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kHConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----------------------------------------------------------
    reg_dealloc<24>();
    if (tid >= 32) return;
    const int lane = tid;
    const int kv_hi = causal ? min(Skv, q0 + kBig + offset) : Skv;
    const int n_kt = kv_hi > 0 ? (kv_hi + kSmall - 1) / kSmall : 0;
    if (lane == 0) {   // Q and dO first: the ranges wait on global loads
      mbar_expect_tx(q_full, 2 * kBigTile);
      tma_load_4d(Qs, &q_map, q_full, 0, h, q0, b);
      tma_load_4d(Qs + kBigHalf, &q_map, q_full, 64, h, q0, b);
      tma_load_4d(Os, &do_map, q_full, 0, h, q0, b);
      tma_load_4d(Os + kBigHalf, &do_map, q_full, 64, h, q0, b);
    }
    int2 qr = make_int2(0, 0);
    if constexpr (SEG) qr = big_range(q_rng, b, (Sq + kRT - 1) / kRT, qt);
    int it = 0;
    // 32 key tiles at a time, lane l deciding tile base - l
    for (int base = n_kt - 1; base >= 0; base -= 32) {
      const int j = base - lane;
      bool vis = j >= 0;
      bool masked = vis && ((causal && j * kSmall + kSmall - 1 > q0 + offset) ||
                            j * kSmall + kSmall > Skv);
      if constexpr (SEG) {
        if (vis) {
          const int* r = kv_rng + ((size_t)b * ((Skv + kRT - 1) / kRT) + j) * 2;
          vis = r[1] >= qr.x && r[0] <= qr.y;
          masked = masked || r[0] != r[1] || qr.x != qr.y || r[0] != qr.x;
        }
      }
      unsigned todo = __ballot_sync(0xffffffffu, vis);
      const unsigned mask_bits = __ballot_sync(0xffffffffu, masked);
      if (lane != 0) continue;
      while (todo) {
        const int l = __ffs(todo) - 1;
        todo &= todo - 1;
        const int jt = base - l, k0 = jt * kSmall;
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        slot[s] = make_int2(jt, (mask_bits >> l) & 1);
        unsigned char* kd = Ks + s * kSmallTile;
        unsigned char* vd = Vs + s * kSmallTile;
        mbar_expect_tx(&full[s], 2 * kSmallTile + (SEG ? kVec * 4 : 0));
        tma_load_4d(kd, &k_map, &full[s], 0, hk, k0, b);
        tma_load_4d(kd + kSmallHalf, &k_map, &full[s], 64, hk, k0, b);
        tma_load_4d(vd, &v_map, &full[s], 0, hk, k0, b);
        tma_load_4d(vd + kSmallHalf, &v_map, &full[s], 64, hk, k0, b);
        if constexpr (SEG)
          tma_load_1d(seg_s + s * kVecStride, &seg_map, &full[s],
                      (b * Skv + k0) & ~3);
        ++it;
      }
    }
    if (lane == 0) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      slot[s] = make_int2(-1, 0);
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers -------------------------------------------------------------
  reg_alloc<240>();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int rl = wg * 64 + warp * 16 + g;   // rows rl, rl + 8 of the tile
  const int r0 = q0 + rl, r1 = r0 + 8;
  const size_t lrow = ((size_t)b * Hq + h) * Sq;
  // lse in the log2 domain; rows past Sq load nothing and store nothing
  const float ln0 = r0 < Sq ? lse[lrow + r0] * kLog2e : 0.f;
  const float ln1 = r1 < Sq ? lse[lrow + r1] * kLog2e : 0.f;
  const float dl0 = r0 < Sq ? delta[lrow + r0] : 0.f;
  const float dl1 = r1 < Sq ? delta[lrow + r1] : 0.f;
  int sq0 = 0, sq1 = 0;
  if constexpr (SEG) {
    sq0 = r0 < Sq ? seg_q[(size_t)b * Sq + r0] : 0;
    sq1 = r1 < Sq ? seg_q[(size_t)b * Sq + r1] : 0;
  }
  const float sl2 = scale * kLog2e;
  const unsigned char* qa = Qs + wg * 64 * 128;
  const unsigned char* oa = Os + wg * 64 * 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t da[4][4];
#ifdef PTT_F16
  float su[2] = {-scale, -scale};   // the dS units of rows r0, r1
#endif
  // a key tile's ids start `lead` into their stage (a 1-d box's lead-in),
  // the same for every tile of the CTA
  const int lead = SEG ? (b * Skv) & 3 : 0;

  mbar_wait(q_full, 0);
  // per key tile: S = Q K^T and dP = dO V^T issued together; P once S is
  // in (the last tile's dq is then done too, and its stage is released);
  // dS once dP is in; dq += dS K issued and left in flight under the next
  // tile's products
  int cur = 0;
  for (;; ++cur) {
    const int st = cur % kStages;
    mbar_wait(&full[st], (cur / kStages) & 1);
    const int2 sl = slot[st];
    if (sl.x < 0) break;
    wgmma_fence();
    issue_abt<2>(sc, qa, kBigHalf, Ks + st * kSmallTile, kSmallHalf);
    issue_abt<2>(dp, oa, kBigHalf, Vs + st * kSmallTile, kSmallHalf);
    wgmma_wait<1>();
    fence_regs(sc);
    if (cur > 0) mbar_arrive(&empty[(cur + kStages - 1) % kStages]);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sc[i] = exp2_approx(fmaf(sc[i], sl2, -((i & 2) ? ln1 : ln0)));
    if (sl.y) {   // P = 0 on the pairs the mask hides
      const int k0 = sl.x * kSmall;
      const int* ids = seg_s + st * kVecStride + lead;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int cl = 8 * (i / 4) + 2 * c + (i & 1), col = k0 + cl;
        bool keep = col < Skv && (!causal || col <= ((i & 2) ? r1 : r0) + offset);
        if constexpr (SEG) keep = keep && ids[cl] == ((i & 2) ? sq1 : sq0);
        if (!keep) sc[i] = 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#ifdef PTT_F16
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = sc[i] * (dp[i] - ((i & 2) ? dl1 : dl0)) * su[(i >> 1) & 1];
    fence_regs(acc);   // the last tile's dq += dS K is done
    ds_fit(dp, acc, su, scale);
    fence_regs(acc);
#else
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = sc[i] * (dp[i] - ((i & 2) ? dl1 : dl0)) * scale;
#endif
    pack_a<4>(dp, da);
    wgmma_fence();
    issue_at(acc, da, Ks + st * kSmallTile, kSmallHalf);
    wgmma_commit();
#ifdef PTT_F16
    // retired before the next tile: ptxas serialises every wgmma of the
    // kernel (C7514) when ds_fit reads an accumulator whose product is in
    // flight across the loop's back edge
    wgmma_wait<0>();
    fence_regs(acc);
#endif
  }
  wgmma_wait<0>();
  fence_regs(acc);
#ifdef PTT_F16
  ds_units_out(acc, su, scale);
#endif

  // dq through this warpgroup's rows of Q's shared memory (its last Q K^T
  // is done) and a TMA store that drops rows past Sq
  stage_acc(Qs, acc, rl, c, kBigHalf);
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (tid == 0 && q0 + wg * 64 < Sq) {
    tma_store_4d(&dq_map, Qs + wg * 64 * 128, 0, h, q0 + wg * 64, b);
    tma_store_4d(&dq_map, Qs + kBigHalf + wg * 64 * 128, 64, h, q0 + wg * 64,
                 b);
    tma_store_commit_wait();
  }
}

// K6 on Hopper: one CTA per (128-key tile, kv head, batch row), the key
// tiles that see the most queries (the first) first.  Warpgroup w < 2 owns
// keys [64w, 64w + 64) of the tile; one warp of warpgroup 2 loads K and V
// once, then walks the G q heads of the group x the 64-query tiles at or
// below the diagonal, streaming Q, dO, lse, delta (and, with ids, the
// query ids) of each into the ring; a stage's slot holds (the tile's first
// query, needs the element mask | q head << 1), or (-1, 0) to end.
template <bool SEG>
__global__ void __launch_bounds__(kHThreads, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap dk_map,
                     const __grid_constant__ CUtensorMap dv_map,
                     const __grid_constant__ CUtensorMap lse_map,
                     const __grid_constant__ CUtensorMap delta_map,
                     const __grid_constant__ CUtensorMap seg_map,
                     const int* __restrict__ seg_kv,
                     const int* __restrict__ q_rng,
                     const int* __restrict__ kv_rng, int B, int Sq, int Skv,
                     int Hq, int Hkv, float scale, int causal) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* Ks = align1024(wg_smem);
  unsigned char* Vs = Ks + kBigTile;
  unsigned char* Qs = Vs + kBigTile;                    // [stage]
  unsigned char* Os = Qs + kStages * kSmallTile;        // [stage]
  float* lse_s = reinterpret_cast<float*>(Os + kStages * kSmallTile);
  float* dl_s = lse_s + kStages * kVecStride;                 // [stage]
  int* seg_s = reinterpret_cast<int*>(dl_s + kStages * kVecStride);
  int2* slot = reinterpret_cast<int2*>(seg_s + kStages * kVecStride);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(slot + kStages);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x % (Hkv * B);
  const int kt = blockIdx.x / (Hkv * B);
  const int hk = bh % Hkv, b = bh / Hkv;
  const int G = Hq / Hkv;
  const int k0 = kt * kBig;
  const int offset = Skv - Sq;   // query i sees keys j <= i + offset
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kHConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----------------------------------------------------------
    reg_dealloc<24>();
    if (tid >= 32) return;
    const int lane = tid;
    const int n_qt = (Sq + kSmall - 1) / kSmall;
    // queries i >= key - offset see the key: the first tile that can
    const int qt_lo = causal ? max(0, k0 - offset) / kSmall : 0;
    if (lane == 0) {   // K and V first: the ranges wait on global loads
      mbar_expect_tx(kv_full, 2 * kBigTile);
      tma_load_4d(Ks, &k_map, kv_full, 0, hk, k0, b);
      tma_load_4d(Ks + kBigHalf, &k_map, kv_full, 64, hk, k0, b);
      tma_load_4d(Vs, &v_map, kv_full, 0, hk, k0, b);
      tma_load_4d(Vs + kBigHalf, &v_map, kv_full, 64, hk, k0, b);
    }
    int2 kr = make_int2(0, 0);
    if constexpr (SEG) kr = big_range(kv_rng, b, (Skv + kRT - 1) / kRT, kt);
    int it = 0;
    for (int h = hk * G; h < hk * G + G; ++h) {
      // 32 query tiles at a time, lane l deciding tile base + l
      for (int base = qt_lo; base < n_qt; base += 32) {
        const int j = base + lane, q0 = j * kSmall;
        bool vis = j < n_qt;
        bool masked = vis && ((causal && k0 + kBig - 1 > q0 + offset) ||
                              q0 + kSmall > Sq || k0 + kBig > Skv);
        if constexpr (SEG) {
          if (vis) {
            const int* r = q_rng + ((size_t)b * n_qt + j) * 2;
            vis = kr.y >= r[0] && kr.x <= r[1];
            masked = masked || kr.x != kr.y || r[0] != r[1] || kr.x != r[0];
          }
        }
        unsigned todo = __ballot_sync(0xffffffffu, vis);
        const unsigned mask_bits = __ballot_sync(0xffffffffu, masked);
        if (lane != 0) continue;
        while (todo) {
          const int l = __ffs(todo) - 1;
          todo &= todo - 1;
          const int qs = (base + l) * kSmall;
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          slot[s] = make_int2(qs, ((mask_bits >> l) & 1) | (h << 1));
          unsigned char* qd = Qs + s * kSmallTile;
          unsigned char* od = Os + s * kSmallTile;
          mbar_expect_tx(&full[s], 2 * kSmallTile + (SEG ? 3 : 2) * kVec * 4);
          tma_load_4d(qd, &q_map, &full[s], 0, h, qs, b);
          tma_load_4d(qd + kSmallHalf, &q_map, &full[s], 64, h, qs, b);
          tma_load_4d(od, &do_map, &full[s], 0, h, qs, b);
          tma_load_4d(od + kSmallHalf, &do_map, &full[s], 64, h, qs, b);
          const int row = ((b * Hq + h) * Sq + qs) & ~3;
          tma_load_1d(lse_s + s * kVecStride, &lse_map, &full[s], row);
          tma_load_1d(dl_s + s * kVecStride, &delta_map, &full[s], row);
          if constexpr (SEG)
            tma_load_1d(seg_s + s * kVecStride, &seg_map, &full[s],
                        (b * Sq + qs) & ~3);
          ++it;
        }
      }
    }
    if (lane == 0) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      slot[s] = make_int2(-1, 0);
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers -------------------------------------------------------------
  reg_alloc<240>();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int rl = wg * 64 + warp * 16 + g;   // keys rl, rl + 8 of the tile
  const int key0 = k0 + rl, key1 = key0 + 8;
  int sk0 = 0, sk1 = 0;
  if constexpr (SEG) {
    sk0 = key0 < Skv ? seg_kv[(size_t)b * Skv + key0] : 0;
    sk1 = key1 < Skv ? seg_kv[(size_t)b * Skv + key1] : 0;
  }
  const float sl2 = scale * kLog2e;
  const unsigned char* ka = Ks + wg * 64 * 128;
  const unsigned char* va = Vs + wg * 64 * 128;
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  float sc[32], dp[32];
  uint32_t pa[4][4], da[4][4];
#ifdef PTT_F16
  float su[2] = {-scale, -scale};   // the dS^T units of keys key0, key1
#endif
  // a query tile's ids start seg_lead into their stage (a 1-d box's
  // lead-in), the same for every tile of the CTA
  const int seg_lead = SEG ? (b * Sq) & 3 : 0;

  mbar_wait(kv_full, 0);
  // per query tile: S^T = K Q^T and dP^T = V dO^T issued together; P^T
  // once S^T is in, and dV += P^T dO issued under dP^T; dS^T once dP^T is
  // in, and dK += dS^T Q; the stage is released once both are done
  for (int cur = 0;; ++cur) {
    const int st = cur % kStages;
    mbar_wait(&full[st], (cur / kStages) & 1);
    const int2 sl = slot[st];
    if (sl.x < 0) break;
    const unsigned char* qt = Qs + st * kSmallTile;
    const unsigned char* ot = Os + st * kSmallTile;
    // this tile's lse and delta (of q head sl.y >> 1) start lead in
    const int lead = ((b * Hq + (sl.y >> 1)) * Sq + sl.x) & 3;
    wgmma_fence();
    issue_abt<2>(sc, ka, kBigHalf, qt, kSmallHalf);
    issue_abt<2>(dp, va, kBigHalf, ot, kSmallHalf);
    wgmma_wait<1>();
    fence_regs(sc);
    // columns are queries: sc[4j + e] is query 8j + 2c + (e & 1) of the tile
    const float* ls = lse_s + st * kVecStride + lead;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float l0 = ls[8 * j + 2 * c] * -kLog2e;
      const float l1 = ls[8 * j + 2 * c + 1] * -kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], sl2, (e & 1) ? l1 : l0));
    }
    if (sl.y & 1) {   // P = 0 on the pairs the mask hides
      const int* ids = seg_s + st * kVecStride + seg_lead;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int cl = 8 * (i / 4) + 2 * c + (i & 1), qi = sl.x + cl;
        const int key = (i & 2) ? key1 : key0;
        bool keep = qi < Sq && key < Skv && (!causal || key <= qi + offset);
        if constexpr (SEG) keep = keep && ids[cl] == ((i & 2) ? sk1 : sk0);
        if (!keep) sc[i] = 0.f;
      }
    }
    pack_a<4>(sc, pa);
    wgmma_fence();
    issue_at(dv, pa, ot, kSmallHalf);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(dp);
    const float* ds = dl_s + st * kVecStride + lead;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d0 = ds[8 * j + 2 * c], d1 = ds[8 * j + 2 * c + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#ifdef PTT_F16
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d1 : d0)) * su[e >> 1];
#else
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d1 : d0)) * scale;
#endif
    }
#ifdef PTT_F16
    ds_fit(dp, dk, su, scale);   // dk's last product is done
#endif
    pack_a<4>(dp, da);
    wgmma_fence();
    issue_at(dk, da, qt, kSmallHalf);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&empty[st]);
  }

  // dk and dv through this warpgroup's rows of K's and V's shared memory
  // (only this warpgroup read them) and TMA stores that drop rows past Skv
#ifdef PTT_F16
  ds_units_out(dk, su, scale);
#endif
  stage_acc(Ks, dk, rl, c, kBigHalf);
  stage_acc(Vs, dv, rl, c, kBigHalf);
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (tid == 0 && k0 + wg * 64 < Skv) {
    const int r = k0 + wg * 64;
    tma_store_4d(&dk_map, Ks + wg * 64 * 128, 0, hk, r, b);
    tma_store_4d(&dk_map, Ks + kBigHalf + wg * 64 * 128, 64, hk, r, b);
    tma_store_4d(&dv_map, Vs + wg * 64 * 128, 0, hk, r, b);
    tma_store_4d(&dv_map, Vs + kBigHalf + wg * 64 * 128, 64, hk, r, b);
    tma_store_commit_wait();
  }
}

// ---------------------------------------------------------------------------
// Hopper path: bfloat16, 128 < D <= 256 on 256-wide tiles (see the note at
// the top)
// ---------------------------------------------------------------------------
constexpr int kWide = 256;                 // tile width
constexpr int kWBoxes = kWide / 64;        // 64-wide boxes a tile row
// K5: the CTA's 128 queries (Q and dO resident, 64 KB each), 32-key K / V
// tiles in a 3-stage ring
constexpr int kW5Keys = 32;
constexpr int kW5Stages = 3;
constexpr int kW5QBox = kBig * 128;        // a 128-row box, bytes
constexpr int kW5KBox = kW5Keys * 128;     // a 32-row box
constexpr int kW5QTile = kWBoxes * kW5QBox;
constexpr int kW5KTile = kWBoxes * kW5KBox;
constexpr int kW5Vec = kW5Keys + kLead1d;  // a key tile's ids (1-d box)
constexpr int kW5VecStride = stage_ints(kW5Vec);
constexpr size_t kW5Smem = 1024 + 2 * (size_t)kW5QTile +
                           kW5Stages * (2 * (size_t)kW5KTile +
                                        kW5VecStride * 4 + 8 + 16) + 8;
// K6: the CTA's 64 keys (K and V resident, 32 KB each), 64-query Q / dO
// tiles in a 2-stage ring
constexpr int kW6Keys = 64;
constexpr int kW6Stages = 2;
constexpr int kW6Box = 64 * 128;           // a 64-row box (K, V, Q, dO)
constexpr int kW6Tile = kWBoxes * kW6Box;
constexpr size_t kW6Smem = 1024 + 2 * (size_t)kW6Tile +
                           kW6Stages * (2 * (size_t)kW6Tile +
                                        3 * kVecStride * 4 + 8 + 16) + 8
#ifdef PTT_F16
                           + kW6Keys * 4   // the float16 build's dS^T units
#endif
    ;
static_assert(kW5Smem <= 232448 && kW6Smem <= 232448,
              "the 256-wide builds fit the 227 KB a block may take");

// K5 at 128 < D <= 256: one CTA per (128-query tile, q head, batch row),
// the heaviest (last) q tiles first.  Warpgroup w < 2 owns query rows
// [64w, 64w + 64) and a 64 x 256 float32 dq; one warp of warpgroup 2
// loads Q and dO once (4 boxes each), then streams 32-key K / V tiles
// (and, with ids, the tile's key ids) into a 3-stage ring and writes each
// stage's slot: (key tile, needs the element mask), or (-1, 0) to end.
template <bool SEG>
__global__ void __launch_bounds__(kHThreads, 1)
bwd_dq_wgmma_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap dq_map,
                         const __grid_constant__ CUtensorMap seg_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ q_rng,
                         const int* __restrict__ kv_rng, int B, int Sq,
                         int Skv, int Hq, int Hkv, float scale, int causal) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* Qs = align1024(wg_smem);
  unsigned char* Os = Qs + kW5QTile;
  unsigned char* Ks = Os + kW5QTile;                     // [stage]
  unsigned char* Vs = Ks + kW5Stages * kW5KTile;         // [stage]
  int* seg_s = reinterpret_cast<int*>(Vs + kW5Stages * kW5KTile);
  int2* slot = reinterpret_cast<int2*>(seg_s + kW5Stages * kW5VecStride);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(slot + kW5Stages);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kW5Stages;

  const int n_qt = (Sq + kBig - 1) / kBig;
  const int bh = blockIdx.x % (Hq * B);
  const int qt = n_qt - 1 - blockIdx.x / (Hq * B);
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBig;
  const int offset = Skv - Sq;   // query i sees keys j <= i + offset
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kW5Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kHConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----------------------------------------------------------
    reg_dealloc<24>();
    if (tid >= 32) return;
    const int lane = tid;
    const int kv_hi = causal ? min(Skv, q0 + kBig + offset) : Skv;
    const int n_kt = kv_hi > 0 ? (kv_hi + kW5Keys - 1) / kW5Keys : 0;
    if (lane == 0) {   // Q and dO first: the ranges wait on global loads
      mbar_expect_tx(q_full, 2 * kW5QTile);
#pragma unroll
      for (int x = 0; x < kWBoxes; ++x) {
        tma_load_4d(Qs + x * kW5QBox, &q_map, q_full, 64 * x, h, q0, b);
        tma_load_4d(Os + x * kW5QBox, &do_map, q_full, 64 * x, h, q0, b);
      }
    }
    int2 qr = make_int2(0, 0);
    if constexpr (SEG) qr = big_range(q_rng, b, (Sq + kRT - 1) / kRT, qt);
    int it = 0;
    // 32 key tiles at a time, lane l deciding tile base - l
    for (int base = n_kt - 1; base >= 0; base -= 32) {
      const int j = base - lane;
      bool vis = j >= 0;
      bool masked = vis && ((causal && j * kW5Keys + kW5Keys - 1 > q0 + offset) ||
                            j * kW5Keys + kW5Keys > Skv);
      if constexpr (SEG) {
        if (vis) {
          // the range of the 64 tokens holding the tile: a superset of
          // its own, exact all the same
          const int* r = kv_rng + ((size_t)b * ((Skv + kRT - 1) / kRT) +
                                   j * kW5Keys / kRT) * 2;
          vis = r[1] >= qr.x && r[0] <= qr.y;
          masked = masked || r[0] != r[1] || qr.x != qr.y || r[0] != qr.x;
        }
      }
      unsigned todo = __ballot_sync(0xffffffffu, vis);
      const unsigned mask_bits = __ballot_sync(0xffffffffu, masked);
      if (lane != 0) continue;
      while (todo) {
        const int l = __ffs(todo) - 1;
        todo &= todo - 1;
        const int jt = base - l, k0 = jt * kW5Keys;
        const int s = it % kW5Stages;
        mbar_wait(&empty[s], ((it / kW5Stages) & 1) ^ 1);
        slot[s] = make_int2(jt, (mask_bits >> l) & 1);
        unsigned char* kd = Ks + s * kW5KTile;
        unsigned char* vd = Vs + s * kW5KTile;
        mbar_expect_tx(&full[s], 2 * kW5KTile + (SEG ? kW5Vec * 4 : 0));
#pragma unroll
        for (int x = 0; x < kWBoxes; ++x) {
          tma_load_4d(kd + x * kW5KBox, &k_map, &full[s], 64 * x, hk, k0, b);
          tma_load_4d(vd + x * kW5KBox, &v_map, &full[s], 64 * x, hk, k0, b);
        }
        if constexpr (SEG)
          tma_load_1d(seg_s + s * kW5VecStride, &seg_map, &full[s],
                      (b * Skv + k0) & ~3);
        ++it;
      }
    }
    if (lane == 0) {
      const int s = it % kW5Stages;
      mbar_wait(&empty[s], ((it / kW5Stages) & 1) ^ 1);
      slot[s] = make_int2(-1, 0);
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers -------------------------------------------------------------
  reg_alloc<240>();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int rl = wg * 64 + warp * 16 + g;   // rows rl, rl + 8 of the tile
  const int r0 = q0 + rl, r1 = r0 + 8;
  const size_t lrow = ((size_t)b * Hq + h) * Sq;
  // lse in the log2 domain; rows past Sq load nothing and store nothing
  const float ln0 = r0 < Sq ? lse[lrow + r0] * kLog2e : 0.f;
  const float ln1 = r1 < Sq ? lse[lrow + r1] * kLog2e : 0.f;
  const float dl0 = r0 < Sq ? delta[lrow + r0] : 0.f;
  const float dl1 = r1 < Sq ? delta[lrow + r1] : 0.f;
  int sq0 = 0, sq1 = 0;
  if constexpr (SEG) {
    sq0 = r0 < Sq ? seg_q[(size_t)b * Sq + r0] : 0;
    sq1 = r1 < Sq ? seg_q[(size_t)b * Sq + r1] : 0;
  }
  const float sl2 = scale * kLog2e;
  const unsigned char* qa = Qs + wg * 64 * 128;
  const unsigned char* oa = Os + wg * 64 * 128;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float sc[16], dp[16];
  uint32_t da[2][4];
#ifdef PTT_F16
  float su[2] = {-scale, -scale};   // the dS units of rows r0, r1
#endif
  // a key tile's ids start `lead` into their stage (a 1-d box's lead-in),
  // the same for every tile of the CTA
  const int lead = SEG ? (b * Skv) & 3 : 0;

  mbar_wait(q_full, 0);
  // per key tile: S = Q K^T and dP = dO V^T issued together; P once S is
  // in (the last tile's dq is then done too, and its stage is released);
  // dS once dP is in; dq += dS K issued and left in flight under the next
  // tile's products
  int cur = 0;
  for (;; ++cur) {
    const int st = cur % kW5Stages;
    mbar_wait(&full[st], (cur / kW5Stages) & 1);
    const int2 sl = slot[st];
    if (sl.x < 0) break;
    const unsigned char* kt = Ks + st * kW5KTile;
    wgmma_fence();
    issue_abt<kWBoxes>(sc, qa, kW5QBox, kt, kW5KBox);
    issue_abt<kWBoxes>(dp, oa, kW5QBox, Vs + st * kW5KTile, kW5KBox);
    wgmma_wait<1>();
    fence_regs(sc);
    if (cur > 0) mbar_arrive(&empty[(cur + kW5Stages - 1) % kW5Stages]);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      sc[i] = exp2_approx(fmaf(sc[i], sl2, -((i & 2) ? ln1 : ln0)));
    if (sl.y) {   // P = 0 on the pairs the mask hides
      const int k0 = sl.x * kW5Keys;
      const int* ids = seg_s + st * kW5VecStride + lead;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int cl = 8 * (i / 4) + 2 * c + (i & 1), col = k0 + cl;
        bool keep = col < Skv && (!causal || col <= ((i & 2) ? r1 : r0) + offset);
        if constexpr (SEG) keep = keep && ids[cl] == ((i & 2) ? sq1 : sq0);
        if (!keep) sc[i] = 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#ifdef PTT_F16
#pragma unroll
    for (int i = 0; i < 16; ++i)
      dp[i] = sc[i] * (dp[i] - ((i & 2) ? dl1 : dl0)) * su[(i >> 1) & 1];
    fence_regs(acc);   // the last tile's dq += dS K is done
    ds_fit(dp, acc, su, scale);
    fence_regs(acc);
#else
#pragma unroll
    for (int i = 0; i < 16; ++i)
      dp[i] = sc[i] * (dp[i] - ((i & 2) ? dl1 : dl0)) * scale;
#endif
    pack_a<2>(dp, da);
    wgmma_fence();
    issue_at(acc, da, kt, kW5KBox);
    wgmma_commit();
#ifdef PTT_F16
    // retired before the next tile: ptxas serialises every wgmma of the
    // kernel (C7514) when ds_fit reads an accumulator whose product is in
    // flight across the loop's back edge
    wgmma_wait<0>();
    fence_regs(acc);
#endif
  }
  wgmma_wait<0>();
  fence_regs(acc);
#ifdef PTT_F16
  ds_units_out(acc, su, scale);
#endif

  // dq through this warpgroup's rows of Q's shared memory (its last Q K^T
  // is done) and TMA stores that drop rows past Sq and columns past D
  stage_acc(Qs, acc, rl, c, kW5QBox);
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (tid == 0 && q0 + wg * 64 < Sq) {
#pragma unroll
    for (int x = 0; x < kWBoxes; ++x)
      tma_store_4d(&dq_map, Qs + x * kW5QBox + wg * 64 * 128, 64 * x, h,
                   q0 + wg * 64, b);
    tma_store_commit_wait();
  }
}

// K6 at 128 < D <= 256: one CTA per (64-key tile, kv head, batch row), the
// key tiles that see the most queries (the first) first.  A 64 x 256
// float32 dk and dv take 256 registers a thread together, more than a
// thread has, so the two consumer warpgroups split them: warpgroup 0 owns
// dV of the CTA's 64 keys, warpgroup 1 dK, both computing S^T = K Q^T (the
// products of S^T are done twice).  One warp of warpgroup 2 loads K and V
// once, then walks the G q heads of the group x the 64-query tiles at or
// below the diagonal, streaming Q, dO, lse, delta (and, with ids, the
// query ids) of each into a 2-stage ring; a stage's slot holds (the tile's
// first query, needs the element mask | q head << 1), or (-1, 0) to end.
template <bool SEG>
__global__ void __launch_bounds__(kHThreads, 1)
bwd_dkv_wgmma_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap dk_map,
                          const __grid_constant__ CUtensorMap dv_map,
                          const __grid_constant__ CUtensorMap lse_map,
                          const __grid_constant__ CUtensorMap delta_map,
                          const __grid_constant__ CUtensorMap seg_map,
                          const int* __restrict__ seg_kv,
                          const int* __restrict__ q_rng,
                          const int* __restrict__ kv_rng, int B, int Sq,
                          int Skv, int Hq, int Hkv, float scale, int causal) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* Ks = align1024(wg_smem);
  unsigned char* Vs = Ks + kW6Tile;
  unsigned char* Qs = Vs + kW6Tile;                     // [stage]
  unsigned char* Os = Qs + kW6Stages * kW6Tile;         // [stage]
  float* lse_s = reinterpret_cast<float*>(Os + kW6Stages * kW6Tile);
  float* dl_s = lse_s + kW6Stages * kVecStride;               // [stage]
  int* seg_s = reinterpret_cast<int*>(dl_s + kW6Stages * kVecStride);
  int2* slot = reinterpret_cast<int2*>(seg_s + kW6Stages * kVecStride);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(slot + kW6Stages);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kW6Stages;
#ifdef PTT_F16
  // the dS^T units of the CTA's 64 keys (kept here, not in registers: the
  // dK warpgroup has none to spare with ids)
  float* su_s = reinterpret_cast<float*>(empty + kW6Stages);
#endif

  const int bh = blockIdx.x % (Hkv * B);
  const int kt = blockIdx.x / (Hkv * B);
  const int hk = bh % Hkv, b = bh / Hkv;
  const int G = Hq / Hkv;
  const int k0 = kt * kW6Keys;
  const int offset = Skv - Sq;   // query i sees keys j <= i + offset
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kW6Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kHConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----------------------------------------------------------
    reg_dealloc<24>();
    if (tid >= 32) return;
    const int lane = tid;
    const int n_qt = (Sq + kSmall - 1) / kSmall;
    // queries i >= key - offset see the key: the first tile that can
    const int qt_lo = causal ? max(0, k0 - offset) / kSmall : 0;
    if (lane == 0) {   // K and V first: the ranges wait on global loads
      mbar_expect_tx(kv_full, 2 * kW6Tile);
#pragma unroll
      for (int x = 0; x < kWBoxes; ++x) {
        tma_load_4d(Ks + x * kW6Box, &k_map, kv_full, 64 * x, hk, k0, b);
        tma_load_4d(Vs + x * kW6Box, &v_map, kv_full, 64 * x, hk, k0, b);
      }
    }
    int2 kr = make_int2(0, 0);
    if constexpr (SEG) {
      // the CTA's 64 keys are one range
      const int* r = kv_rng + ((size_t)b * ((Skv + kRT - 1) / kRT) + kt) * 2;
      kr = make_int2(r[0], r[1]);
    }
    int it = 0;
    for (int h = hk * G; h < hk * G + G; ++h) {
      // 32 query tiles at a time, lane l deciding tile base + l
      for (int base = qt_lo; base < n_qt; base += 32) {
        const int j = base + lane, q0 = j * kSmall;
        bool vis = j < n_qt;
        bool masked = vis && ((causal && k0 + kW6Keys - 1 > q0 + offset) ||
                              q0 + kSmall > Sq || k0 + kW6Keys > Skv);
        if constexpr (SEG) {
          if (vis) {
            const int* r = q_rng + ((size_t)b * n_qt + j) * 2;
            vis = kr.y >= r[0] && kr.x <= r[1];
            masked = masked || kr.x != kr.y || r[0] != r[1] || kr.x != r[0];
          }
        }
        unsigned todo = __ballot_sync(0xffffffffu, vis);
        const unsigned mask_bits = __ballot_sync(0xffffffffu, masked);
        if (lane != 0) continue;
        while (todo) {
          const int l = __ffs(todo) - 1;
          todo &= todo - 1;
          const int qs = (base + l) * kSmall;
          const int s = it % kW6Stages;
          mbar_wait(&empty[s], ((it / kW6Stages) & 1) ^ 1);
          slot[s] = make_int2(qs, ((mask_bits >> l) & 1) | (h << 1));
          unsigned char* qd = Qs + s * kW6Tile;
          unsigned char* od = Os + s * kW6Tile;
          mbar_expect_tx(&full[s], 2 * kW6Tile + (SEG ? 3 : 2) * kVec * 4);
#pragma unroll
          for (int x = 0; x < kWBoxes; ++x) {
            tma_load_4d(qd + x * kW6Box, &q_map, &full[s], 64 * x, h, qs, b);
            tma_load_4d(od + x * kW6Box, &do_map, &full[s], 64 * x, h, qs, b);
          }
          const int row = ((b * Hq + h) * Sq + qs) & ~3;
          tma_load_1d(lse_s + s * kVecStride, &lse_map, &full[s], row);
          tma_load_1d(dl_s + s * kVecStride, &delta_map, &full[s], row);
          if constexpr (SEG)
            tma_load_1d(seg_s + s * kVecStride, &seg_map, &full[s],
                        (b * Sq + qs) & ~3);
          ++it;
        }
      }
    }
    if (lane == 0) {
      const int s = it % kW6Stages;
      mbar_wait(&empty[s], ((it / kW6Stages) & 1) ^ 1);
      slot[s] = make_int2(-1, 0);
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers -------------------------------------------------------------
  reg_alloc<240>();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int rl = warp * 16 + g;   // keys rl, rl + 8 of the CTA's 64
  const int key0 = k0 + rl, key1 = key0 + 8;
  int sk0 = 0, sk1 = 0;
  if constexpr (SEG) {
    sk0 = key0 < Skv ? seg_kv[(size_t)b * Skv + key0] : 0;
    sk1 = key1 < Skv ? seg_kv[(size_t)b * Skv + key1] : 0;
  }
  const float sl2 = scale * kLog2e;
  float acc[128];   // warpgroup 0: dV, warpgroup 1: dK
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float sc[32];
  uint32_t pa[4][4];
  // a query tile's ids start seg_lead into their stage (a 1-d box's
  // lead-in), the same for every tile of the CTA
  const int seg_lead = SEG ? (b * Sq) & 3 : 0;
  // P^T of the tile in stage st (slot sl) from S^T in p: columns are
  // queries, p[4j + e] is query 8j + 2c + (e & 1) of the tile
  auto probs = [&](float (&p)[32], int st, int2 sl) {
    // this tile's lse (of q head sl.y >> 1) starts lead in
    const int lead = ((b * Hq + (sl.y >> 1)) * Sq + sl.x) & 3;
    const float* ls = lse_s + st * kVecStride + lead;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float l0 = ls[8 * j + 2 * c] * -kLog2e;
      const float l1 = ls[8 * j + 2 * c + 1] * -kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[4 * j + e] = exp2_approx(fmaf(p[4 * j + e], sl2, (e & 1) ? l1 : l0));
    }
    if (sl.y & 1) {   // P = 0 on the pairs the mask hides
      const int* ids = seg_s + st * kVecStride + seg_lead;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int cl = 8 * (i / 4) + 2 * c + (i & 1), qi = sl.x + cl;
        const int key = (i & 2) ? key1 : key0;
        bool keep = qi < Sq && key < Skv && (!causal || key <= qi + offset);
        if constexpr (SEG) keep = keep && ids[cl] == ((i & 2) ? sk1 : sk0);
        if (!keep) p[i] = 0.f;
      }
    }
  };

  mbar_wait(kv_full, 0);
  if (wg == 0) {
    // per query tile: S^T = K Q^T; P^T once it is in; dV += P^T dO; the
    // stage is released once that is done
    for (int cur = 0;; ++cur) {
      const int st = cur % kW6Stages;
      mbar_wait(&full[st], (cur / kW6Stages) & 1);
      const int2 sl = slot[st];
      if (sl.x < 0) break;
      wgmma_fence();
      issue_abt<kWBoxes>(sc, Ks, kW6Box, Qs + st * kW6Tile, kW6Box);
      wgmma_wait<0>();
      fence_regs(sc);
      probs(sc, st, sl);
      pack_a<4>(sc, pa);
      wgmma_fence();
      issue_at(acc, pa, Os + st * kW6Tile, kW6Box);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }
  } else {
    // per query tile: S^T = K Q^T and dP^T = V dO^T issued together; P^T
    // once S^T is in, dS^T once dP^T is in; dK += dS^T Q; the stage is
    // released once that is done.  With ids dP^T is issued after P^T is
    // formed: the ids' mask beside S^T, dP^T (in flight) and dK spilled
    float dp[32];
#ifdef PTT_F16
    su_s[rl] = su_s[rl + 8] = -scale;   // keys key0, key1: unset
#endif
    for (int cur = 0;; ++cur) {
      const int st = cur % kW6Stages;
      mbar_wait(&full[st], (cur / kW6Stages) & 1);
      const int2 sl = slot[st];
      if (sl.x < 0) break;
      const unsigned char* qt = Qs + st * kW6Tile;
      const unsigned char* ot = Os + st * kW6Tile;
      wgmma_fence();
      issue_abt<kWBoxes>(sc, Ks, kW6Box, qt, kW6Box);
      if constexpr (!SEG) issue_abt<kWBoxes>(dp, Vs, kW6Box, ot, kW6Box);
      wgmma_wait<SEG ? 0 : 1>();
      fence_regs(sc);
      probs(sc, st, sl);
      if constexpr (SEG) {
        wgmma_fence();
        issue_abt<kWBoxes>(dp, Vs, kW6Box, ot, kW6Box);
      }
      wgmma_wait<0>();
      fence_regs(dp);
      const int lead = ((b * Hq + (sl.y >> 1)) * Sq + sl.x) & 3;
      const float* ds = dl_s + st * kVecStride + lead;
#ifdef PTT_F16
      float su[2] = {su_s[rl], su_s[rl + 8]};
#endif
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d0 = ds[8 * j + 2 * c], d1 = ds[8 * j + 2 * c + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#ifdef PTT_F16
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d1 : d0)) * su[e >> 1];
#else
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d1 : d0)) * scale;
#endif
      }
#ifdef PTT_F16
      ds_fit(dp, acc, su, scale);
      su_s[rl] = su[0];   // the quad's four lanes store one value
      su_s[rl + 8] = su[1];
#endif
      pack_a<4>(dp, pa);
      wgmma_fence();
      issue_at(acc, pa, qt, kW6Box);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[st]);
    }
#ifdef PTT_F16
    const float su[2] = {su_s[rl], su_s[rl + 8]};
    ds_units_out(acc, su, scale);
#endif
  }

  // both warpgroups are done with K and V: dv leaves through V's shared
  // memory, dk through K's, by TMA stores that drop rows past Skv and
  // columns past D
  named_barrier(1, kHConsumers);
  unsigned char* out = wg == 0 ? Vs : Ks;
  stage_acc(out, acc, rl, c, kW6Box);
  fence_proxy_async();
  named_barrier(2 + wg, 128);
  if (tid == 0 && k0 < Skv) {
    const CUtensorMap* m = wg == 0 ? &dv_map : &dk_map;
#pragma unroll
    for (int x = 0; x < kWBoxes; ++x)
      tma_store_4d(m, out + x * kW6Box, 64 * x, hk, k0, b);
    tma_store_commit_wait();
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

template <bool SEG>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const int* seg_q,
                            const int* seg_kv, const int* q_rng,
                            const int* kv_rng, void* dq, int B, int Sq,
                            int Skv, int Hq, int Hkv, int D, float scale,
                            int causal, cudaStream_t st) {
  CUtensorMap qm, km, vm, om, dqm, sm;
  memset(&sm, 0, sizeof(sm));
  cudaError_t e = bshd_map(&qm, q, B, Sq, Hq, kBig, D);
  if (e == cudaSuccess) e = bshd_map(&km, k, B, Skv, Hkv, kSmall, D);
  if (e == cudaSuccess) e = bshd_map(&vm, v, B, Skv, Hkv, kSmall, D);
  if (e == cudaSuccess) e = bshd_map(&om, dout, B, Sq, Hq, kBig, D);
  if (e == cudaSuccess) e = bshd_map(&dqm, dq, B, Sq, Hq, kSmall, D);
  if (e == cudaSuccess && SEG)
    e = flat_map(&sm, CU_TENSOR_MAP_DATA_TYPE_INT32, seg_kv, (size_t)B * Skv,
                 kVec);
  if (e != cudaSuccess) return e;
  auto kernel = bwd_dq_wgmma_kernel<SEG>;
  e = allow_smem(kernel, kHSmem);
  if (e != cudaSuccess) return e;
  const long long ctas = (long long)((Sq + kBig - 1) / kBig) * Hq * B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)ctas, kHThreads, kHSmem, st>>>(
      qm, km, vm, om, dqm, sm, lse, delta, seg_q, q_rng, kv_rng, B, Sq, Skv,
      Hq, Hkv, scale, causal);
  return cudaSuccess;
}

template <bool SEG>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const int* seg_q,
                             const int* seg_kv, const int* q_rng,
                             const int* kv_rng, void* dk, void* dv, int B,
                             int Sq, int Skv, int Hq, int Hkv, int D,
                             float scale, int causal, cudaStream_t st) {
  CUtensorMap qm, km, vm, om, dkm, dvm, lm, dlm, sm;
  memset(&sm, 0, sizeof(sm));
  cudaError_t e = bshd_map(&qm, q, B, Sq, Hq, kSmall, D);
  if (e == cudaSuccess) e = bshd_map(&km, k, B, Skv, Hkv, kBig, D);
  if (e == cudaSuccess) e = bshd_map(&vm, v, B, Skv, Hkv, kBig, D);
  if (e == cudaSuccess) e = bshd_map(&om, dout, B, Sq, Hq, kSmall, D);
  if (e == cudaSuccess) e = bshd_map(&dkm, dk, B, Skv, Hkv, kSmall, D);
  if (e == cudaSuccess) e = bshd_map(&dvm, dv, B, Skv, Hkv, kSmall, D);
  const size_t rows = (size_t)B * Hq * Sq;
  if (e == cudaSuccess)
    e = flat_map(&lm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, lse, rows, kVec);
  if (e == cudaSuccess)
    e = flat_map(&dlm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, delta, rows, kVec);
  if (e == cudaSuccess && SEG)
    e = flat_map(&sm, CU_TENSOR_MAP_DATA_TYPE_INT32, seg_q, (size_t)B * Sq,
                 kVec);
  if (e != cudaSuccess) return e;
  if (rows > 0x7fffffffULL) return cudaErrorInvalidValue;
  auto kernel = bwd_dkv_wgmma_kernel<SEG>;
  e = allow_smem(kernel, kHSmem);
  if (e != cudaSuccess) return e;
  const long long ctas = (long long)((Skv + kBig - 1) / kBig) * Hkv * B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)ctas, kHThreads, kHSmem, st>>>(
      qm, km, vm, om, dkm, dvm, lm, dlm, sm, seg_kv, q_rng, kv_rng, B, Sq,
      Skv, Hq, Hkv, scale, causal);
  return cudaSuccess;
}

template <bool SEG>
cudaError_t launch_dq_wide(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const int* seg_q,
                           const int* seg_kv, const int* q_rng,
                           const int* kv_rng, void* dq, int B, int Sq,
                           int Skv, int Hq, int Hkv, int D, float scale,
                           int causal, cudaStream_t st) {
  CUtensorMap qm, km, vm, om, dqm, sm;
  memset(&sm, 0, sizeof(sm));
  cudaError_t e = bshd_map(&qm, q, B, Sq, Hq, kBig, D);
  if (e == cudaSuccess) e = bshd_map(&km, k, B, Skv, Hkv, kW5Keys, D);
  if (e == cudaSuccess) e = bshd_map(&vm, v, B, Skv, Hkv, kW5Keys, D);
  if (e == cudaSuccess) e = bshd_map(&om, dout, B, Sq, Hq, kBig, D);
  if (e == cudaSuccess) e = bshd_map(&dqm, dq, B, Sq, Hq, kSmall, D);
  if (e == cudaSuccess && SEG)
    e = flat_map(&sm, CU_TENSOR_MAP_DATA_TYPE_INT32, seg_kv, (size_t)B * Skv,
                 kW5Vec);
  if (e != cudaSuccess) return e;
  auto kernel = bwd_dq_wgmma_wide_kernel<SEG>;
  e = allow_smem(kernel, kW5Smem);
  if (e != cudaSuccess) return e;
  const long long ctas = (long long)((Sq + kBig - 1) / kBig) * Hq * B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)ctas, kHThreads, kW5Smem, st>>>(
      qm, km, vm, om, dqm, sm, lse, delta, seg_q, q_rng, kv_rng, B, Sq, Skv,
      Hq, Hkv, scale, causal);
  return cudaSuccess;
}

template <bool SEG>
cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const int* seg_q,
                            const int* seg_kv, const int* q_rng,
                            const int* kv_rng, void* dk, void* dv, int B,
                            int Sq, int Skv, int Hq, int Hkv, int D,
                            float scale, int causal, cudaStream_t st) {
  CUtensorMap qm, km, vm, om, dkm, dvm, lm, dlm, sm;
  memset(&sm, 0, sizeof(sm));
  cudaError_t e = bshd_map(&qm, q, B, Sq, Hq, kSmall, D);
  if (e == cudaSuccess) e = bshd_map(&km, k, B, Skv, Hkv, kW6Keys, D);
  if (e == cudaSuccess) e = bshd_map(&vm, v, B, Skv, Hkv, kW6Keys, D);
  if (e == cudaSuccess) e = bshd_map(&om, dout, B, Sq, Hq, kSmall, D);
  if (e == cudaSuccess) e = bshd_map(&dkm, dk, B, Skv, Hkv, kW6Keys, D);
  if (e == cudaSuccess) e = bshd_map(&dvm, dv, B, Skv, Hkv, kW6Keys, D);
  const size_t rows = (size_t)B * Hq * Sq;
  if (e == cudaSuccess)
    e = flat_map(&lm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, lse, rows, kVec);
  if (e == cudaSuccess)
    e = flat_map(&dlm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, delta, rows, kVec);
  if (e == cudaSuccess && SEG)
    e = flat_map(&sm, CU_TENSOR_MAP_DATA_TYPE_INT32, seg_q, (size_t)B * Sq,
                 kVec);
  if (e != cudaSuccess) return e;
  if (rows > 0x7fffffffULL) return cudaErrorInvalidValue;
  auto kernel = bwd_dkv_wgmma_wide_kernel<SEG>;
  e = allow_smem(kernel, kW6Smem);
  if (e != cudaSuccess) return e;
  const long long ctas = (long long)((Skv + kW6Keys - 1) / kW6Keys) * Hkv * B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)ctas, kHThreads, kW6Smem, st>>>(
      qm, km, vm, om, dkm, dvm, lm, dlm, sm, seg_kv, q_rng, kv_rng, B, Sq,
      Skv, Hq, Hkv, scale, causal);
  return cudaSuccess;
}

// the bf16 head dims of the Hopper kernels: the tiles stay 128 wide up to
// D 128 and are 256 wide above (wide_head_dim), the maps have D columns (a
// row stride of D * 2 bytes, a multiple of 16)
bool wgmma_head_dim(int D) { return D >= 8 && D <= kBig && D % 8 == 0; }
bool wide_head_dim(int D) { return D > kBig && D <= kWide && D % 8 == 0; }

template <int D>
cudaError_t launch_dq_f32(const float* q, const float* k, const float* v,
                          const float* dout, const float* lse,
                          const float* delta, const int* seg_q,
                          const int* seg_kv, float* dq, int B, int Sq,
                          int Skv, int Hq, int Hkv, float scale, int causal,
                          cudaStream_t st) {
  const dim3 grid((Sq + kTile - 1) / kTile, Hq, B);
  bwd_dq_f32_kernel<D><<<grid, kF32Threads, 0, st>>>(
      q, k, v, dout, lse, delta, seg_q, seg_kv, dq, Sq, Skv, Hq, Hkv, scale,
      causal);
  return cudaSuccess;
}

// the split kernels' dynamic shared memory: two 64 x D float tiles and
// three 64-entry rows (K5 uses one)
template <int D>
constexpr int split_smem() {
  return (2 * kTile * D + 3 * kTile) * 4;
}

template <typename Kernel>
cudaError_t split_attributes(Kernel kernel, int smem) {
  // above 48 KB only after opting in (per device, so on every launch)
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
cudaError_t launch_dq_f32_split(const float* q, const float* k,
                                const float* v, const float* dout,
                                const float* lse, const float* delta,
                                const int* seg_q, const int* seg_kv,
                                float* dq, int B, int Sq, int Skv, int Hq,
                                int Hkv, float scale, int causal,
                                cudaStream_t st) {
  constexpr int smem = split_smem<D>();
  const cudaError_t e = split_attributes(bwd_dq_f32_split_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kTile - 1) / kTile, Hq, B);
  bwd_dq_f32_split_kernel<D><<<grid, kSplitThreads, smem, st>>>(
      q, k, v, dout, lse, delta, seg_q, seg_kv, dq, Sq, Skv, Hq, Hkv, scale,
      causal);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dkv_f32_split(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 const float* lse, const float* delta,
                                 const int* seg_q, const int* seg_kv,
                                 float* dk, float* dv, int B, int Sq,
                                 int Skv, int Hq, int Hkv, float scale,
                                 int causal, cudaStream_t st) {
  constexpr int smem = split_smem<D>();
  const cudaError_t e = split_attributes(bwd_dkv_f32_split_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Skv + kTile - 1) / kTile, Hkv, B);
  bwd_dkv_f32_split_kernel<D><<<grid, kSplitThreads, smem, st>>>(
      q, k, v, dout, lse, delta, seg_q, seg_kv, dk, dv, Sq, Skv, Hq, Hkv,
      scale, causal);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dkv_f32(const float* q, const float* k, const float* v,
                           const float* dout, const float* lse,
                           const float* delta, const int* seg_q,
                           const int* seg_kv, float* dk, float* dv, int B,
                           int Sq, int Skv, int Hq, int Hkv, float scale,
                           int causal, cudaStream_t st) {
  const dim3 grid((Skv + kTile - 1) / kTile, Hkv, B);
  bwd_dkv_f32_kernel<D><<<grid, kF32Threads, 0, st>>>(
      q, k, v, dout, lse, delta, seg_q, seg_kv, dk, dv, Sq, Skv, Hq, Hkv,
      scale, causal);
  return cudaSuccess;
}

#ifndef PTT_F16
// the runtime-D split kernels' shared memory at head dim D
int split_rt_smem(int D) { return (2 * kTile * D + 3 * kTile) * 4; }

// K5 at a float32 head dim D its constant-D instances leave out: a quad a
// row up to D 128, an octet above
cudaError_t launch_dq_f32_rt(const float* q, const float* k, const float* v,
                             const float* dout, const float* lse,
                             const float* delta, const int* seg_q,
                             const int* seg_kv, float* dq, int B, int Sq,
                             int Skv, int Hq, int Hkv, int D, float scale,
                             int causal, cudaStream_t st) {
  const bool wide = D > 128;
  const auto kernel = wide ? bwd_dq_f32_rt_kernel<8, 8>
                           : bwd_dq_f32_rt_kernel<4, 8>;
  const int rows = wide ? Group<8>::kRows : Group<4>::kRows;
  const int smem = split_rt_smem(D);
  const cudaError_t e = split_attributes(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + rows - 1) / rows, Hq, B);
  kernel<<<grid, kSplitThreads, smem, st>>>(q, k, v, dout, lse, delta, seg_q,
                                            seg_kv, dq, Sq, Skv, Hq, Hkv, D,
                                            scale, causal);
  return cudaSuccess;
}

// K6 likewise
cudaError_t launch_dkv_f32_rt(const float* q, const float* k, const float* v,
                              const float* dout, const float* lse,
                              const float* delta, const int* seg_q,
                              const int* seg_kv, float* dk, float* dv, int B,
                              int Sq, int Skv, int Hq, int Hkv, int D,
                              float scale, int causal, cudaStream_t st) {
  const bool wide = D > 128;
  const auto kernel = wide ? bwd_dkv_f32_rt_kernel<8, 8>
                           : bwd_dkv_f32_rt_kernel<4, 8>;
  const int rows = wide ? Group<8>::kRows : Group<4>::kRows;
  const int smem = split_rt_smem(D);
  const cudaError_t e = split_attributes(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Skv + rows - 1) / rows, Hkv, B);
  kernel<<<grid, kSplitThreads, smem, st>>>(q, k, v, dout, lse, delta, seg_q,
                                            seg_kv, dk, dv, Sq, Skv, Hq, Hkv,
                                            D, scale, causal);
  return cudaSuccess;
}
#endif

}  // namespace

// K5: dq (B, Sq, Hq, D) in q's dtype.  dtype: the library's 16-bit code
// (kE16Code: 0 = bfloat16, or 2 = float16 in the library compiled with
// -DPTT_F16; any D <= 256 with D % 8 == 0: the Hopper kernels, 128-wide
// tiles up to 128, 256-wide above), 1 = float32 (the same head dims on
// the CUDA cores: D = 16, 64 or 72 one thread a row, D = 128 a quad a row,
// any other D a quad (D <= 128) or an octet a row at a runtime D; not in
// the float16 library): K2's head dims.  Any other pair, or only one of seg_q /
// seg_kv, returns cudaErrorInvalidValue.  Tensors contiguous and 16-byte
// aligned (seg_q / seg_kv too).  With segment ids the 16-bit build also
// takes q_rng (B, ceil(Sq / 64), 2) and kv_rng (B, ceil(Skv / 64), 2):
// the int32 [min, max] id of every 64 tokens (segment_tile_ranges); the
// float32 build ignores them.  Returns cudaGetLastError().
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* seg_q, const void* seg_kv,
                                      const void* q_rng, const void* kv_rng,
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
  const int* qr = static_cast<const int*>(q_rng);
  const int* kr = static_cast<const int*>(kv_rng);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fo = static_cast<const float*>(dout);
  float* fdq = static_cast<float*>(dq);
  cudaError_t e;
  if (dtype == kE16Code && wide_head_dim(D) && sq != nullptr)
    e = (qr == nullptr || kr == nullptr)
            ? cudaErrorInvalidValue
            : launch_dq_wide<true>(q, k, v, dout, l, dl, sq, skv, qr, kr, dq,
                                   B, Sq, Skv, Hq, Hkv, D, scale, causal, st);
  else if (dtype == kE16Code && wide_head_dim(D))
    e = launch_dq_wide<false>(q, k, v, dout, l, dl, nullptr, nullptr,
                              nullptr, nullptr, dq, B, Sq, Skv, Hq, Hkv, D,
                              scale, causal, st);
  else if (dtype == kE16Code && !wgmma_head_dim(D))
    e = cudaErrorInvalidValue;
  else if (dtype == kE16Code && sq != nullptr)
    e = (qr == nullptr || kr == nullptr)
            ? cudaErrorInvalidValue
            : launch_dq_wgmma<true>(q, k, v, dout, l, dl, sq, skv, qr, kr, dq,
                                    B, Sq, Skv, Hq, Hkv, D, scale, causal, st);
  else if (dtype == kE16Code)
    e = launch_dq_wgmma<false>(q, k, v, dout, l, dl, nullptr, nullptr,
                               nullptr, nullptr, dq, B, Sq, Skv, Hq, Hkv, D,
                               scale, causal, st);
#ifndef PTT_F16
  else if (dtype == 1 && D == 16)
    e = launch_dq_f32<16>(fq, fk, fv, fo, l, dl, sq, skv, fdq, B, Sq, Skv, Hq,
                          Hkv, scale, causal, st);
  else if (dtype == 1 && D == 64)
    e = launch_dq_f32<64>(fq, fk, fv, fo, l, dl, sq, skv, fdq, B, Sq, Skv, Hq,
                          Hkv, scale, causal, st);
  else if (dtype == 1 && D == 72)
    e = launch_dq_f32<72>(fq, fk, fv, fo, l, dl, sq, skv, fdq, B, Sq, Skv, Hq,
                          Hkv, scale, causal, st);
  else if (dtype == 1 && D == 128)
    e = launch_dq_f32_split<128>(fq, fk, fv, fo, l, dl, sq, skv, fdq, B, Sq,
                                 Skv, Hq, Hkv, scale, causal, st);
  else if (dtype == 1 && (wgmma_head_dim(D) || wide_head_dim(D)))
    e = launch_dq_f32_rt(fq, fk, fv, fo, l, dl, sq, skv, fdq, B, Sq, Skv, Hq,
                         Hkv, D, scale, causal, st);
#endif
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// K6: dk, dv (B, Skv, Hkv, D) in k's dtype, each summed over the GQA
// group of its KV head.  Arguments and refusals as K5's.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* seg_q, const void* seg_kv,
                                       const void* q_rng, const void* kv_rng,
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
  const int* qr = static_cast<const int*>(q_rng);
  const int* kr = static_cast<const int*>(kv_rng);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fo = static_cast<const float*>(dout);
  float* fdk = static_cast<float*>(dk);
  float* fdv = static_cast<float*>(dv);
  cudaError_t e;
  if (dtype == kE16Code && wide_head_dim(D) && sq != nullptr)
    e = (qr == nullptr || kr == nullptr)
            ? cudaErrorInvalidValue
            : launch_dkv_wide<true>(q, k, v, dout, l, dl, sq, skv, qr, kr,
                                    dk, dv, B, Sq, Skv, Hq, Hkv, D, scale,
                                    causal, st);
  else if (dtype == kE16Code && wide_head_dim(D))
    e = launch_dkv_wide<false>(q, k, v, dout, l, dl, nullptr, nullptr,
                               nullptr, nullptr, dk, dv, B, Sq, Skv, Hq, Hkv,
                               D, scale, causal, st);
  else if (dtype == kE16Code && !wgmma_head_dim(D))
    e = cudaErrorInvalidValue;
  else if (dtype == kE16Code && sq != nullptr)
    e = (qr == nullptr || kr == nullptr)
            ? cudaErrorInvalidValue
            : launch_dkv_wgmma<true>(q, k, v, dout, l, dl, sq, skv, qr, kr,
                                     dk, dv, B, Sq, Skv, Hq, Hkv, D, scale,
                                     causal, st);
  else if (dtype == kE16Code)
    e = launch_dkv_wgmma<false>(q, k, v, dout, l, dl, nullptr, nullptr,
                                nullptr, nullptr, dk, dv, B, Sq, Skv, Hq,
                                Hkv, D, scale, causal, st);
#ifndef PTT_F16
  else if (dtype == 1 && D == 16)
    e = launch_dkv_f32<16>(fq, fk, fv, fo, l, dl, sq, skv, fdk, fdv, B, Sq,
                           Skv, Hq, Hkv, scale, causal, st);
  else if (dtype == 1 && D == 64)
    e = launch_dkv_f32<64>(fq, fk, fv, fo, l, dl, sq, skv, fdk, fdv, B, Sq,
                           Skv, Hq, Hkv, scale, causal, st);
  else if (dtype == 1 && D == 72)
    e = launch_dkv_f32<72>(fq, fk, fv, fo, l, dl, sq, skv, fdk, fdv, B, Sq,
                           Skv, Hq, Hkv, scale, causal, st);
  else if (dtype == 1 && D == 128)
    e = launch_dkv_f32_split<128>(fq, fk, fv, fo, l, dl, sq, skv, fdk, fdv,
                                  B, Sq, Skv, Hq, Hkv, scale, causal, st);
  else if (dtype == 1 && (wgmma_head_dim(D) || wide_head_dim(D)))
    e = launch_dkv_f32_rt(fq, fk, fv, fo, l, dl, sq, skv, fdk, fdv, B, Sq,
                          Skv, Hq, Hkv, D, scale, causal, st);
#endif
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
