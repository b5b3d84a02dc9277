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
// 989 TFLOP/s bf16 tensor cores (float32: 165 TFLOP/s, below); with packed
// documents few pairs are visible and the bytes bind.  Bodies at K2's
// head dims (any other pair is refused):
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
//   * float32 at any D <= 256 with D % 8 == 0 (the tiny model's 16,
//     float32 DiTs' 64 / 72, the reference's float32 defaults at 128, a
//     Gemma-2B-wide Llama's 256): one body for both kernels and every D,
//     in three TF32 passes on the tensor cores (mma_tf32.cuh: each operand
//     split into a TF32 hi and lo, lo hi + hi lo + hi hi on mma.sync
//     m16n8k8 into float32; the dropped lo lo is ~2^-22 of a product).  It
//     replaces CUDA-core bodies (a row's dot products over 1, 4 or 8
//     threads and their shuffles, one FMA per shared-memory read, loads not
//     overlapped with compute) that ran 9-12x their bound.  Bound:
//     operations, 14 D FLOPs a visible pair at a third of the 494.7 TFLOP/s
//     TF32 rate, 165 TFLOP/s (the CUDA cores' 67 is 2.5x slower).
//     mma.sync, not wgmma: wgmma takes TF32 only K-major, and dq = dS K,
//     dV = P^T dO and dK = dS^T Q read K, dO and Q MN-major (a transposed
//     copy in shared memory each), and its B operand comes only from
//     shared memory, where the lo half would need a copy of its own;
//     mma.sync keeps both operands in registers, where the split is made,
//     and a scalar fragment load reads any layout.  A CTA is 8 warps in row
//     groups of 16 rows: K5 128 queries (8 groups of one warp) up to D 128
//     and 32 (2 groups of 4) above, with Q and dO resident; K6 64 keys (4
//     groups of 2) up to D 128 and 32 above, with K and V resident, walking
//     the G q heads x the 32-query tiles at or below the diagonal.  32-row
//     tiles of the other side (K5 K / V, K6 Q / dO) stream by 16-byte
//     cp.async into a ring of 3 stages (2 where shared memory is short),
//     the next tiles' copies in flight under this one's products.  Tiles
//     sit in shared memory as float32 rows D + 4 floats apart, so the
//     scalar fragment loads hit 32 distinct banks.
//       - phase A: the warps of a row group split the tile's 32 columns;
//         each forms S and dP of its 16 rows x its slice (summed over D in
//         partials of 32 columns), then P and dS in float32 (expf; masked
//         pairs 0, so no exp(-inf - lse)), and writes them to shared memory
//         in C-fragment order;
//       - phase B: each warp reads its row group's fragments back as the A
//         operand of its product (the k order permuted within each step of
//         8 and B's rows read in that order: no shuffle): K5 all (D <= 128)
//         or a quarter of dq's columns, K6 dV += P^T dO or dK += dS^T Q
//         over all (D <= 128) or half of the columns.  A warp's column
//         count is an instance's constant (CS tiles of 8, the least that
//         covers its share of D): the products' loop has no guard, and the
//         columns past D it forms from whatever lies beyond D in shared
//         memory are never stored.
//     Each 64-row block of streamed rows is summed apart and added to the
//     running sum (K6: a 64-query tile of one q head, as the reference's
//     block dots, flash_attention.py:336-341; one register summed over G x
//     Sq terms in turn lay up to 2.2x the 1e-5 bar from float64 at B 4 x
//     2048), and with ids every tile whose id range misses the CTA's is
//     skipped.  Budgets: K6 at D 128 (64 keys): K / V 67,584 bytes, 3
//     stages of Q / dO 101,376, P / dS 16,384 (185,344 in all); dk and dv
//     with their tile sums 128 float32 registers a thread (249 in all, 0
//     spilled); at D 256 (32 keys): 66,560 + 2 x 66,560 + 8,192 (207,872),
//     each warp a half of dK or of dV.  K5 at D 128: Q / dO 135,168, 2
//     stages 67,584, dS 16,384 (219,136), dq and its tile sum 128
//     registers (255).  What holds them back: mma.sync's TF32 rate on an
//     H100 is 324 TFLOP/s (chip_mma_rate.py), so three passes could run
//     at 108, and these kernels reach a quarter of that.  Phase A's S and
//     dP take most of a tile's time; 8 warps an SM (registers, shared
//     memory) hide little of the loads' and products' latency; and above
//     D 128 shared memory admits 32 rows a CTA, so every streamed byte
//     serves 32 rows and the 4 warps of a row group each split the same 16
//     rows' fragments.  A wgmma body on pre-split hi / lo tiles is the
//     next step (ROADMAP).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "sm90.cuh"

namespace {

using namespace ptt;

#ifndef PTT_F16
// ---------------------------------------------------------------------------
// float32: K5 / K6 in three TF32 passes on the tensor cores (mma.sync
// m16n8k8, mma_tf32.cuh), one body for every D <= 256 with D % 8 == 0
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 256;    // 8 warps
constexpr int kTcNS = 32;          // streamed rows a tile: K5 keys, K6 queries
constexpr int kTcNT = kTcNS / 8;   // their k steps in phase B's products
constexpr int kTcSum = 64;         // streamed rows a tile sum
constexpr int kTcChunk = 4;        // k steps (32 columns of D) an S / dP sum

// the C entries' arguments, passed to the kernels by value
struct TcArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  const int* seg_q;
  const int* seg_kv;
  const int* q_rng;
  const int* kv_rng;
  float* o1;   // K5: dq; K6: dk
  float* o2;   // K6: dv
  int Sq, Skv, Hq, Hkv, D;
  float scale;
  int causal;
};

// a tile's row stride in floats: D + 4, so that stride / 4 is odd (D % 8
// == 0) and the fragment loads of 8 rows x 4 columns (phase A) and of 4
// row pairs x 8 columns (phase B's B operand) hit 32 distinct banks
__host__ __device__ constexpr int tc_ld(int D) { return D + 4; }

// a CTA's dynamic shared memory: two resident tiles of BR rows, ST stages
// of two streamed tiles of kTcNS rows, and the exchange of dS (K6: P too)
__host__ __device__ constexpr int tc_smem(bool dkv, int br, int st, int D) {
  return (2 * br * tc_ld(D) + st * 2 * kTcNS * tc_ld(D) +
          (dkv ? 2 : 1) * br * kTcNS) * 4;
}

// cp.async of rows [r0, r0 + n) of head h of a (B, S, H, D) float32 tensor
// into a tile of rows tc_ld(D) apart, rows at or past S zero
__device__ __forceinline__ void tc_stage(const float* __restrict__ src,
                                         float* dst, int b, int r0, int n,
                                         int S, int H, int h, int D,
                                         int tid) {
  const int c4 = D / 4, ld = tc_ld(D);
  for (int idx = tid; idx < n * c4; idx += kTcThreads) {
    const int r = idx / c4, c = idx - r * c4, gr = r0 + r;
    const bool in = gr < S;
    cp_async16(dst + r * ld + 4 * c,
               src + (((size_t)b * S + (in ? gr : 0)) * H + h) * D + 4 * c,
               in ? 16 : 0);
  }
}

// acc[j] += X Y_j^T over one k step of 8 columns: X the warp's 16 rows, Y_j
// the 8 streamed rows of column tile j; x and y point at the lane's (row g,
// column t) of the step in X and in Y_0
template <int NTA>
__device__ __forceinline__ void tc_scores(float (&acc)[NTA][4],
                                          const float* x, const float* y,
                                          int ld) {
  uint32_t ah[4], al[4];
  split_tf32(x[0], ah[0], al[0]);
  split_tf32(x[8 * ld], ah[1], al[1]);
  split_tf32(x[4], ah[2], al[2]);
  split_tf32(x[8 * ld + 4], ah[3], al[3]);
#pragma unroll
  for (int j = 0; j < NTA; ++j) {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(y[j * 8 * ld], bh0, bl0);
    split_tf32(y[j * 8 * ld + 4], bh1, bl1);
    mma_3xtf32(acc[j], ah, al, bh0, bh1, bl0, bl1);
  }
}

// The body of both kernels.  K5 (DKV false): a CTA's rows are BR queries of
// q head blockIdx.y, its streamed tiles the keys of their KV head; K6: BR
// keys of KV head blockIdx.y, the streamed tiles the queries of the
// group's G q heads in turn.  X1 / X2 are the resident rows (K5 Q / dO, K6
// K / V), Y1 / Y2 the streamed ones (K5 K / V, K6 Q / dO).  Each warp owns
// 16 rows (row group rg) and, of the WPR warps sharing them:
//   phase A: the slice wi of the tile's 32 streamed columns: S = X1 Y1^T
//     and dP = X2 Y2^T, each summed in partials of 4 k steps, then P and dS
//     (K5 with lse / delta of its rows in registers, K6 of the columns),
//     written to shared memory in C-fragment order;
//   phase B: K5 the column chunk wi of dq += dS K; K6 dV += P^T dO (the
//     first WPR / 2 warps) or dK += dS^T Q (the rest), in column chunks of
//     CS tiles: the exchanged C fragments are the A operand under the
//     permuted k order of mma_tf32.cuh.
// Phase B sums each 64-row block of streamed rows apart and adds the
// block's sum to the output's running sum (K6: a 64-query tile of one q
// head, as the reference's block dots; K5: 64 keys).
template <bool DKV, int BR, int ST, int CS>
__device__ __forceinline__ void tc_body(const TcArgs& a) {
  constexpr int RG = BR / 16;              // row groups, 16 rows each
  constexpr int WPR = 8 / RG;              // warps a row group
  constexpr int NTA = kTcNS / WPR / 8;     // phase A: column tiles a warp
  static_assert(!DKV || WPR >= 2, "K6 splits dV and dK between warps");
  extern __shared__ __align__(16) float tsm[];
  const int D = a.D, ld = tc_ld(D), nk = D / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / WPR, wi = warp % WPR;
  const int G = a.Hq / a.Hkv, off = a.Skv - a.Sq, b = blockIdx.z;
  const bool seg = a.seg_q != nullptr;
  // rows: K5 queries of q head hr, K6 keys of KV head hr
  const int hr = blockIdx.y, hk = DKV ? hr : hr / G;
  const int Sr = DKV ? a.Skv : a.Sq, Ss = DKV ? a.Sq : a.Skv;
  const int Hr = DKV ? a.Hkv : a.Hq, Hs = DKV ? a.Hq : a.Hkv;
  // K5 starts the heaviest (last) query tiles, K6 the heaviest (first) keys
  const int r0 = (DKV ? blockIdx.x : gridDim.x - 1 - blockIdx.x) * BR;
  const int r_last = min(Sr, r0 + BR) - 1;
  // the walk: tiles u < nT of kTcNS streamed rows.  K5: keys up to the
  // last one a row sees; K6: u = gi nQ + (query tile - qt_lo) over the G q
  // heads, from the first query tile that sees a key of the CTA
  int nT, nQ = 1, qt_lo = 0;
  if (DKV) {
    const int s_lo = a.causal ? max(0, r0 - off) : 0;
    qt_lo = s_lo / kTcNS;
    nQ = max(0, (a.Sq + kTcNS - 1) / kTcNS - qt_lo);
    nT = G * nQ;
  } else {
    const int hi = a.causal ? min(a.Skv, r_last + off + 1) : a.Skv;
    nT = hi > 0 ? (hi + kTcNS - 1) / kTcNS : 0;
  }
  const int ns_blk = (Ss + kTcSum - 1) / kTcSum;
  auto tile_s0 = [&](int u) {
    return (DKV ? qt_lo + u % nQ : u) * kTcNS;
  };
  auto tile_head = [&](int u) { return DKV ? hk * G + u / nQ : hk; };
  auto block_of = [&](int u) {
    return (DKV ? u / nQ : 0) * ns_blk + tile_s0(u) / kTcSum;
  };
  // with ids, tiles whose id range misses the CTA's are skipped
  int2 rr = make_int2(0, 0);
  if (seg)
    rr = id_range(DKV ? a.kv_rng : a.q_rng, b,
                  (Sr + kIdRange - 1) / kIdRange, r0, r_last);
  auto live = [&](int u) {
    if (!seg) return true;
    const int s0 = tile_s0(u);
    const int2 xr = id_range(DKV ? a.q_rng : a.kv_rng, b,
                             (Ss + kIdRange - 1) / kIdRange, s0,
                             min(Ss, s0 + kTcNS) - 1);
    return xr.y >= rr.x && xr.x <= rr.y;
  };
  auto next_live = [&](int u) {
    while (u < nT && !live(u)) ++u;
    return u;
  };

  float* X1 = tsm;                        // [BR][ld]
  float* X2 = X1 + BR * ld;
  float* ring = X2 + BR * ld;             // ST x {Y1, Y2} [kTcNS][ld]
  float4* xP = reinterpret_cast<float4*>(ring + ST * 2 * kTcNS * ld);
  float4* xS = DKV ? xP + BR * kTcNS / 4 : xP;   // [RG][kTcNT][32] float4
  auto load_tile = [&](int u, int slot) {
    float* y = ring + slot * 2 * kTcNS * ld;
    const int s0 = tile_s0(u), h = tile_head(u);
    tc_stage(DKV ? a.q : a.k, y, b, s0, kTcNS, Ss, Hs, h, D, tid);
    tc_stage(DKV ? a.dout : a.v, y + kTcNS * ld, b, s0, kTcNS, Ss, Hs, h, D,
             tid);
  };

  // the lane's rows rA and rA + 8: K5 their lse, delta; with ids their ids
  const int rA = r0 + rg * 16 + g;
  float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
  int sr[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rA + 8 * i;
    if (row >= Sr) continue;
    if (!DKV) {
      const size_t li = ((size_t)b * a.Hq + hr) * a.Sq + row;
      lr[i] = __ldg(a.lse + li);
      dr[i] = __ldg(a.delta + li);
    }
    if (seg)
      sr[i] = __ldg(DKV ? a.seg_kv + (size_t)b * a.Skv + row
                        : a.seg_q + (size_t)b * a.Sq + row);
  }
  // phase B's product: K6 role 0 dV (A = P, B = dO), role 1 dK (dS, Q)
  constexpr int HALF = WPR > 1 ? WPR / 2 : 1;   // K6: warps a role
  const int role = DKV ? wi / HALF : 1;
  const int chunk = DKV ? wi % HALF : wi;
  // the warp's CS column tiles of its output, those past D formed from
  // whatever lies past the streamed rows' D columns and never stored
  const int n_lo = chunk * CS, n_cnt = max(0, min(CS, nk - n_lo));
  const float4* xA = role == 0 ? xP : xS;
  float acc[CS][4], tsum[CS][4];
#pragma unroll
  for (int j = 0; j < CS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = tsum[j][e] = 0.f;

  int cur = next_live(0);
  if (cur < nT) {
    tc_stage(DKV ? a.k : a.q, X1, b, r0, BR, Sr, Hr, hr, D, tid);
    tc_stage(DKV ? a.v : a.dout, X2, b, r0, BR, Sr, Hr, hr, D, tid);
  }
  int fetch = cur;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (fetch < nT) {
      load_tile(fetch, s);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
  }
  int slot = 0;
  while (cur < nT) {
    cp_async_wait<ST - 2>();
    __syncthreads();   // tile cur is in; the last tile's readers are done
    if (fetch < nT) {
      load_tile(fetch, slot == 0 ? ST - 1 : slot - 1);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
    const float* Y1 = ring + slot * 2 * kTcNS * ld;
    const float* Y2 = Y1 + kTcNS * ld;
    const int s0 = tile_s0(cur), hs = tile_head(cur);
    const int c0 = wi * NTA * 8;   // the warp's slice of the tile's columns
    // ---- phase A: S and dP of the slice, summed over D in partials of
    // kTcChunk k steps (the last one shorter where D % 32 != 0)
    float s[NTA][4], dp[NTA][4];
#pragma unroll
    for (int j = 0; j < NTA; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    {
      const float* x1 = X1 + (rg * 16 + g) * ld + t;
      const float* x2 = X2 + (rg * 16 + g) * ld + t;
      const float* y1 = Y1 + (c0 + g) * ld + t;
      const float* y2 = Y2 + (c0 + g) * ld + t;
      for (int k0 = 0; k0 < nk; k0 += kTcChunk) {
        float ts[NTA][4], tp[NTA][4];
#pragma unroll
        for (int j = 0; j < NTA; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ts[j][e] = tp[j][e] = 0.f;
        if (k0 + kTcChunk <= nk) {
#pragma unroll
          for (int kk = k0; kk < k0 + kTcChunk; ++kk) {
            tc_scores<NTA>(ts, x1 + 8 * kk, y1 + 8 * kk, ld);
            tc_scores<NTA>(tp, x2 + 8 * kk, y2 + 8 * kk, ld);
          }
        } else {
          for (int kk = k0; kk < nk; ++kk) {
            tc_scores<NTA>(ts, x1 + 8 * kk, y1 + 8 * kk, ld);
            tc_scores<NTA>(tp, x2 + 8 * kk, y2 + 8 * kk, ld);
          }
        }
#pragma unroll
        for (int j = 0; j < NTA; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] += ts[j][e];
            dp[j][e] += tp[j][e];
          }
      }
    }
    // then P and dS, 0 where masked (no exp(-inf - lse))
#pragma unroll
    for (int j = 0; j < NTA; ++j) {
      // the lane's two columns of tile j: K6 their lse, delta and ids
      float lc[2] = {0.f, 0.f}, dc[2] = {0.f, 0.f};
      int sc[2] = {0, 0};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int col = s0 + c0 + 8 * j + 2 * t + x;
        if (col >= Ss) continue;
        if (DKV) {
          const size_t li = ((size_t)b * a.Hq + hs) * a.Sq + col;
          lc[x] = __ldg(a.lse + li);
          dc[x] = __ldg(a.delta + li);
        }
        if (seg)
          sc[x] = __ldg(DKV ? a.seg_q + (size_t)b * a.Sq + col
                            : a.seg_kv + (size_t)b * a.Skv + col);
      }
      float pv[4], dv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rA + 8 * (e >> 1);
        const int col = s0 + c0 + 8 * j + 2 * t + (e & 1);
        const int qi = DKV ? col : row, kj = DKV ? row : col;
        bool vis = qi < a.Sq && kj < a.Skv && (!a.causal || kj <= qi + off);
        if (seg) vis = vis && sr[e >> 1] == sc[e & 1];
        const float l = DKV ? lc[e & 1] : lr[e >> 1];
        const float dl = DKV ? dc[e & 1] : dr[e >> 1];
        pv[e] = dv[e] = 0.f;
        if (vis) {
          pv[e] = expf(s[j][e] * a.scale - l);
          dv[e] = pv[e] * (dp[j][e] - dl) * a.scale;
        }
      }
      const int xi = (rg * kTcNT + wi * NTA + j) * 32 + lane;
      if (DKV) xP[xi] = make_float4(pv[0], pv[1], pv[2], pv[3]);
      xS[xi] = make_float4(dv[0], dv[1], dv[2], dv[3]);
    }
    __syncthreads();   // the row group's P / dS are in
    // ---- phase B: the warp's columns of its output, summed over the tile
    {
      const float* yb = (role == 0 ? Y2 : Y1) + 2 * t * ld + n_lo * 8 + g;
#pragma unroll
      for (int kk = 0; kk < kTcNT; ++kk) {
        const float4 c = xA[(rg * kTcNT + kk) * 32 + lane];
        // the C fragment as the A fragment: k t <- column 2t, k t + 4 <-
        // column 2t + 1 of the exchanged tile
        uint32_t ah[4], al[4];
        split_tf32(c.x, ah[0], al[0]);
        split_tf32(c.z, ah[1], al[1]);
        split_tf32(c.y, ah[2], al[2]);
        split_tf32(c.w, ah[3], al[3]);
        const float* y = yb + kk * 8 * ld;
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(y[j * 8], bh0, bl0);        // row 2t
          split_tf32(y[j * 8 + ld], bh1, bl1);   // row 2t + 1
          mma_3xtf32(tsum[j], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
    const int nxt = next_live(cur + 1);
    if (nxt >= nT || block_of(nxt) != block_of(cur)) {
#pragma unroll
      for (int j = 0; j < CS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] += tsum[j][e];
          tsum[j][e] = 0.f;
        }
    }
    cur = nxt;
    slot = slot + 1 == ST ? 0 : slot + 1;
  }
  // the output: every row the CTA owns, zero where no pair was visible
  float* out = DKV && role == 0 ? a.o2 : a.o1;   // K6 dv / dk, K5 dq
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rA + 8 * i;
    if (row >= Sr) continue;
    float* o = out + (((size_t)b * Sr + row) * Hr + hr) * D + n_lo * 8 + 2 * t;
#pragma unroll
    for (int j = 0; j < CS; ++j)
      if (j < n_cnt)
        *reinterpret_cast<float2*>(o + 8 * j) =
            make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// K5 at float32: BR queries a CTA, ST stages of 32-key K / V tiles
template <int BR, int ST, int CS>
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dq_tf32_kernel(const TcArgs a) {
  tc_body<false, BR, ST, CS>(a);
}

// K6 at float32: BR keys a CTA, ST stages of 32-query Q / dO tiles
template <int BR, int ST, int CS>
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dkv_tf32_kernel(const TcArgs a) {
  tc_body<true, BR, ST, CS>(a);
}

#endif

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

#ifndef PTT_F16
template <typename Kernel>
cudaError_t tc_launch(Kernel kernel, int smem, dim3 grid, const TcArgs& a,
                      cudaStream_t st) {
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kTcThreads, smem, st>>>(a);
  return cudaSuccess;
}

// K5 (dkv false) or K6 at float32 (the budgets in the note at the top):
// above D 128 32 rows a CTA and 2 stages; up to it K6 64 keys and 3
// stages, K5 128 queries and 3 stages (2 above D 96).  A warp's output
// chunk is CS column tiles, the least instance that covers its share of
// D / 8 (no guard in the products' loop).
cudaError_t launch_bwd_tf32(bool dkv, const TcArgs& a, int B,
                            cudaStream_t st) {
  const bool wide = a.D > kBig;
  const int br = wide ? 32 : 64, rows = dkv ? a.Skv : a.Sq;
  const dim3 grid((rows + br - 1) / br, dkv ? a.Hkv : a.Hq, B);
  // column chunks an output: K5's the warps of a row group, K6's half
  const int chunks = (wide ? 4 : 2) / (dkv ? 2 : 1);
  const int cs = (a.D / 8 + chunks - 1) / chunks;
  const int smem = tc_smem(dkv, br, wide ? 2 : 3, a.D);
  if (dkv && wide)
    return cs <= 12 ? tc_launch(bwd_dkv_tf32_kernel<32, 2, 12>, smem, grid,
                                a, st)
                    : tc_launch(bwd_dkv_tf32_kernel<32, 2, 16>, smem, grid,
                                a, st);
  if (dkv)
    return cs <= 8    ? tc_launch(bwd_dkv_tf32_kernel<64, 3, 8>, smem, grid,
                                  a, st)
           : cs <= 12 ? tc_launch(bwd_dkv_tf32_kernel<64, 3, 12>, smem, grid,
                                  a, st)
                      : tc_launch(bwd_dkv_tf32_kernel<64, 3, 16>, smem, grid,
                                  a, st);
  if (wide)
    return cs <= 6 ? tc_launch(bwd_dq_tf32_kernel<32, 2, 6>, smem, grid, a,
                               st)
                   : tc_launch(bwd_dq_tf32_kernel<32, 2, 8>, smem, grid, a,
                               st);
  // K5 up to D 128: a warp's 16 rows and every column of dq
  const dim3 grid5((a.Sq + 127) / 128, a.Hq, B);
  const int nt = a.D / 8;
  return nt <= 8    ? tc_launch(bwd_dq_tf32_kernel<128, 3, 8>,
                                tc_smem(false, 128, 3, a.D), grid5, a, st)
         : nt <= 12 ? tc_launch(bwd_dq_tf32_kernel<128, 3, 12>,
                                tc_smem(false, 128, 3, a.D), grid5, a, st)
                    : tc_launch(bwd_dq_tf32_kernel<128, 2, 16>,
                                tc_smem(false, 128, 2, a.D), grid5, a, st);
}

// the float32 kernels' arguments from the C entries'
TcArgs f32_args(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const int* seg_q, const int* seg_kv, const int* q_rng,
                const int* kv_rng, void* o1, void* o2, int Sq, int Skv,
                int Hq, int Hkv, int D, float scale, int causal) {
  return TcArgs{static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, delta, seg_q, seg_kv,
                q_rng, kv_rng, static_cast<float*>(o1),
                static_cast<float*>(o2), Sq, Skv, Hq, Hkv, D, scale,
                causal};
}
#endif

}  // namespace

// K5: dq (B, Sq, Hq, D) in q's dtype.  dtype: the library's 16-bit code
// (kE16Code: 0 = bfloat16, or 2 = float16 in the library compiled with
// -DPTT_F16; any D <= 256 with D % 8 == 0: the Hopper kernels, 128-wide
// tiles up to 128, 256-wide above), 1 = float32 (the same head dims, the
// 3xTF32 kernels; not in the float16 library): K2's head dims.  Any other
// pair, or only one of seg_q / seg_kv, returns cudaErrorInvalidValue.
// Tensors contiguous and 16-byte aligned (seg_q / seg_kv too).  With
// segment ids every build also takes q_rng (B, ceil(Sq / 64), 2) and
// kv_rng (B, ceil(Skv / 64), 2): the int32 [min, max] id of every 64
// tokens (segment_tile_ranges).  Returns cudaGetLastError().
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
  else if (dtype == 1 && (wgmma_head_dim(D) || wide_head_dim(D)))
    e = (sq != nullptr && (qr == nullptr || kr == nullptr))
            ? cudaErrorInvalidValue
            : launch_bwd_tf32(false, f32_args(q, k, v, dout, l, dl, sq, skv,
                                              qr, kr, dq, nullptr, Sq, Skv,
                                              Hq, Hkv, D, scale, causal),
                              B, st);
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
  else if (dtype == 1 && (wgmma_head_dim(D) || wide_head_dim(D)))
    e = (sq != nullptr && (qr == nullptr || kr == nullptr))
            ? cudaErrorInvalidValue
            : launch_bwd_tf32(true, f32_args(q, k, v, dout, l, dl, sq, skv,
                                             qr, kr, dk, dv, Sq, Skv, Hq,
                                             Hkv, D, scale, causal),
                              B, st);
#endif
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
