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
// visible and the bytes bind.  Two bodies (any other pair is refused):
//   * bfloat16 at D = 128 (every training backward): Hopper kernels of
//     384 threads, two consumer warpgroups of 64 rows and a producer warp
//     (setmaxnreg 240 / 24), in the shape of K2's:
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
//   * float32 at D = 16 (the tiny model): two CUDA-core kernels of one
//     thread per query row (K5) or key row (K6); wgmma has no float32
//     input that keeps float32 numerics.
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
// Hopper path: bfloat16, D = 128 (see the note at the top)
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

// the 64 x 128 accumulator `a` of warpgroup-row rl (rows rl, rl + 8) as bf16
// into a 128-row tile in the 128-byte swizzled layout TMA stores from
__device__ __forceinline__ void stage_rows(unsigned char* tile,
                                          const float (&a)[64], int rl,
                                          int c) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    unsigned char* base = tile + (j / 8) * kBigHalf +
                          (((j % 8) ^ (rl & 7)) << 4) + 4 * c;
    *reinterpret_cast<uint32_t*>(base + rl * 128) =
        pack_bf16(a[4 * j], a[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(base + (rl + 8) * 128) =
        pack_bf16(a[4 * j + 2], a[4 * j + 3]);
  }
}

// a 64 x 64 accumulator, rounded to bf16, as the register A operand of 4
// k steps: k step t takes d[8t..8t+7]
__device__ __forceinline__ void pack_a(const float (&d)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a[t][0] = pack_bf16(d[8 * t], d[8 * t + 1]);
    a[t][1] = pack_bf16(d[8 * t + 2], d[8 * t + 3]);
    a[t][2] = pack_bf16(d[8 * t + 4], d[8 * t + 5]);
    a[t][3] = pack_bf16(d[8 * t + 6], d[8 * t + 7]);
  }
}

// X = A . B^T for a 64-row A of 128 d (K-major, rows of a 128-byte
// swizzled tile whose halves lie `a_half` apart) and a 64-row B (a 64-row
// tile): m64n64k16 x 8 k steps, one commit group
__device__ __forceinline__ void issue_abt(float (&x)[32],
                                          const unsigned char* a, int a_half,
                                          const unsigned char* bt) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
    wgmma_ss<0, 0>(x, gmma_desc(a + (t / 4) * a_half + (t % 4) * 32, 16, 1024),
                   gmma_desc(bt + (t / 4) * kSmallHalf + (t % 4) * 32, 16,
                             1024),
                   t > 0);
  wgmma_commit();
}

// acc += A . T for A in registers (64 x 64, 4 k steps) and T a 64-row tile
// of 128 d read MN-major (its rows are the k dimension): m64n128k16 x 4
__device__ __forceinline__ void issue_at(float (&acc)[64],
                                         const uint32_t (&a)[4][4],
                                         const unsigned char* t) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_rs<1>(acc, a[k], gmma_desc(t + k * 2048, kSmallHalf, 1024), 1);
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
    issue_abt(sc, qa, kBigHalf, Ks + st * kSmallTile);
    issue_abt(dp, oa, kBigHalf, Vs + st * kSmallTile);
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
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = sc[i] * (dp[i] - ((i & 2) ? dl1 : dl0)) * scale;
    pack_a(dp, da);
    wgmma_fence();
    issue_at(acc, da, Ks + st * kSmallTile);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // dq through this warpgroup's rows of Q's shared memory (its last Q K^T
  // is done) and a TMA store that drops rows past Sq
  stage_rows(Qs, acc, rl, c);
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
    issue_abt(sc, ka, kBigHalf, qt);
    issue_abt(dp, va, kBigHalf, ot);
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
    pack_a(sc, pa);
    wgmma_fence();
    issue_at(dv, pa, ot);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(dp);
    const float* ds = dl_s + st * kVecStride + lead;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d0 = ds[8 * j + 2 * c], d1 = ds[8 * j + 2 * c + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d1 : d0)) * scale;
    }
    pack_a(dp, da);
    wgmma_fence();
    issue_at(dk, da, qt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&empty[st]);
  }

  // dk and dv through this warpgroup's rows of K's and V's shared memory
  // (only this warpgroup read them) and TMA stores that drop rows past Skv
  stage_rows(Ks, dk, rl, c);
  stage_rows(Vs, dv, rl, c);
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
                            int Skv, int Hq, int Hkv, float scale, int causal,
                            cudaStream_t st) {
  CUtensorMap qm, km, vm, om, dqm, sm;
  memset(&sm, 0, sizeof(sm));
  cudaError_t e = bshd_map(&qm, q, B, Sq, Hq, kBig);
  if (e == cudaSuccess) e = bshd_map(&km, k, B, Skv, Hkv, kSmall);
  if (e == cudaSuccess) e = bshd_map(&vm, v, B, Skv, Hkv, kSmall);
  if (e == cudaSuccess) e = bshd_map(&om, dout, B, Sq, Hq, kBig);
  if (e == cudaSuccess) e = bshd_map(&dqm, dq, B, Sq, Hq, kSmall);
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
                             int Sq, int Skv, int Hq, int Hkv, float scale,
                             int causal, cudaStream_t st) {
  CUtensorMap qm, km, vm, om, dkm, dvm, lm, dlm, sm;
  memset(&sm, 0, sizeof(sm));
  cudaError_t e = bshd_map(&qm, q, B, Sq, Hq, kSmall);
  if (e == cudaSuccess) e = bshd_map(&km, k, B, Skv, Hkv, kBig);
  if (e == cudaSuccess) e = bshd_map(&vm, v, B, Skv, Hkv, kBig);
  if (e == cudaSuccess) e = bshd_map(&om, dout, B, Sq, Hq, kSmall);
  if (e == cudaSuccess) e = bshd_map(&dkm, dk, B, Skv, Hkv, kSmall);
  if (e == cudaSuccess) e = bshd_map(&dvm, dv, B, Skv, Hkv, kSmall);
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

}  // namespace

// K5: dq (B, Sq, Hq, D) in q's dtype.  dtype: 0 = bfloat16 (D = 128, the
// Hopper kernel), 1 = float32 (D = 16, CUDA cores); any other pair, or only
// one of seg_q / seg_kv, returns cudaErrorInvalidValue.  Tensors
// contiguous and 16-byte aligned (seg_q / seg_kv too).  With segment ids the
// bfloat16 build also takes q_rng (B, ceil(Sq / 64), 2) and kv_rng (B,
// ceil(Skv / 64), 2): the int32 [min, max] id of every 64 tokens
// (segment_tile_ranges); the float32 build ignores them.  Returns
// cudaGetLastError().
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
  if (dtype == 0 && D == 128 && sq != nullptr)
    e = (qr == nullptr || kr == nullptr)
            ? cudaErrorInvalidValue
            : launch_dq_wgmma<true>(q, k, v, dout, l, dl, sq, skv, qr, kr, dq,
                                    B, Sq, Skv, Hq, Hkv, scale, causal, st);
  else if (dtype == 0 && D == 128)
    e = launch_dq_wgmma<false>(q, k, v, dout, l, dl, nullptr, nullptr,
                               nullptr, nullptr, dq, B, Sq, Skv, Hq, Hkv,
                               scale, causal, st);
  else if (dtype == 1 && D == 16) {
    const dim3 grid((Sq + kTile - 1) / kTile, Hq, B);
    bwd_dq_f32_kernel<16><<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        sq, skv, static_cast<float*>(dq), Sq, Skv, Hq, Hkv, scale, causal);
    e = cudaSuccess;
  } else {
    e = cudaErrorInvalidValue;
  }
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
  if (dtype == 0 && D == 128 && sq != nullptr)
    e = (qr == nullptr || kr == nullptr)
            ? cudaErrorInvalidValue
            : launch_dkv_wgmma<true>(q, k, v, dout, l, dl, sq, skv, qr, kr,
                                     dk, dv, B, Sq, Skv, Hq, Hkv, scale,
                                     causal, st);
  else if (dtype == 0 && D == 128)
    e = launch_dkv_wgmma<false>(q, k, v, dout, l, dl, nullptr, nullptr,
                                nullptr, nullptr, dk, dv, B, Sq, Skv, Hq,
                                Hkv, scale, causal, st);
  else if (dtype == 1 && D == 16) {
    const dim3 grid((Skv + kTile - 1) / kTile, Hkv, B);
    bwd_dkv_f32_kernel<16><<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        sq, skv, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv,
        Hq, Hkv, scale, causal);
    e = cudaSuccess;
  } else {
    e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
