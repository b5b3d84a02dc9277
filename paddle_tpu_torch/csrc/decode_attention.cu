// Flash-decode over a contiguous or paged KV cache: kernel K1 of
// paddle_tpu_torch.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py::decode_attention_pallas
// (body _kernel :120, block-table mode :244-256, call :389), contiguous and
// paged layouts.  For query row (b, si, h):
//   out = softmax_j(q . k_j * scale) . v_j   over keys j <= pos[b] + si,
// GQA grouped (kv head = h / G; K/V never broadcast), float32 accumulation,
// online softmax; a row whose keys are all masked returns 0.
//
// Layouts: q (B, S, Hq, D); out (B, S, Hq, D); K/V either
//   * contiguous (entry decode_attention): k, v (B, L, Hkv, D) -- one
//     layer's slice of the (layers, 2, B, L, Hkv, D) cache; or
//   * paged (entry decode_attention_paged): k, v (num_blocks, block_len,
//     Hkv, D) -- one layer's slice of the pooled cache -- and an int32
//     block table (B, max_blocks): key j of row b lives at
//     pool[table[b, j / block_len], j % block_len].  The logical length
//     is max_blocks * block_len; the table's dead-tail columns hold the
//     null block 0 and are never read (the live-prefix rule below).
//     block_len and the split length are multiples of 8, so an 8-key
//     group never straddles a block: one table lookup per group.
//
// Bound on the H100: memory.  The live K+V bytes over 3.35 TB/s; at S = 1 a
// key feeds G query rows, about one operation per byte.  Both bodies:
//   * a CTA owns one (row b, kv head h) pair, a tile of its G*S query
//     rows, and one split of the key axis; it reads keys only below
//     pos[b] + (its last query offset) + 1 -- the dead cache tail is never
//     read, so a tick costs what the rows' depths need, not L;
//   * splits (split_len keys each) spread the walk over CTAs so B x Hkv
//     pairs fill the card; each split's unnormalised (acc, m, l) partial
//     is merged with the LSE algebra
//     (paddle_tpu/ops/ring_attention.py::merge_attention), in split order.
//
// The CUDA-core body (decode_attention_kernel: the float32 builds of every
// entry, at any head_dim D <= 256 with D % 8 == 0 -- the tiny test models'
// 16, TinyLlama's 64, the reference's float32 default configurations' 128
// (LlamaConfig() and the Qwen2-VL decoder), a Gemma-2B-wide Llama's 256):
// 4 query rows a CTA; each of its 4 warps walks its own KPI-key blocks
// (interleaved with the other warps) with its own online softmax and no
// barrier: lane l holds head-dim elements [l*EPL, l*EPL + EPL) of the
// queries, the accumulator and the keys' K/V rows, and a lane whose
// elements lie at or past D loads nothing and holds zeros (D is a runtime
// argument; D % 8 == 0 and EPL <= 8, so a lane's elements lie wholly
// below D or wholly past it).  Four instances a layout, by the D they
// cover: EPL 1 (D <= 32; D 16: lanes 16..31 idle), 2 (D <= 64), 4 (D <=
// 128) and 8 (D <= 256, 4 keys a block: 8 would hold 2 x 8 x 8 K / V
// floats a lane beside 4 rows of 8 accumulators; 2 over the int8 cache,
// which spilled at 4, 168 registers), each lane's elements one
// vector load a key row (float2 / float4 / two float4; int8 char2 / char4
// / two char4); the KPI keys' dot products are summed across lanes by a
// transpose-reduce; the warps merge once at the end, through 4 x 4 x 32 *
// EPL floats of shared memory (16 KB at EPL 8); decode_attention_combine
// (D threads) merges the splits.  Float32 math throughout: no tensor core
// keeps float32 numerics.
//
// The Hopper body (decode_mma_kernel<INT8, PAGED, PAD, PD>: K1, K1-int8,
// K1-paged and K1-paged-int8, 16-bit q at any D <= 256 with D % 8 == 0 --
// the decode tick of every bf16 and float16 engine; the library's 16-bit
// type e16 is bfloat16, or float16 in the library compiled with -DPTT_F16,
// mma_bf16.cuh).  It replaced a CUDA-core walk that was
// bound by latency, not bytes: a warp loaded one 8-key group into
// registers and then spent ~23 dependent shuffles a row on it with nothing
// in flight, so its time followed the groups a warp walked and the int8
// build, with half the bytes, took as long.  Here:
//   * K/V through shared memory: each warp keeps its own two-stage ring of
//     16-key slices (8 KB a stage, int8 4 KB), filled by cp.async 16-byte
//     copies addressed per key row (int8 at D % 16 == 8, whose rows start
//     only 8-byte aligned: two 8-byte copies a chunk) -- contiguous: row
//     b's own cache rows b * L + j, no lookup; paged: through the block
//     table (any block_len
//     % 8 == 0) -- with no descriptor and nothing on the host; keys past
//     the split's live bound are zero-filled, not read.  Warp w takes
//     slices w, w + 4, ... of the split, so no CTA barrier sits in the walk
//     (__syncwarp around each stage).  3 CTAs an SM (registers) keep up to
//     ~100-190 KB in flight there, past the ~30 KB that 3.35 TB/s x ~1 us /
//     132 SMs asks: more stages measured no faster, and at int8 slower;
//   * products on tensor cores, transposed so the query rows are the
//     narrow side: S^T = K Q^T and O^T += V^T P^T on mma.sync.m16n8k16,
//     16 keys (or 16 head-dim rows) by the tile's G*S <= 8 query rows
//     (padding columns are never written; at G*S = 4 half the product is
//     padding, where Q as the 16-row side would waste three quarters and
//     twice the accumulator registers).  K's A fragments come from shared
//     memory with 16-byte loads (the head-dim order inside a k step is
//     permuted identically in Q's fragments, which the sum ignores); P^T
//     is P in 16 bits -- the reference's p.astype(v.dtype) -- turned into the
//     B operand by movmatrix; V^T's A fragments by ldmatrix.trans.  The
//     softmax runs in the log2 domain, a row's max over the 8 lanes that
//     hold its keys (3 shuffles), the row sums reduced once at the end,
//     and the accumulator rescaled only when a running max moved;
//   * int8: the K and V fragments are converted to 16 bits in registers
//     as they are built (exact; ptt::int8x4_to_e16), never as tiles in
//     shared memory; the scales ride in the stage (4 floats a slice) and
//     fold per 8-key group -- K's into the scores, V's into P before P V
//     (at block_len or granule 8 a 16-key slice spans two of them; at
//     float16, relative to the slice's larger V scale, the accumulator
//     kept in units of it: P times a 1e-4 scale would be subnormal);
//   * below D = 128 the same body runs at a runtime D on rows of 128
//     elements (its PAD instance; the D = 128 one has D as a constant and
//     no test of it: a runtime D there cost 8-11 % of every row
//     chip_decode_attention.py times, NVIDIA H100 80GB HBM3, 700 W): the
//     chunks of a ring row at or past D's bytes are zero-filled by the
//     same copies and q's registers are zero past D, so S^T = K Q^T adds
//     zero products over the pad and O^T's rows past D hold zeros, which
//     are never stored; the HBM bytes stay D a key;
//   * above D = 128 (up to 256, the reference's MAX_HEAD_DIM) the ring rows
//     are 256 elements wide (PD = kPDWide): twice the k steps and m-tiles
//     of the same products, the K reads and V reads per 128-element half,
//     and two head-dim elements a merging thread; D = 256 has an instance
//     of constant D, 136-248 the PAD one.  A warp's stage doubles (bf16
//     16 KB, int8 8 KB; the ring 128 / 64 KB a CTA), so an SM holds one
//     bf16 CTA (two int8) -- still ~128 KB in flight an SM -- and the
//     instance's registers are not capped for three;
//   * the warps' partials meet in shared memory with rows padded (a
//     128-float row stride put a lane's 32 stores on one bank);
//   * the merge: a split past the live bound leaves at once, a lone live
//     split writes the output, and otherwise the last CTA of the (b, h)
//     tile to finish (an atomic counter it resets itself) merges the live
//     splits' partials in split order, so the bits do not depend on the
//     order the CTAs finish in.  Against a two-launch merge (every split
//     writes a partial, decode_attention_combine merges them) it measured
//     2.2-4.5 us faster on each paged row chip_decode_attention.py times,
//     every row at 4095 (16 partials a tile) included (NVIDIA H100 80GB
//     HBM3, 700 W).
//
// int8 cache (entries decode_attention_int8 / decode_attention_paged_int8;
// replaces the Pallas kernel's quantized mode, decode_attention.py
// :122-128, :160-187): K and V hold int8 with one float32 scale per
// (granule or block, kv head) -- contiguous k_scale / v_scale (B, n_gran,
// Hkv) over granules of L / n_gran positions, paged (num_blocks, Hkv).
// The bytes a key costs halve.  Granules, blocks and splits are multiples
// of 8, so an 8-key group lies in one granule or block and its two scales
// fold as the Pallas body folds them: K's into the group's scores (q .
// k_int8 * scale * k_scale), V's into the group's probabilities before
// they weight V (equal to scaling P.V); the running sum l takes the
// unscaled probabilities.  The int8 -> float conversion is exact.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using namespace ptt;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                        // query rows per CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// EPL consecutive elements of a K / V / q row as floats: one vector load at
// EPL 2, 4 and 8 (a lane's offset is a multiple of EPL elements, D a
// multiple of 8 and the rows 16-byte aligned, so the load is aligned to
// its width: float2 / float4 / two float4, int8 char2 / char4 / two
// char4), element by element at EPL 1
template <int EPL, typename X>
__device__ __forceinline__ void load_row(const X* __restrict__ p,
                                         float (&dst)[EPL]) {
  if constexpr (EPL == 4 && std::is_same<X, float>::value) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (EPL == 4 && std::is_same<X, int8_t>::value) {
    const char4 t = *reinterpret_cast<const char4*>(p);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (EPL == 2 && std::is_same<X, float>::value) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    dst[0] = t.x; dst[1] = t.y;
  } else if constexpr (EPL == 2 && std::is_same<X, int8_t>::value) {
    const char2 t = *reinterpret_cast<const char2*>(p);
    dst[0] = t.x; dst[1] = t.y;
  } else if constexpr (EPL == 8) {
    float lo[4], hi[4];
    load_row<4>(p, lo);
    load_row<4>(p + 4, hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dst[e] = lo[e];
      dst[4 + e] = hi[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) dst[e] = to_float(p[e]);
  }
}

// grid (B * Hkv, ceil(S*G / kRows), nsplit), block kThreads.
// Lane l of a warp owns head-dim elements [l*EPL, l*EPL + EPL), those at or
// past D none (D <= 32 * EPL).  Built for float32 at EPL 1, 2, 4 and 8
// (f32_launch): the 16-bit builds run decode_mma_kernel.  Each warp walks
// blocks of KPI keys of the split, interleaved with the other warps,
// keeping its own online-softmax state; the warps merge once at the end.
// PAGED selects the K/V addressing: false = contiguous (table, max_blocks
// and block_len unused), true = pool + block table with L = max_blocks *
// block_len.  KV is the cache's element type: T, or int8_t for the int8
// cache, whose scales (k_scale, v_scale; n_gran and gran_len for the
// contiguous layout) are unused otherwise.
template <typename T, typename KV, int EPL, int KPI, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, float* __restrict__ part_o,
                        float* __restrict__ part_ml, int S, int Hq, int Hkv,
                        int D, int L, int limit, int split_len, float scale,
                        const int* __restrict__ table, int max_blocks,
                        int block_len, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, int n_gran,
                        int gran_len) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int kRowD = 32 * EPL;   // the warps' merge: floats a row
  constexpr int kLogK = KPI == 8 ? 3 : (KPI == 4 ? 2 : 1);
  static_assert((1 << kLogK) == KPI, "KPI must be 2, 4 or 8");
  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv;
  const int rows_total = S * G;
  const int r0 = blockIdx.y * kRows;
  const int nr = min(kRows, rows_total - r0);
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int pb = pos[b];
  // the tile's last query offset sees the most keys: keys [0, live)
  const int si_last = (r0 + nr - 1) / G;
  const int live = min(limit, pb + si_last + 1);
  const int k_begin = split * split_len;
  const int k_end = min(live, k_begin + split_len);
  if (k_end <= k_begin) {
    // a split past the rows' live prefix reads nothing: its partial says
    // so (l = 0, skipped by the merge); alone, its rows see no key (0)
    if (nsplit > 1) {
      if (tid < nr) {
        const size_t i = ((size_t)bh * nsplit + split) * rows_total + r0 + tid;
        part_ml[2 * i] = kNegInf;
        part_ml[2 * i + 1] = 0.f;
      }
    } else {
      for (int idx = tid; idx < nr * D; idx += kThreads) {
        const int r = idx / D, d = idx - r * D;
        const int rr = r0 + r, si = rr / G, gi = rr - si * G;
        out[((size_t)(b * S + si) * Hq + h * G + gi) * D + d] =
            static_cast<T>(0.f);
      }
    }
    return;
  }

  const int d0 = lane * EPL;
  const bool lane_on = d0 < D;
  float qr[kRows][EPL];
  int last_key[kRows];   // row r sees keys j <= pos[b] + si
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    last_key[r] = -1;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[r][e] = 0.f;
    if (r < nr && lane_on) {
      const int rr = r0 + r, si = rr / G, gi = rr - si * G;
      last_key[r] = pb + si;
      load_row<EPL>(q + ((size_t)(b * S + si) * Hq + h * G + gi) * D + d0,
                    qr[r]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[r][e] *= scale;
    }
    last_key[r] = __shfl_sync(kFull, last_key[r], 0);
  }

  float m[kRows], l[kRows], acc[kRows][EPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const size_t key_stride = (size_t)Hkv * D;
  // contiguous: row b's cache; paged: the pool (rows come from the table)
  const size_t row_base = PAGED ? 0 : (size_t)b * L * key_stride;
  const KV* kb = k + row_base + (size_t)h * D + d0;
  const KV* vb = v + row_base + (size_t)h * D + d0;
  // after the transpose-reduce, lane l holds the score of key kidx
  const int kidx = (lane >> (5 - kLogK)) & (KPI - 1);

  for (int base = k_begin + warp * KPI; base < k_end;
       base += kWarps * KPI) {
    float kf[KPI][EPL], vf[KPI][EPL];
    // pool row of the group's first key (base is a multiple of KPI, and
    // so is block_len: the group lies in one block)
    size_t grow = 0;
    int blk = 0;
    if constexpr (PAGED) {
      blk = table[(size_t)b * max_blocks + base / block_len];
      grow = (size_t)blk * block_len + base % block_len;
    }
    // int8: the group's granule / block scales (one of each a group)
    float k_sc = 1.f, v_sc = 1.f;
    if constexpr (INT8) {
      const size_t srow = PAGED ? (size_t)blk
                                : (size_t)b * n_gran + base / gran_len;
      k_sc = k_scale[srow * Hkv + h];
      v_sc = v_scale[srow * Hkv + h];
    }
#pragma unroll
    for (int kk = 0; kk < KPI; ++kk) {
      const int j = base + kk;
      if (lane_on && j < k_end) {
        const size_t r = PAGED ? grow + kk : (size_t)j;
        load_row<EPL>(kb + r * key_stride, kf[kk]);
        load_row<EPL>(vb + r * key_stride, vf[kk]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[kk][e] = vf[kk][e] = 0.f;
      }
    }
    const int j_mine = base + kidx;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) break;   // uniform across the warp
      float part[KPI];
#pragma unroll
      for (int kk = 0; kk < KPI; ++kk) {
        part[kk] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part[kk] = fmaf(qr[r][e], kf[kk][e], part[kk]);
      }
      // transpose-reduce: each halving step trades the half of the keys a
      // lane gives away for its partner's half of the keys it keeps
#pragma unroll
      for (int step = 0; step < kLogK; ++step) {
        const int o = 16 >> step, n = KPI >> step;
        const bool upper = (lane & o) != 0;
#pragma unroll
        for (int i = 0; i < n / 2; ++i) {
          const float send = upper ? part[i] : part[i + n / 2];
          const float recv = __shfl_xor_sync(kFull, send, o);
          part[i] = (upper ? part[i + n / 2] : part[i]) + recv;
        }
      }
      float s = part[0];
#pragma unroll
      for (int o = 16 >> kLogK; o > 0; o >>= 1)
        s += __shfl_xor_sync(kFull, s, o);
      if constexpr (INT8) s *= k_sc;
      const bool keep = j_mine < k_end && j_mine <= last_key[r];
      s = keep ? s : kNegInf;
      float cmax = s;
#pragma unroll
      for (int o = 16; o >= (32 >> kLogK); o >>= 1)
        cmax = fmaxf(cmax, __shfl_xor_sync(kFull, cmax, o));
      const float m_new = fmaxf(m[r], cmax);
      const float alpha = expf(m[r] - m_new);
      const float p = keep ? expf(s - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int o = 16; o >= (32 >> kLogK); o >>= 1)
        psum += __shfl_xor_sync(kFull, psum, o);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
      float pw = p;   // the weight of this lane's key's V row
      if constexpr (INT8) pw *= v_sc;
#pragma unroll
      for (int kk = 0; kk < KPI; ++kk) {
        const float pk = __shfl_sync(kFull, pw, kk << (5 - kLogK));
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pk, vf[kk][e], acc[r][e]);
      }
    }
  }

  // ---- merge the warps, then write the output or the split's partial ------
  __shared__ float wm[kWarps][kRows], wl[kWarps][kRows];
  __shared__ float wacc[kWarps][kRows][kRowD];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == 0) {
      wm[warp][r] = m[r];
      wl[warp][r] = l[r];
    }
    if (lane_on) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) wacc[warp][r][d0 + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nr * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (wl[w][r] > 0.f) M = fmaxf(M, wm[w][r]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (wl[w][r] > 0.f) {
        const float c = expf(wm[w][r] - M);
        lsum += wl[w][r] * c;
        o += wacc[w][r][d] * c;
      }
    }
    const int rr = r0 + r;
    if (nsplit == 1) {
      const int si = rr / G, gi = rr - si * G;
      out[((size_t)(b * S + si) * Hq + h * G + gi) * D + d] =
          static_cast<T>(lsum > 0.f ? o / lsum : 0.f);
    } else {
      part_o[(((size_t)bh * nsplit + split) * rows_total + rr) * D + d] = o;
      if (d == 0) {
        const size_t i = ((size_t)bh * nsplit + split) * rows_total + rr;
        part_ml[2 * i] = M;
        part_ml[2 * i + 1] = lsum;
      }
    }
  }
}

// grid (B * Hkv, S * G), block D: merge the splits of one query row.
template <typename T>
__global__ void decode_attention_combine(const float* __restrict__ part_o,
                                         const float* __restrict__ part_ml,
                                         T* __restrict__ out, int S, int Hq,
                                         int Hkv, int D, int nsplit) {
  const int bh = blockIdx.x, rr = blockIdx.y, d = threadIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv, rows_total = S * G;
  const int si = rr / G, gi = rr - si * G;
  float M = kNegInf;
  for (int s = 0; s < nsplit; ++s) {
    const size_t i = ((size_t)bh * nsplit + s) * rows_total + rr;
    if (part_ml[2 * i + 1] > 0.f) M = fmaxf(M, part_ml[2 * i]);
  }
  float lsum = 0.f, o = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t i = ((size_t)bh * nsplit + s) * rows_total + rr;
    const float l = part_ml[2 * i + 1];
    if (l > 0.f) {
      const float w = expf(part_ml[2 * i] - M);
      lsum += l * w;
      o += part_o[i * D + d] * w;
    }
  }
  out[((size_t)(b * S + si) * Hq + h * G + gi) * D + d] =
      static_cast<T>(lsum > 0.f ? o / lsum : 0.f);
}

// ---------------------------------------------------------------------------
// K1, K1-int8, K1-paged and K1-paged-int8 at 16-bit q, head_dim D <= 256 (D %
// 8 == 0): tensor cores, and a cp.async ring in shared memory for each warp
// (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int kPD = 128;                  // ring row of the narrow instances
constexpr int kPDWide = 256;              // and of the wide ones (D > 128)
constexpr int kPRows = 8;                 // query rows a CTA (mma's n8)
constexpr int kPWarps = 4;
constexpr int kPThreads = 32 * kPWarps;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMergeChunk = 256;          // splits a pass of the last CTA

// PD: a ring row's head-dim elements (kPD or kPDWide)
template <bool INT8, int PD>
struct Mma {
  static_assert(PD == kPD || PD == kPDWide, "a ring row is 128 or 256 wide");
  static constexpr int kRow = INT8 ? PD : 2 * PD;     // bytes a ring row
  static constexpr int kChunks = kRow / 16;           // 16-byte chunks a row
  static constexpr int kSteps = PD / 16;   // k steps of K Q^T, m-tiles of O^T
  // head-dim elements a thread merges (element tid + kPThreads * e)
  static constexpr int kEPT = PD / kPThreads;
  static constexpr int kSlice = 16;                   // keys a warp step
  static constexpr int kTile = kSlice * kRow;         // K (or V) of a slice
  // a stage: the slice's K rows, V rows and (int8) the K and V scales of
  // its 8-key groups
  static constexpr int kStage = 2 * kTile + (INT8 ? 2 * 4 * (kSlice / 8) : 0);
  static constexpr int kStages = 2;                   // a warp's ring
  static constexpr int kRing = kPWarps * kStages * kStage;
  // the warps' merge: acc [warp][row][slot], rows kMStride floats apart
  // (a lane's stores then fall on distinct banks but for pairs), then m and
  // l [warp][row]
  static constexpr int kMStride = PD + 4;
  static constexpr int kMerge = kPWarps * kPRows * (kMStride + 2) * 4;
  static_assert((kPRows + 2 * kMergeChunk * kPRows) * 4 <= kMerge,
                "the last CTA's merge fits in the warps' merge space");
  static constexpr int kSmem = kRing > kMerge ? kRing : kMerge;
  // CTAs an SM the instance is built for: the narrow ones 3 (registers);
  // the wide ones' rings (bf16 128 KB, int8 64 KB) and doubled
  // accumulators leave one or two, so their registers are not capped
  static constexpr int kMinCtas = PD == kPD ? 3 : 1;

  // chunk ch of key row r of a staged tile sits at chunk ch ^ swz(r) (the
  // swizzle stays inside an aligned group of 8 chunks, 128 bytes): every
  // 8-lane phase of the copies, the K reads and the V reads (K: rows r,
  // r + 1 at chunks c + 4i; V: bf16 ldmatrix over 8 rows, int8 the rows
  // 2c.. at chunk g + 8i) lands on 8 distinct 16-byte bank groups
  static __device__ __forceinline__ int swz(int r) {
    r &= 7;
    return INT8 ? ((r & 6) ^ ((r & 1) << 2)) : (((r & 1) << 2) | (r >> 1));
  }
  // the head-dim element of the first of the 4 values lane (g, c) takes
  // at k step kk (of kSteps) of S^T = K Q^T: its K reads are whole 16-byte
  // chunks (bf16: chunks c, c + 4, c + 8, ...; int8: c, c + 4, ...), and the
  // sum over d does not care which k slot holds which d, as long as K's and
  // Q's fragments agree
  static __device__ __forceinline__ int kdim(int kk, int c) {
    return INT8 ? 16 * (c + 4 * (kk >> 2)) + 4 * (kk & 3)
                : 8 * (4 * (kk >> 1) + c) + 4 * (kk & 1);
  }
  // the slot 16 mt + r (row r of O^T's m-tile mt) that holds head-dim
  // element d (bf16: ldmatrix.trans gives m-tile mt elements 16mt..16mt+15;
  // int8: lane g reads V's chunks g + 8i, m-tile 8i + mt' takes their
  // elements 2mt' (row g) and 2mt' + 1 (row g + 8))
  static __device__ __forceinline__ int slot(int d) {
    return INT8 ? 16 * (8 * (d / 128) + (d % 16) / 2) + (d / 16) % 8 +
                      8 * (d & 1)
                : d;
  }
};

__device__ __forceinline__ uint4 lds128(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint32_t word(const uint4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// grid (nsplit, ceil(S * G / 8), B * Hkv), block kPThreads, dynamic
// shared memory Mma<INT8, PD>::kSmem: the splits vary fastest, so the CTAs
// of one (b, h) start together (a deep row's splits are not queued behind
// the many dead splits of the shallow rows).  CTA (split, y, bh) takes
// query rows [8y, 8y + 8) of kv head h = bh % Hkv of row b = bh / Hkv
// (row rr is query offset rr / G of q head h * G + rr % G) and keys
// [split * split_len, ...) below the tile's live bound.  Warp w walks the
// split's 16-key slices w, w + 4, ...; a slice's two 8-key groups each lie
// in one block or granule (split_len and block_len are multiples of 8).
// A split past the live bound leaves at once, a lone live split writes
// out, and otherwise the last CTA of (bh, y) to finish (counters[bh *
// gridDim.y + y], which it resets to 0) merges the partials in split
// order.  Rows are D elements wide in q, out and the cache (PAD: head_dim
// < PD, D % 8 == 0; else PD) and PD wide in the ring (PD: kPD for D <= 128,
// kPDWide above).  The layout of k,
// v (and of the int8 scales):
//   PAGED: the pool (num_blocks, block_len, Hkv, D), key j of row b at
//     pool row table[b * max_blocks + j / block_len] * block_len + j %
//     block_len; scales (num_blocks, Hkv), a block's row;
//   contiguous: the cache (B, L, Hkv, D) with L = max_blocks * block_len,
//     key j of row b at cache row b * L + j (table unused); int8: scales
//     (B, max_blocks, Hkv) over granules of block_len keys, key j's at
//     row b * max_blocks + j / block_len (bf16: max_blocks 1, block_len L).
template <bool INT8, bool PAGED, bool PAD, int PD>
__global__ void __launch_bounds__(kPThreads, Mma<INT8, PD>::kMinCtas)
decode_mma_kernel(const e16* __restrict__ q,
                  const unsigned char* __restrict__ k,
                  const unsigned char* __restrict__ v,
                  const int* __restrict__ pos,
                  const int* __restrict__ table,
                  e16* __restrict__ out,
                  float* __restrict__ part_o,
                  float* __restrict__ part_ml, int* counters, int S,
                  int Hq, int Hkv, int head_dim, int max_blocks,
                  int block_len, int limit, int split_len, float scale_log2,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale) {
  using P = Mma<INT8, PD>;
  const int D = PAD ? head_dim : PD;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_cta;
  const int bh = blockIdx.z, b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv, rows_total = S * G;
  const int r0 = blockIdx.y * kPRows, nr = min(kPRows, rows_total - r0);
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;

  const int pb = pos[b];
  // keys [0, live) are seen by some row of the tile (its last row the most)
  const int live = min(limit, pb + (r0 + nr - 1) / G + 1);
  const int n_live = live > 0 ? (live + split_len - 1) / split_len : 0;
  const int k_begin = split * split_len;
  const int k_end = min(live, k_begin + split_len);
  // this CTA writes the output itself (no partial, no merge)
  const bool direct = n_live <= 1;
  // element offset of query row rr of the tile's (b, h) in q and out
  auto row_off = [&](int rr) {
    const int si = rr / G;
    return ((size_t)(b * S + si) * Hq + h * G + rr - si * G) * D;
  };
  if (k_end <= k_begin) {
    if (n_live == 0 && split == 0)   // no live key
      for (int r = 0; r < nr; ++r)
        for (int d = tid; d < D; d += kPThreads)
          out[row_off(r0 + r) + d] = to_e16(0.f);
    return;
  }

  // ---- the warp's walk: slice t starts at key slice_key(t) -----------------
  constexpr int kSlice = P::kSlice, kGroups = kSlice / 8;
  static_assert(kSlice == 16, "a slice is one 16-key k step");
  const int n_mine =
      max(0, (k_end - k_begin - kSlice * warp + kSlice * kPWarps - 1) /
                 (kSlice * kPWarps));
  auto slice_key = [&](int t) {
    return k_begin + kSlice * (warp + kPWarps * t);
  };
  const int* trow = PAGED ? table + (size_t)b * max_blocks : nullptr;
  // the scale row of slice t's 8-key groups -- paged, the table's block (0
  // for a group past k_end: the table's dead tail is never read);
  // contiguous, row b's granule, no load (bf16: unused)
  auto blocks = [&](int t, int (&blk)[kGroups]) {
    const int j0 = slice_key(t);
#pragma unroll
    for (int q8 = 0; q8 < kGroups; ++q8) {
      const int j = j0 + 8 * q8;
      if constexpr (PAGED)
        blk[q8] = t < n_mine && j < k_end ? trow[j / block_len] : 0;
      else
        blk[q8] = INT8 ? b * max_blocks + j / block_len : 0;
    }
  };
  unsigned char* ring = smem + warp * P::kStages * P::kStage;
  // bytes of a key's row in the cache (the ring's rows are kRow): chunks at
  // or past them are zero-filled.  An int8 row of D % 16 == 8 bytes starts
  // only 8-byte aligned, where a 16-byte cp.async needs 16: those rows go
  // in 8-byte copies
  const int row_bytes = INT8 ? D : 2 * D;
  const bool half_copies = INT8 && PAD && (D & 15) != 0;
  const size_t head = (size_t)h * row_bytes;
  const size_t key_stride = (size_t)Hkv * row_bytes;
  // contiguous: row b's first cache row
  const size_t row0 = PAGED ? 0 : (size_t)b * max_blocks * block_len;
  // copy slice t into its stage (keys at or past k_end: zeros) and commit
  // one group, empty past the warp's last slice
  auto issue = [&](int t, const int (&blk)[kGroups]) {
    if (t < n_mine) {
      const int j0 = slice_key(t);
      unsigned char* st = ring + (t % P::kStages) * P::kStage;
      // pool (cache) rows of the groups' first keys
      size_t gbase[kGroups];
#pragma unroll
      for (int q8 = 0; q8 < kGroups; ++q8)
        gbase[q8] = PAGED ? (size_t)blk[q8] * block_len +
                                (j0 + 8 * q8) % block_len
                          : row0 + j0 + 8 * q8;
      constexpr int kKeysPerCopy = 32 / P::kChunks;   // bf16 2, int8 4
#pragma unroll
      for (int i = 0; i < kSlice / kKeysPerCopy; ++i) {
        // lanes take consecutive chunks of a row: a copy reads whole rows
        const int kr = kKeysPerCopy * i + lane / P::kChunks;
        const int ch = lane % P::kChunks;
        const bool on = j0 + kr < k_end;
        const size_t prow = gbase[(kKeysPerCopy * i) / 8] + (kr & 7);
        const size_t off = prow * key_stride + head + ch * 16;
        const int dst = kr * P::kRow + ((ch ^ P::swz(kr)) << 4);
        if (half_copies) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool in = on && ch * 16 + 8 * e < row_bytes;
            cp_async8(st + dst + 8 * e, in ? k + off + 8 * e : k, in ? 8 : 0);
            cp_async8(st + P::kTile + dst + 8 * e, in ? v + off + 8 * e : v,
                      in ? 8 : 0);
          }
        } else {
          const bool in = on && (!PAD || ch * 16 < row_bytes);
          cp_async16(st + dst, in ? k + off : k, in ? 16 : 0);
          cp_async16(st + P::kTile + dst, in ? v + off : v, in ? 16 : 0);
        }
      }
      if constexpr (INT8) {
        if (lane < 2 * kGroups) {   // the groups' K scales, then V's
          const int q8 = lane % kGroups;
          const bool on = j0 + 8 * q8 < k_end;
          const float* src = (lane < kGroups ? k_scale : v_scale) +
                             (size_t)blk[q8] * Hkv + h;
          cp_async4(st + 2 * P::kTile + 4 * lane, on ? src : k_scale,
                    on ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // prologue: the table entries of the first kStages + 1 slices, then the
  // copies of the first kStages
  int tb[P::kStages + 1][kGroups];
#pragma unroll
  for (int t = 0; t <= P::kStages; ++t) blocks(t, tb[t]);
#pragma unroll
  for (int t = 0; t < P::kStages; ++t) issue(t, tb[t]);
  int nb[kGroups];
#pragma unroll
  for (int q8 = 0; q8 < kGroups; ++q8) nb[q8] = tb[P::kStages][q8];

  // ---- Q^T as the B fragments of query row g (loaded while the first
  // stages are in flight; zero past D: d is a multiple of 4 and D of 8), and
  // the last key of rows 2c and 2c + 1
  uint32_t qb[P::kSteps][2];
  {
    const bool on = g < nr;
    const e16* qr = q + (on ? row_off(r0 + g) : 0);
#pragma unroll
    for (int kk = 0; kk < P::kSteps; ++kk) {
      const int d = P::kdim(kk, c);
      const bool in = on && (!PAD || d < D);
      qb[kk][0] = in ? *reinterpret_cast<const uint32_t*>(qr + d) : 0u;
      qb[kk][1] = in ? *reinterpret_cast<const uint32_t*>(qr + d + 2) : 0u;
    }
  }
  int last[2];   // row 2c + e keeps key j iff j <= last[e]
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int rl = 2 * c + e;
    last[e] = rl < nr ? min(k_end, pb + (r0 + rl) / G + 1) - 1 : -1;
  }

  // O^T: m-tile mt holds head-dim rows 16 mt + g (acc[mt][0..1]) and
  // 16 mt + g + 8 (acc[mt][2..3]) -- int8: elements 16 g + 2 mt and
  // 16 g + 2 mt + 1 -- of query rows 2c, 2c + 1
  float acc[P::kSteps][4];
#pragma unroll
  for (int n = 0; n < P::kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  // float16 int8: the V scale the accumulator is in units of (see below)
  float vref = 0.f;

  for (int t = 0; t < n_mine; ++t) {
    cp_async_wait<P::kStages - 1>();
    __syncwarp();
    const unsigned char* Ks = ring + (t % P::kStages) * P::kStage;
    const unsigned char* Vs = Ks + P::kTile;
    const int j0 = slice_key(t);

    // S^T = K Q^T over the slice's 16 keys: st[0..1] = key g, st[2..3]
    // = key g + 8, of query rows 2c, 2c + 1 (two chains over the k steps)
    const unsigned char* klo = Ks + g * P::kRow;
    const unsigned char* khi = klo + 8 * P::kRow;
    float st[4] = {0.f, 0.f, 0.f, 0.f}, st2[4] = {0.f, 0.f, 0.f, 0.f};
    // (a 256-wide row: the same over each 128-element half hf, whose k
    // steps are 8 hf .. 8 hf + 7)
    if constexpr (INT8) {
#pragma unroll
      for (int hf = 0; hf < PD / kPD; ++hf) {
        const int c0 = c + 8 * hf;
        const uint4 l0 = lds128(klo + ((c0 ^ P::swz(g)) << 4));
        const uint4 l1 = lds128(klo + (((c0 + 4) ^ P::swz(g)) << 4));
        const uint4 h0 = lds128(khi + ((c0 ^ P::swz(g)) << 4));
        const uint4 h1 = lds128(khi + (((c0 + 4) ^ P::swz(g)) << 4));
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          uint32_t a[4];
          const uint32_t* qf = qb[8 * hf + kk];
          int8x4_to_e16(word(kk < 4 ? l0 : l1, kk & 3), a[0], a[2]);
          int8x4_to_e16(word(kk < 4 ? h0 : h1, kk & 3), a[1], a[3]);
          if (kk & 1) mma_m16n8k16(st2, a, qf[0], qf[1]);
          else mma_m16n8k16(st, a, qf[0], qf[1]);
        }
      }
    } else {
#pragma unroll
      for (int hf = 0; hf < PD / kPD; ++hf) {
        uint4 lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ch = 16 * hf + 4 * i + c;
          lo[i] = lds128(klo + ((ch ^ P::swz(g)) << 4));
          hi[i] = lds128(khi + ((ch ^ P::swz(g)) << 4));
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int x = kk >> 1, y = 2 * (kk & 1);
          const uint32_t a[4] = {word(lo[x], y), word(hi[x], y),
                                 word(lo[x], y + 1), word(hi[x], y + 1)};
          const uint32_t* qf = qb[8 * hf + kk];
          if (kk & 1) mma_m16n8k16(st2, a, qf[0], qf[1]);
          else mma_m16n8k16(st, a, qf[0], qf[1]);
        }
      }
    }

    // scores in the log2 domain (int8: times each 8-key group's K scale),
    // the mask and the online softmax; a row's max over the 8 lanes that
    // hold its keys
    float ksc[2] = {1.f, 1.f}, vsc[2] = {1.f, 1.f};
    if constexpr (INT8) {
      const float* sc = reinterpret_cast<const float*>(Ks + 2 * P::kTile);
      ksc[0] = sc[0];
      ksc[1] = sc[1];
      vsc[0] = sc[2];
      vsc[1] = sc[3];
    }
    const int jlo = j0 + g, jhi = jlo + 8;
    float sc4[4], mx[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc4[e] = jlo <= last[e] ? (st[e] + st2[e]) * scale_log2 * ksc[0]
                              : kNegInf;
      sc4[2 + e] = jhi <= last[e]
                       ? (st[2 + e] + st2[2 + e]) * scale_log2 * ksc[1]
                       : kNegInf;
      mx[e] = fmaxf(m_r[e], fmaxf(sc4[e], sc4[2 + e]));
#pragma unroll
      for (int o = 4; o <= 16; o <<= 1)
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kFull, mx[e], o));
    }
    float al[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      al[e] = exp2f(m_r[e] - mx[e]);
      m_r[e] = mx[e];
      l_r[e] *= al[e];
    }
    if constexpr (INT8 && kHalf) {
      // float16 has 5 exponent bits: P times a small V scale (1e-4) would
      // round into its subnormals.  The slice's two V scales go into P
      // relative to the larger, vm, and the accumulator is kept in units
      // of the latest slice's vm (rescaled with the softmax's alpha), so P
      // keeps its float16 precision and the scale itself is applied in
      // float32, as the reference scales the float32 P.V product
      const float vm = fmaxf(vsc[0], vsc[1]);
      const float inv = vm > 0.f ? 1.f / vm : 0.f;
      const float ra = vm > 0.f ? vref * inv : 1.f;
      al[0] *= ra;
      al[1] *= ra;
      vsc[0] *= inv;
      vsc[1] *= inv;
      vref = vm > 0.f ? vm : vref;
    }
    // a running max that did not move leaves the accumulator as it is
    if (__any_sync(kFull, al[0] != 1.f || al[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < P::kSteps; ++n) {
        acc[n][0] *= al[0];
        acc[n][1] *= al[1];
        acc[n][2] *= al[0];
        acc[n][3] *= al[1];
      }
    }
    float pr[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      pr[e] = jlo <= last[e] ? exp2f(sc4[e] - m_r[e]) : 0.f;
      pr[2 + e] = jhi <= last[e] ? exp2f(sc4[2 + e] - m_r[e]) : 0.f;
      l_r[e] += pr[e] + pr[2 + e];
    }
    // P^T in 16 bits as the B operand (int8: times each key's V scale; the
    // row sums take it unscaled): lane (g, c) holds the 8x8 blocks' (key
    // g, rows 2c..2c+1); movmatrix's transpose gives (keys 2c..2c+1, row
    // g)
    const uint32_t b0 = movmatrix_trans(
        pack16(pr[0] * vsc[0], pr[1] * vsc[0]));
    const uint32_t b1 = movmatrix_trans(
        pack16(pr[2] * vsc[1], pr[3] * vsc[1]));

    // O^T += V^T P^T over the slice's 16 keys
    if constexpr (INT8) {
      // lane (g, c) reads V's chunks g + 8 hf (elements 16 (g + 8 hf)..,
      // hf a 128-element half) of the rows 2c, 2c + 1, 2c + 8, 2c + 9 its
      // A fragments take; m-tile 8 hf + mt takes elements 2mt (row g) and
      // 2mt + 1 (row g + 8) of the chunk
      const int ra = 2 * c;
#pragma unroll
      for (int hf = 0; hf < PD / kPD; ++hf) {
        const int cg = g + 8 * hf;
        const uint4 x0 =
            lds128(Vs + ra * P::kRow + ((cg ^ P::swz(ra)) << 4));
        const uint4 x1 =
            lds128(Vs + (ra + 1) * P::kRow + ((cg ^ P::swz(ra + 1)) << 4));
        const uint4 x2 =
            lds128(Vs + (ra + 8) * P::kRow + ((cg ^ P::swz(ra)) << 4));
        const uint4 x3 =
            lds128(Vs + (ra + 9) * P::kRow + ((cg ^ P::swz(ra + 1)) << 4));
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          uint32_t a0[4], a1[4];   // m-tiles 8 hf + 2y, 8 hf + 2y + 1
          int8x4_to_e16(__byte_perm(word(x0, y), word(x1, y), 0x5140),
                         a0[0], a0[1]);
          int8x4_to_e16(__byte_perm(word(x2, y), word(x3, y), 0x5140),
                         a0[2], a0[3]);
          int8x4_to_e16(__byte_perm(word(x0, y), word(x1, y), 0x7362),
                         a1[0], a1[1]);
          int8x4_to_e16(__byte_perm(word(x2, y), word(x3, y), 0x7362),
                         a1[2], a1[3]);
          mma_m16n8k16(acc[8 * hf + 2 * y], a0, b0, b1);
          mma_m16n8k16(acc[8 * hf + 2 * y + 1], a1, b0, b1);
        }
      }
    } else {
      // ldmatrix.trans: lanes 8i..8i+7 address matrix i = keys
      // 8(i >> 1).., head-dim chunk 2mt + (i & 1)
      const int vk = (lane >> 4) * 8 + (lane & 7);
      const unsigned char* vr = Vs + vk * P::kRow;
#pragma unroll
      for (int mt = 0; mt < P::kSteps; ++mt) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, vr + (((2 * mt + ((lane >> 3) & 1)) ^
                                    P::swz(vk)) << 4));
        mma_m16n8k16(acc[mt], a, b0, b1);
      }
    }

    __syncwarp();   // every lane is done with the stage
    issue(t + P::kStages, nb);
    blocks(t + P::kStages + 1, nb);
  }
  cp_async_wait<0>();

  // ---- merge the warps, then write the output or the split's partial ------
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1)
      l_r[e] += __shfl_xor_sync(kFull, l_r[e], o);
  __syncthreads();   // every warp is done with its ring
  float* wacc = reinterpret_cast<float*>(smem);       // [warp][row][slot]
  float* wm = wacc + kPWarps * kPRows * P::kMStride;  // [warp][row]
  float* wl = wm + kPWarps * kPRows;
#pragma unroll
  for (int n = 0; n < P::kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* row =
          wacc + (warp * kPRows + 2 * c + e) * P::kMStride + 16 * n + g;
      if constexpr (INT8 && kHalf) {
        row[0] = acc[n][e] * vref;
        row[8] = acc[n][2 + e] * vref;
      } else {
        row[0] = acc[n][e];
        row[8] = acc[n][2 + e];
      }
    }
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      wm[warp * kPRows + 2 * c + e] = m_r[e];
      wl[warp * kPRows + 2 * c + e] = l_r[e];
    }
  }
  __syncthreads();
  // thread tid merges head-dim elements d = tid + kPThreads * e of every
  // row (elements at or past D: no thread)
  auto mine = [&](int e) { return tid + kPThreads * e; };
  auto in_d = [&](int e) { return !PAD || mine(e) < D; };
  for (int r = 0; r < (in_d(0) ? nr : 0); ++r) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kPWarps; ++w)
      if (wl[w * kPRows + r] > 0.f) M = fmaxf(M, wm[w * kPRows + r]);
    float lsum = 0.f, o[P::kEPT];
#pragma unroll
    for (int e = 0; e < P::kEPT; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kPWarps; ++w) {
      const float lw = wl[w * kPRows + r];
      if (lw > 0.f) {
        const float cf = exp2f(wm[w * kPRows + r] - M);
        lsum += lw * cf;
#pragma unroll
        for (int e = 0; e < P::kEPT; ++e)
          o[e] += wacc[(w * kPRows + r) * P::kMStride + P::slot(mine(e))] *
                  cf;
      }
    }
    const int rr = r0 + r;
    const size_t pi = ((size_t)bh * nsplit + split) * rows_total + rr;
#pragma unroll
    for (int e = 0; e < P::kEPT; ++e) {
      if (!in_d(e)) continue;
      if (direct)
        out[row_off(rr) + mine(e)] =
            to_e16(lsum > 0.f ? o[e] / lsum : 0.f);
      else
        part_o[pi * D + mine(e)] = o[e];
    }
    if (!direct && tid == 0) {
      part_ml[2 * pi] = M * kLn2;   // natural-log units, as the merge's
      part_ml[2 * pi + 1] = lsum;
    }
  }
  if (direct) return;

  // ---- the last of the tile's live splits to finish merges them -----------
  __threadfence();   // this CTA's partial is visible before it counts
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + bh * gridDim.y + blockIdx.y;
    const int prev = atomicAdd(cnt, 1);
    last_cta = prev == n_live - 1;
    if (last_cta) *cnt = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last_cta) return;
  __threadfence();
  // each row's max over the live splits (lanes stride the splits), then
  // the splits' weights exp(m - M) and l * exp(m - M) a chunk at a time in
  // shared memory; thread tid sums elements tid + kPThreads * e (< D) of
  // every row, in split order
  const float2* ml = reinterpret_cast<const float2*>(part_ml);
  const size_t p0 = (size_t)bh * nsplit * rows_total + r0;
  float* rmax = reinterpret_cast<float*>(smem);   // [row]
  float* ws = rmax + kPRows;                  // [split in chunk][row]
  float* wls = ws + kMergeChunk * kPRows;
  for (int r = warp; r < nr; r += kPWarps) {
    float M = kNegInf;
    for (int sp = lane; sp < n_live; sp += 32) {
      const float2 x = __ldcg(ml + p0 + (size_t)sp * rows_total + r);
      if (x.y > 0.f) M = fmaxf(M, x.x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
    if (lane == 0) rmax[r] = M;
  }
  __syncthreads();
  float o[P::kEPT][kPRows], lsum[kPRows];
#pragma unroll
  for (int r = 0; r < kPRows; ++r) {
    lsum[r] = 0.f;
#pragma unroll
    for (int e = 0; e < P::kEPT; ++e) o[e][r] = 0.f;
  }
  for (int sp0 = 0; sp0 < n_live; sp0 += kMergeChunk) {
    const int n = min(kMergeChunk, n_live - sp0);
    for (int i = tid; i < n * nr; i += kPThreads) {
      const int sp = sp0 + i / nr, r = i % nr;
      const float2 x = __ldcg(ml + p0 + (size_t)sp * rows_total + r);
      const float w = x.y > 0.f ? expf(x.x - rmax[r]) : 0.f;
      ws[i] = w;
      wls[i] = x.y * w;
    }
    __syncthreads();
    if (in_d(0)) {
#pragma unroll 8
      for (int kk = 0; kk < n; ++kk) {
        const float* po = part_o + (p0 + (size_t)(sp0 + kk) * rows_total) * D;
#pragma unroll
        for (int r = 0; r < kPRows; ++r)
          if (r < nr) {
            const float w = ws[kk * nr + r];
#pragma unroll
            for (int e = 0; e < P::kEPT; ++e)
              if (in_d(e)) o[e][r] += __ldcg(po + r * D + mine(e)) * w;
            lsum[r] += wls[kk * nr + r];
          }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < P::kEPT; ++e) {
    if (!in_d(e)) continue;
#pragma unroll
    for (int r = 0; r < kPRows; ++r)
      if (r < nr)
        out[row_off(r0 + r) + mine(e)] =
            to_e16(lsum[r] > 0.f ? o[e][r] / lsum[r] : 0.f);
  }
}

// the kernel's dynamic shared memory limit and a shared-memory-first
// carveout, set once a build: 3 narrow CTAs an SM need 3 x 64 KB of the 228
template <bool INT8, bool PAGED, bool PAD, int PD>
cudaError_t mma_attributes() {
  static bool done = false;
  if (done) return cudaSuccess;
  const auto kernel = decode_mma_kernel<INT8, PAGED, PAD, PD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Mma<INT8, PD>::kSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  done = e == cudaSuccess;
  return e;
}

// CTAs of one build of decode_mma_kernel that fit on one SM at once
template <bool INT8, bool PAGED, bool PAD, int PD>
cudaError_t mma_ctas_per_sm(int* n) {
  const cudaError_t e = mma_attributes<INT8, PAGED, PAD, PD>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, decode_mma_kernel<INT8, PAGED, PAD, PD>, kPThreads,
      Mma<INT8, PD>::kSmem);
}

// the head dims every build takes, the Hopper body's and the float32
// CUDA-core body's: D <= kPDWide, D % 8 == 0
bool head_dim_built(int D) { return D >= 8 && D <= kPDWide && D % 8 == 0; }

// one instance of the Hopper kernel, one launch
template <bool INT8, bool PAGED, bool PAD, int PD>
cudaError_t launch_mma_at(const void* q, const void* k, const void* v,
                          const int* pos, const int* table, void* out,
                          float* part_o, float* part_ml, int* counters,
                          int B, int S, int Hq, int Hkv, int D,
                          int max_blocks, int block_len, int limit,
                          int split_len, int nsplit, float scale,
                          const float* k_scale, const float* v_scale,
                          cudaStream_t st) {
  const cudaError_t e = mma_attributes<INT8, PAGED, PAD, PD>();
  if (e != cudaSuccess) return e;
  const int rows_total = S * (Hq / Hkv);
  const dim3 grid(nsplit, (rows_total + kPRows - 1) / kPRows, B * Hkv);
  decode_mma_kernel<INT8, PAGED, PAD, PD>
      <<<grid, kPThreads, Mma<INT8, PD>::kSmem, st>>>(
          static_cast<const e16*>(q),
          static_cast<const unsigned char*>(k),
          static_cast<const unsigned char*>(v), pos, table,
          static_cast<e16*>(out), part_o, part_ml, counters, S,
          Hq, Hkv, D, max_blocks, block_len, limit, split_len,
          scale * 1.4426950408889634f, k_scale, v_scale);
  return cudaSuccess;
}

// K1 / K1-int8 / K1-paged / K1-paged-int8 at 16-bit q, head_dim D: the Hopper
// kernel (max_blocks, block_len: see decode_mma_kernel).  D 128 and 256 run
// instances of constant D; below 128 the PAD instance on 128-wide ring
// rows, between them the PAD instance on 256-wide ones
template <bool INT8, bool PAGED>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* pos, const int* table, void* out,
                       float* part_o, float* part_ml, int* counters, int B,
                       int S, int Hq, int Hkv, int D, int max_blocks,
                       int block_len, int limit, int split_len, int nsplit,
                       float scale, const float* k_scale,
                       const float* v_scale, cudaStream_t st) {
  const auto fn = D == kPD       ? launch_mma_at<INT8, PAGED, false, kPD>
                  : D < kPD      ? launch_mma_at<INT8, PAGED, true, kPD>
                  : D == kPDWide ? launch_mma_at<INT8, PAGED, false, kPDWide>
                                 : launch_mma_at<INT8, PAGED, true, kPDWide>;
  return fn(q, k, v, pos, table, out, part_o, part_ml, counters, B, S, Hq,
            Hkv, D, max_blocks, block_len, limit, split_len, nsplit, scale,
            k_scale, v_scale, st);
}

template <typename T, int EPL, int KPI, bool PAGED, typename KV = T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, void* out, float* part_o, float* part_ml,
                   int B, int S, int Hq, int Hkv, int D, int L, int limit,
                   int split_len, int nsplit, float scale, cudaStream_t st,
                   const int* table = nullptr, int max_blocks = 0,
                   int block_len = 0, const float* k_scale = nullptr,
                   const float* v_scale = nullptr, int n_gran = 0,
                   int gran_len = 0) {
  const int rows_total = S * (Hq / Hkv);
  dim3 grid(B * Hkv, (rows_total + kRows - 1) / kRows, nsplit);
  decode_attention_kernel<T, KV, EPL, KPI, PAGED><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), pos, static_cast<T*>(out), part_o, part_ml,
      S, Hq, Hkv, D, L, limit, split_len, scale, table, max_blocks,
      block_len, k_scale, v_scale, n_gran, gran_len);
  if (nsplit > 1) {
    decode_attention_combine<T><<<dim3(B * Hkv, rows_total), D, 0, st>>>(
        part_o, part_ml, static_cast<T*>(out), S, Hq, Hkv, D, nsplit);
  }
  return cudaSuccess;
}

// the float32 CUDA-core instance of head dim D (any D <= 256 with D % 8 ==
// 0): the least EPL with 32 * EPL >= D, 8 keys a block (at EPL 8: 4, and
// 2 over the int8 cache, whose scales and conversions spilled at 4)
template <bool PAGED, typename KV = float>
cudaError_t f32_launch(const void* q, const void* k, const void* v,
                       const int* pos, void* out, float* part_o,
                       float* part_ml, int B, int S, int Hq, int Hkv, int D,
                       int L, int limit, int split_len, int nsplit,
                       float scale, cudaStream_t st,
                       const int* table = nullptr, int max_blocks = 0,
                       int block_len = 0, const float* k_scale = nullptr,
                       const float* v_scale = nullptr, int n_gran = 0,
                       int gran_len = 0) {
  const auto fn = D <= 32    ? launch<float, 1, 8, PAGED, KV>
                  : D <= 64  ? launch<float, 2, 8, PAGED, KV>
                  : D <= 128 ? launch<float, 4, 8, PAGED, KV>
                  : std::is_same<KV, int8_t>::value
                      ? launch<float, 8, 2, PAGED, KV>
                      : launch<float, 8, 4, PAGED, KV>;
  return fn(q, k, v, pos, out, part_o, part_ml, B, S, Hq, Hkv, D, L, limit,
            split_len, nsplit, scale, st, table, max_blocks, block_len,
            k_scale, v_scale, n_gran, gran_len);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32, 2 = float16.  The default library is
// built for bfloat16 (the Hopper kernel, decode_mma_kernel) and float32
// (the CUDA-core kernel) at any D <= 256 with D % 8 == 0 (head_dim_built);
// the library compiled with -DPTT_F16 for float16 alone, at the same head
// dims (the Hopper body over float16).  Those are the cases chip_smoke.py
// checks on the card; any other pair returns cudaErrorInvalidValue, as
// does a split_len that is not a multiple of 8.  q, k, v 16-byte aligned.  part_o /
// part_ml are float32 scratch of (B*Hkv, nsplit, S*G, D) and (B*Hkv,
// nsplit, S*G, 2), unused when nsplit == 1.  counters (16-bit q only; the
// float32 build ignores it) is an int32 array of B * Hkv * ceil(S * G /
// 8) zeros, one a (row, kv head, 8-row tile), which each launch leaves
// zero; launches that may run at the same time (other streams) need
// arrays of their own.  Returns cudaGetLastError() after the launches.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* pos, void* out, void* part_o,
                                void* part_ml, void* counters, int B, int S,
                                int Hq, int Hkv, int D, int L, int limit,
                                int split_len, int nsplit, float scale,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (Hkv < 1 || Hq % Hkv != 0 || L < 1 || split_len % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == kE16Code && head_dim_built(D))
    e = launch_mma<false, false>(q, k, v, p, nullptr, out, po, pml,
                                 static_cast<int*>(counters), B, S, Hq, Hkv,
                                 D, 1, L, limit, split_len, nsplit, scale,
                                 nullptr, nullptr, st);
#ifndef PTT_F16
  else if (dtype == 1 && head_dim_built(D))
    e = f32_launch<false>(q, k, v, p, out, po, pml, B, S, Hq, Hkv, D, L,
                          limit, split_len, nsplit, scale, st);
#endif
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The paged entry: k, v are one layer's (num_blocks, block_len, Hkv, D)
// pool, table the int32 (B, max_blocks) block table (every entry a valid
// block id); the logical cache length is max_blocks * block_len and
// limit <= that bound.  block_len and split_len must be multiples of 8
// (cudaErrorInvalidValue otherwise); dtype/D pairs, scratch and counters
// as in decode_attention.
extern "C" int decode_attention_paged(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      const void* table, void* out,
                                      void* part_o, void* part_ml,
                                      void* counters, int B, int S, int Hq,
                                      int Hkv, int D, int max_blocks,
                                      int block_len, int limit,
                                      int split_len, int nsplit, float scale,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(table);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (Hkv < 1 || Hq % Hkv != 0 || block_len < 8 || block_len % 8 != 0 ||
      split_len % 8 != 0 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = max_blocks * block_len;
  cudaError_t e;
  if (dtype == kE16Code && head_dim_built(D))
    e = launch_mma<false, true>(q, k, v, p, t, out, po, pml,
                                static_cast<int*>(counters), B, S, Hq, Hkv,
                                D, max_blocks, block_len, limit, split_len,
                                nsplit, scale, nullptr, nullptr, st);
#ifndef PTT_F16
  else if (dtype == 1 && head_dim_built(D))
    e = f32_launch<true>(q, k, v, p, out, po, pml, B, S, Hq, Hkv, D, L,
                         limit, split_len, nsplit, scale, st, t, max_blocks,
                         block_len);
#endif
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The int8 contiguous entry: k, v int8 (B, L, Hkv, D); k_scale, v_scale
// float32 (B, n_gran, Hkv) over granules of L / n_gran positions, which
// must be a multiple of 8, as must split_len (cudaErrorInvalidValue
// otherwise).  q, out, dtype/D pairs, scratch and counters as in
// decode_attention.
extern "C" int decode_attention_int8(const void* q, const void* k,
                                     const void* v, const void* k_scale,
                                     const void* v_scale, const void* pos,
                                     void* out, void* part_o, void* part_ml,
                                     void* counters, int B, int S, int Hq,
                                     int Hkv, int D, int L, int n_gran,
                                     int limit, int split_len, int nsplit,
                                     float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (Hkv < 1 || Hq % Hkv != 0 || n_gran < 1 || L % n_gran != 0 ||
      (L / n_gran) % 8 != 0 || split_len % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gran_len = L / n_gran;
  cudaError_t e;
  if (dtype == kE16Code && head_dim_built(D))
    e = launch_mma<true, false>(q, k, v, p, nullptr, out, po, pml,
                                static_cast<int*>(counters), B, S, Hq, Hkv,
                                D, n_gran, gran_len, limit, split_len, nsplit,
                                scale, ks, vs, st);
#ifndef PTT_F16
  else if (dtype == 1 && head_dim_built(D))
    e = f32_launch<false, int8_t>(q, k, v, p, out, po, pml, B, S, Hq, Hkv, D,
                                  L, limit, split_len, nsplit, scale, st,
                                  nullptr, 0, 0, ks, vs, n_gran, gran_len);
#endif
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The int8 paged entry: k, v one layer's int8 (num_blocks, block_len, Hkv,
// D) pool, k_scale / v_scale float32 (num_blocks, Hkv); everything else as
// in decode_attention_paged.
extern "C" int decode_attention_paged_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* pos, const void* table, void* out,
    void* part_o, void* part_ml, void* counters, int B, int S, int Hq,
    int Hkv, int D, int max_blocks, int block_len, int limit, int split_len,
    int nsplit, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(table);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (Hkv < 1 || Hq % Hkv != 0 || block_len < 8 || block_len % 8 != 0 ||
      split_len % 8 != 0 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = max_blocks * block_len;
  cudaError_t e;
  if (dtype == kE16Code && head_dim_built(D))
    e = launch_mma<true, true>(q, k, v, p, t, out, po, pml,
                               static_cast<int*>(counters), B, S, Hq, Hkv,
                               D, max_blocks, block_len, limit, split_len,
                               nsplit, scale, ks, vs, st);
#ifndef PTT_F16
  else if (dtype == 1 && head_dim_built(D))
    e = f32_launch<true, int8_t>(q, k, v, p, out, po, pml, B, S, Hq, Hkv, D,
                                 L, limit, split_len, nsplit, scale, st, t,
                                 max_blocks, block_len, ks, vs);
#endif
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the Hopper build (int8: 0 bf16 K/V, 1 int8; paged: 0
// contiguous, 1 paged) that runs head_dim D (its instance: see launch_mma)
// that fit on one SM at once, or minus a CUDA error (cudaErrorInvalidValue
// for a head_dim it does not take)
template <bool INT8, bool PAGED>
cudaError_t ctas_per_sm(int D, int* n) {
  if (!head_dim_built(D)) return cudaErrorInvalidValue;
  return D == kPD        ? mma_ctas_per_sm<INT8, PAGED, false, kPD>(n)
         : D < kPD       ? mma_ctas_per_sm<INT8, PAGED, true, kPD>(n)
         : D == kPDWide  ? mma_ctas_per_sm<INT8, PAGED, false, kPDWide>(n)
                         : mma_ctas_per_sm<INT8, PAGED, true, kPDWide>(n);
}

extern "C" int decode_attention_mma_ctas_per_sm(int int8, int paged,
                                                int head_dim) {
  int n = 0;
  const cudaError_t e =
      int8 ? (paged ? ctas_per_sm<true, true>(head_dim, &n)
                    : ctas_per_sm<true, false>(head_dim, &n))
           : (paged ? ctas_per_sm<false, true>(head_dim, &n)
                    : ctas_per_sm<false, false>(head_dim, &n));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

namespace {
// the library's int8 -> 16-bit conversion (int8x4_to_e16) of every byte:
// word i holds bytes 4i..4i+3, out[j] the 16-bit value of byte j
__global__ void int8_table_kernel(uint32_t* out) {
  const int i = threadIdx.x;
  const uint32_t w = 0x03020100u + 0x04040404u * i;
  int8x4_to_e16(w, out[2 * i], out[2 * i + 1]);
}
}  // namespace

// Writes the 16-bit values (the library's type) of the 256 bytes 0..255 as
// int8 into out (256 x 2 bytes), through the kernels' own converter.
extern "C" int decode_attention_int8_table(void* out, void* stream) {
  int8_table_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
