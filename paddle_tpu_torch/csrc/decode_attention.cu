// Flash-decode over a contiguous or paged KV cache: kernel K1 of
// paddle_tpu_torch.
//
// Replaces paddle_tpu/ops/pallas/decode_attention.py::decode_attention_pallas
// (body _kernel :120), contiguous and paged layouts.  For query row
// (b, si, h):
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
//     block_len and the split length are multiples of 8, so a warp's
//     8-key group never straddles a block: one table lookup per group.
//
// Bound on the H100: memory.  The live K+V bytes over 3.35 TB/s; at S = 1 a
// key feeds G query rows, about one operation per byte.  The design:
//   * a CTA owns one (row b, kv head h) pair, up to kRows of its G*S query
//     rows, and one split of the key axis; it reads keys only below
//     pos[b] + (its last query offset) + 1 -- the dead cache tail is never
//     read, so a tick costs what the rows' depths need, not L;
//   * splits (split_len keys each) spread the walk over CTAs so B x Hkv
//     pairs fill the card; each split writes an unnormalised (acc, m, l)
//     partial and decode_attention_combine merges them with the LSE
//     algebra (paddle_tpu/ops/ring_attention.py::merge_attention);
//   * within a split, each of a CTA's 4 warps walks its own 8-key blocks
//     (interleaved with the other warps) with its own online softmax and
//     no barrier: lane l holds head-dim elements [l*D/32, (l+1)*D/32) of
//     the queries, the accumulator and the keys' K/V rows, which arrive
//     straight from device memory in 8-byte vectors (bf16, D = 128); the
//     8 keys' dot products are summed across lanes by a transpose-reduce
//     (9 shuffles a row instead of 40); the warps merge once at the end.
//
// int8 cache (entries decode_attention_int8 / decode_attention_paged_int8;
// replaces the Pallas kernel's quantized mode, decode_attention.py
// :122-128, :160-171, :186-187): K and V hold int8 with one float32 scale
// per (granule or block, kv head) -- contiguous k_scale / v_scale (B,
// n_gran, Hkv) over granules of L / n_gran positions, paged (num_blocks,
// Hkv).  The bytes a key costs halve.  Granules, blocks and splits are
// multiples of 8, so a warp's 8-key group lies in one granule or block and
// its two scales are loaded once a group and folded as the Pallas body
// folds them: K's into the group's scores (q . k_int8 * scale * k_scale),
// V's into the group's probabilities before they weight V (equal to
// scaling P.V); the running sum l takes the unscaled probabilities.  The
// int8 -> float conversion is exact.  The bf16/f32 instantiations are the
// code above, unchanged (INT8 = false removes every int8 branch).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                        // query rows per CTA
constexpr int kMaxD = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive elements at p (aligned to N * sizeof(T), at most 16 bytes
// a load) widened to float
template <typename T, int N>
__device__ __forceinline__ void load_float(const T* __restrict__ p,
                                           float (&o)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes >= 16) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) o[c * kPer + i] = to_float(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_float(e[i]);
  } else if constexpr (kBytes == 4) {
    const unsigned raw = *reinterpret_cast<const unsigned*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_float(e[i]);
  } else {
    o[0] = to_float(p[0]);
  }
}

// grid (B * Hkv, ceil(S*G / kRows), nsplit), block kThreads.
// Lane l of a warp owns head-dim elements [l*EPL, l*EPL + EPL) (D = 32*EPL,
// or D = 16 with EPL = 1 and lanes 16..31 idle).  Built for bfloat16 at
// D = 128 (EPL 4) and float32 at D = 16 (EPL 1).  Each warp walks blocks
// of KPI keys of the split, interleaved with the other warps, keeping its
// own online-softmax state; the warps merge once at the end.
// PAGED selects the K/V addressing: false = contiguous (table, max_blocks
// and block_len unused; the same code as the contiguous-only build),
// true = pool + block table with L = max_blocks * block_len.  KV is the
// cache's element type: T, or int8_t for the int8 cache, whose scales
// (k_scale, v_scale; n_gran and gran_len for the contiguous layout) are
// unused otherwise.
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
            from_float<T>(0.f);
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
      load_float<T, EPL>(q + ((size_t)(b * S + si) * Hq + h * G + gi) * D + d0,
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
        load_float<KV, EPL>(kb + r * key_stride, kf[kk]);
        load_float<KV, EPL>(vb + r * key_stride, vf[kk]);
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
  __shared__ float wacc[kWarps][kRows][kMaxD];
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
          from_float<T>(lsum > 0.f ? o / lsum : 0.f);
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
      from_float<T>(lsum > 0.f ? o / lsum : 0.f);
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

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  Built for bfloat16 at D = 128 (the
// serving path) and float32 at D = 16 (the tiny test model), the two cases
// chip_smoke.py checks on the card; any other pair returns
// cudaErrorInvalidValue.  q, k, v 16-byte aligned.  part_o / part_ml are float32 scratch of
// (B*Hkv, nsplit, S*G, D) and (B*Hkv, nsplit, S*G, 2), unused when
// nsplit == 1.  Returns cudaGetLastError() after the launches.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* pos, void* out, void* part_o,
                                void* part_ml, int B, int S, int Hq, int Hkv,
                                int D, int L, int limit, int split_len,
                                int nsplit, float scale, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0 && D == 128)
    e = launch<__nv_bfloat16, 4, 8, false>(q, k, v, p, out, po, pml, B, S,
                                           Hq, Hkv, D, L, limit, split_len,
                                           nsplit, scale, st);
  else if (dtype == 1 && D == 16)
    e = launch<float, 1, 8, false>(q, k, v, p, out, po, pml, B, S, Hq, Hkv,
                                   D, L, limit, split_len, nsplit, scale, st);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The paged entry: k, v are one layer's (num_blocks, block_len, Hkv, D)
// pool, table the int32 (B, max_blocks) block table (every entry a valid
// block id); the logical cache length is max_blocks * block_len and
// limit <= that bound.  block_len and split_len must be multiples of 8
// (cudaErrorInvalidValue otherwise); dtype/D pairs and scratch as above.
extern "C" int decode_attention_paged(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      const void* table, void* out,
                                      void* part_o, void* part_ml, int B,
                                      int S, int Hq, int Hkv, int D,
                                      int max_blocks, int block_len,
                                      int limit, int split_len, int nsplit,
                                      float scale, int dtype, void* stream) {
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
  if (dtype == 0 && D == 128)
    e = launch<__nv_bfloat16, 4, 8, true>(q, k, v, p, out, po, pml, B, S, Hq,
                                          Hkv, D, L, limit, split_len, nsplit,
                                          scale, st, t, max_blocks,
                                          block_len);
  else if (dtype == 1 && D == 16)
    e = launch<float, 1, 8, true>(q, k, v, p, out, po, pml, B, S, Hq, Hkv,
                                  D, L, limit, split_len, nsplit, scale, st,
                                  t, max_blocks, block_len);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The int8 contiguous entry: k, v int8 (B, L, Hkv, D); k_scale, v_scale
// float32 (B, n_gran, Hkv) over granules of L / n_gran positions, which
// must be a multiple of 8, as must split_len (cudaErrorInvalidValue
// otherwise).  q, out, dtype/D pairs and scratch as in decode_attention.
extern "C" int decode_attention_int8(const void* q, const void* k,
                                     const void* v, const void* k_scale,
                                     const void* v_scale, const void* pos,
                                     void* out, void* part_o, void* part_ml,
                                     int B, int S, int Hq, int Hkv, int D,
                                     int L, int n_gran, int limit,
                                     int split_len, int nsplit, float scale,
                                     int dtype, void* stream) {
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
  if (dtype == 0 && D == 128)
    e = launch<__nv_bfloat16, 4, 8, false, int8_t>(
        q, k, v, p, out, po, pml, B, S, Hq, Hkv, D, L, limit, split_len,
        nsplit, scale, st, nullptr, 0, 0, ks, vs, n_gran, gran_len);
  else if (dtype == 1 && D == 16)
    e = launch<float, 1, 8, false, int8_t>(
        q, k, v, p, out, po, pml, B, S, Hq, Hkv, D, L, limit, split_len,
        nsplit, scale, st, nullptr, 0, 0, ks, vs, n_gran, gran_len);
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
    void* part_o, void* part_ml, int B, int S, int Hq, int Hkv, int D,
    int max_blocks, int block_len, int limit, int split_len, int nsplit,
    float scale, int dtype, void* stream) {
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
  if (dtype == 0 && D == 128)
    e = launch<__nv_bfloat16, 4, 8, true, int8_t>(
        q, k, v, p, out, po, pml, B, S, Hq, Hkv, D, L, limit, split_len,
        nsplit, scale, st, t, max_blocks, block_len, ks, vs);
  else if (dtype == 1 && D == 16)
    e = launch<float, 1, 8, true, int8_t>(
        q, k, v, p, out, po, pml, B, S, Hq, Hkv, D, L, limit, split_len,
        nsplit, scale, st, t, max_blocks, block_len, ks, vs);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
