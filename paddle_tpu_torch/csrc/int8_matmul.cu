// Weight-only int8 GEMM: kernel K4 of paddle_tpu_torch.
//
// Replaces paddle_tpu/ops/pallas/int8_matmul.py::int8_matmul_pallas (body
// _kernel :38-54): out[r, n] = (sum_k x[r, k] * w8[k, n]) * scale[n], x
// (rows, K) bfloat16, float16 or float32, w8 (K, N) int8 row-major, scale (N,)
// float32 per output column, out (rows, N) in x's dtype.  The int8 -> float
// conversion happens in registers, the sums are float32, and the scale is
// applied once in the epilogue (it commutes with the sum over k), as the
// Pallas kernel does at its last K step.
//
// Bound on the H100: the int8 weight stream (K * N bytes over 3.35 TB/s)
// at decode's 8 rows; the tensor cores (2 * rows * K * N operations over
// 989 TFLOP/s) from about 150 rows up.
//
// 16-bit x (the library's e16: bfloat16, or float16 in the library
// compiled with -DPTT_F16; mma_bf16.cuh): tensor cores (wgmma) with the
// operands swapped, out^T =
// w8^T . x^T, so the output columns are wgmma's M and the rows its N:
//   * a CTA owns 128 output columns (two consumer warpgroups of 64) and
//     every row (1..256, rounded up to N = 8, 16, 32, 64, 128 or 256), so
//     it reads each weight byte from device memory once a launch at every
//     row count, and a decode tick's 8 rows are one n = 8 product;
//   * one producer warp streams 64-deep k slices by TMA into a ring of
//     shared-memory stages (full / empty mbarriers): the (64 k x 128 n)
//     int8 weight tile, 128-byte swizzled, through a tensor map encoded
//     once per weight (the wrapper caches it), and the (N x 64 k) 16-bit x
//     tile, K-major, wgmma's B operand (rows past `rows` and k past K load
//     as zero);
//   * consumers read the int8 tile with ldmatrix.trans, treating byte
//     pairs as 16-bit elements: a lane receives w8[k, n..n+1] and
//     w8[k+1, n..n+1], which byte permutes and subtractions (exact;
//     int8x4_to_e16x2x2) turn into two 16-bit pairs -- the register A
//     fragments of output columns n and n+1.  So a warp's accumulator row
//     g holds column 2g and row g + 8 column 2g + 1, undone in the
//     epilogue; the tile is converted in registers once and never written
//     back to shared memory;
//   * each consumer keeps one stage's products in flight
//     (wgmma.wait_group 1) while it converts the next;
//   * where N alone gives too few CTAs (k_proj / v_proj at N = 1024, q_proj
//     / o_proj at 4096), K is split across CTAs up to one wave on the 132
//     SMs (the wrapper's split rule); split partials (float32) are summed
//     and scaled by a second small kernel.
//   The weight's row stride (N bytes) must be a multiple of 16 for TMA:
//   the 16-bit builds take N % 16 == 0.
//
// float32 x (the tiny test model) keeps the CUDA-core kernel below:
// wgmma has no float32 input that keeps float32 numerics.  Each lane owns 4
// adjacent output columns and reads their 4 int8 weights of one k with one
// 32-bit load; the 4 warps of a CTA walk interleaved groups of 4 k values
// and merge through shared memory; a CTA covers 128 columns and up to RT
// rows (8 or 16), more rows take more row tiles; x is staged per 128 k
// values in shared memory as float32.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace ptt;

// ---------------------------------------------------------------------------
// float32 x: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;               // output columns per lane
constexpr int kBN = 32 * kCols;        // columns per CTA
constexpr int kKS = 128;               // k values staged per pass
constexpr int kUnroll = 4;             // 4-k groups a warp keeps in flight

// the 4 signed bytes of a 32-bit word as floats (exact), without the
// quarter-rate integer-to-float conversion: flipping a byte's sign bit
// gives b + 128 in [0, 255]; placed as the low mantissa byte of 2^23
// (0x4B0000xx, one byte permute) that is the float 2^23 + b + 128, and one
// subtraction of 2^23 + 128 leaves b
__device__ __forceinline__ void unpack4(unsigned raw, float (&w)[kCols]) {
  const unsigned u = raw ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    w[c] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + c)) -
           8388736.f;
}

// grid (ceil(N / kBN), ksplit, ceil(rows / RT)), block kThreads.  CTA
// (nt, ks, rt) sums k in [ks * k_chunk, min(K, (ks + 1) * k_chunk)) for
// columns [nt * kBN, nt * kBN + kBN) and rows [rt * RT, rt * RT + RT).
// k_chunk is a multiple of 16 and K, N are multiples of 8, so every pass
// holds a whole number of 4-k groups and a lane's 4 columns are all in or
// all out.  With one split the CTA writes out (scaled, in x's dtype);
// otherwise it writes float32 partials part[ks, row, n].
template <int RT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out,
                   float* __restrict__ part, int rows, int K, int N,
                   int k_chunk) {
  __shared__ __align__(16) float xs[RT][kKS];
  __shared__ float red[kWarps][RT][kBN];
  const int n0 = blockIdx.x * kBN;
  const int ks = blockIdx.y;
  const int r0 = blockIdx.z * RT;
  const int nr = min(RT, rows - r0);
  const int k_begin = ks * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = n0 + lane * kCols;
  const bool col_on = col < N;

  float acc[RT][kCols];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int kb = k_begin; kb < k_end; kb += kKS) {
    const int kn = min(kKS, k_end - kb);
    __syncthreads();   // the previous pass's readers are done
    for (int i = tid; i < RT * kKS; i += kThreads) {
      const int r = i / kKS, kk = i - r * kKS;
      xs[r][kk] = (r < nr && kk < kn)
                      ? x[(size_t)(r0 + r) * K + kb + kk]
                      : 0.f;
    }
    __syncthreads();
    if (!col_on) continue;
    const int8_t* wp = w + (size_t)kb * N + col;
    for (int g0 = warp * 4; g0 < kn; g0 += kWarps * 4 * kUnroll) {
      unsigned raw[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = g0 + u * kWarps * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          raw[u][j] = kk < kn ? __ldg(reinterpret_cast<const unsigned*>(
                                    wp + (size_t)(kk + j) * N))
                              : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = g0 + u * kWarps * 4;
        if (kk >= kn) break;   // uniform across the warp
        float wf[4][kCols];
#pragma unroll
        for (int j = 0; j < 4; ++j) unpack4(raw[u][j], wf[j]);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[r][kk]);
          const float xj[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              acc[r][c] = fmaf(xj[j], wf[j][c], acc[r][c]);
        }
      }
    }
  }

  // merge the warps' sums, then write out or the split's partial
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[warp][r][lane * kCols + c] = acc[r][c];
  __syncthreads();
  const bool single = gridDim.y == 1;
  for (int i = tid; i < nr * kBN; i += kThreads) {
    const int r = i / kBN, cc = i - r * kBN;
    const int n = n0 + cc;
    if (n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][r][cc];
    const size_t o = (size_t)(r0 + r) * N + n;
    if (single)
      out[o] = s * scale[n];
    else
      part[(size_t)ks * rows * N + o] = s;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(e16* p, float v) { *p = to_e16(v); }

// out[r, n] = (sum over splits of part[s, r, n]) * scale[n]
template <typename T>
__global__ void int8_matmul_reduce(const float* __restrict__ part,
                                   const float* __restrict__ scale,
                                   T* __restrict__ out, int rows, int N,
                                   int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)rows * N;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += part[(size_t)k * total + i];
  store(out + i, s * scale[i % N]);
}

template <int RT>
cudaError_t launch_f32(const float* x, const int8_t* w, const float* scale,
                       float* out, float* part, int rows, int K, int N,
                       int ksplit, int k_chunk, cudaStream_t st) {
  dim3 grid((N + kBN - 1) / kBN, ksplit, (rows + RT - 1) / RT);
  int8_matmul_kernel<RT><<<grid, kThreads, 0, st>>>(x, w, scale, out, part,
                                                    rows, K, N, k_chunk);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// 16-bit x: wgmma + TMA (see the top)
// ---------------------------------------------------------------------------
constexpr int kWgCols = 128;            // output columns per CTA
constexpr int kWgK = 64;                // k values per stage
constexpr int kWgThreads = 384;         // consumer warpgroups 0, 1; producer 2
constexpr int kWgConsumers = 256;

// NR: the rows rounded up to wgmma's N
template <int NR>
struct WgCfg {
  static constexpr int kStages = NR <= 64 ? 8 : (NR == 128 ? 6 : 5);
  static constexpr int kWBytes = kWgCols * kWgK;      // int8 tile, 8 KB
  static constexpr int kXBytes = NR * kWgK * 2;       // bf16 tile, NR x 128 B
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * (kWBytes + kXBytes) + 2 * kStages * 8;
};

#ifdef PTT_F16
// two float16 pairs (exact) of the 4 signed bytes of `raw`: {byte 0, byte
// 2} and {byte 1, byte 3}, the low element first.  Flipping a byte's sign
// bit gives b + 128; placed as the low mantissa byte of the float16 1024
// (0x6400) that is 1024 + b + 128, and one pair subtraction of 1152 leaves
// b (integers below 2^11 are exact in float16).
__device__ __forceinline__ void int8x4_to_e16x2x2(uint32_t raw, uint32_t& lo,
                                                  uint32_t& hi) {
  const uint32_t u = raw ^ 0x80808080u;
  lo = f16x2_sub(__byte_perm(u, 0x64u, 0x4240), 0x64806480u);
  hi = f16x2_sub(__byte_perm(u, 0x64u, 0x4341), 0x64806480u);
}
#else
// two bf16 pairs (exact) of the 4 signed bytes of `raw`: {byte 0, byte 2}
// and {byte 1, byte 3}, the low element first.  Flipping a byte's sign bit
// gives b + 128; placed as the low mantissa byte of 2^23 (0x4B0000xx) that
// is the float 2^23 + b + 128, and subtracting 2^23 + 128 leaves b, whose
// float has 16 zero low bits: its high half is its bf16.
__device__ __forceinline__ void int8x4_to_e16x2x2(uint32_t raw, uint32_t& lo,
                                                  uint32_t& hi) {
  const uint32_t u = raw ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u)) -
                   8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651u)) -
                   8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652u)) -
                   8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653u)) -
                   8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632u);
  hi = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632u);
}
#endif

// grid (ceil(N / 128), ksplit), block 384.  CTA (nt, ks) sums k in
// [ks * k_chunk, min(K, (ks + 1) * k_chunk)) (k_chunk a multiple of 64)
// for columns [nt * 128, nt * 128 + 128) and every row.  One split: the
// CTA writes out (scaled, bf16); otherwise float32 partials part[ks, r, n].
template <int NR>
__global__ void __launch_bounds__(kWgThreads, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const float* __restrict__ scale,
                         e16* __restrict__ out,
                         float* __restrict__ part, int rows, int K, int N,
                         int k_chunk) {
  using C = WgCfg<NR>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ws = smem;                              // [stage][64 k][128 B]
  unsigned char* xs = ws + C::kStages * C::kWBytes;      // [stage][NR][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + C::kStages * C::kXBytes);
  uint64_t* empty = full + C::kStages;

  const int n0 = blockIdx.x * kWgCols;
  const int ks = blockIdx.y;
  const int k_begin = ks * k_chunk;
  const int nk = (min(K, k_begin + k_chunk) - k_begin + kWgK - 1) / kWgK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    reg_dealloc<40>();
    if (tid == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % C::kStages;
        mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::kWBytes + C::kXBytes);
        const int k = k_begin + it * kWgK;
        tma_load_2d(ws + s * C::kWBytes, &w_map, &full[s], n0, k);
        tma_load_2d(xs + s * C::kXBytes, &x_map, &full[s], k, 0);
      }
    }
  } else {
    reg_alloc<232>();
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    // the warp's 16 columns: the 16-byte chunk `chunk` of a 128-byte
    // weight row; ldmatrix row address of this lane: k row `lane` (of 32)
    const int chunk = wg * 4 + warp;
    float acc[NR / 2];
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[i] = 0.f;
    uint32_t a0[4][4], a1[4][4];

    // one stage: k rows [0, 64) of the ring slot, 4 k16 steps
    auto step = [&](int it, uint32_t (&a)[4][4]) {
      const int s = it % C::kStages;
      mbar_wait(&full[s], (it / C::kStages) & 1);
      const unsigned char* wt = ws + s * C::kWBytes;
      // raw[h][i]: k rows 32h + 8i + 2c and + 1, each for columns 2g
      // (bytes 0, 2) and 2g + 1 (bytes 1, 3)
      uint32_t raw[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = h * 32 + lane;
        ldmatrix_x4_trans(raw[h], wt + k * 128 + ((chunk ^ (k & 7)) << 4));
      }
      // k16 step t: rows 16t + 2c.. (a[t][0..1]) and 16t + 8 + 2c.. (a[t][2..3])
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        int8x4_to_e16x2x2(raw[t / 2][2 * (t % 2)], a[t][0], a[t][1]);
        int8x4_to_e16x2x2(raw[t / 2][2 * (t % 2) + 1], a[t][2], a[t][3]);
      }
      wgmma_fence();
      const unsigned char* xt = xs + s * C::kXBytes;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        wgmma_rs<0>(acc, a[t], gmma_desc(xt + 32 * t, 16, 1024), 1);
      wgmma_commit();
      // the previous stage's products are done: release its slot (and its
      // A registers, the other set)
      wgmma_wait<1>();
      if (it > 0) mbar_arrive(&empty[(it - 1) % C::kStages]);
    };
    int it = 0;
    for (; it + 1 < nk; it += 2) {
      step(it, a0);
      step(it + 1, a1);
    }
    if (it < nk) step(it, a0);
    wgmma_wait<0>();
    fence_regs(acc);

    // accumulator row g is column n, row g + 8 column n + 1; acc column
    // 8j + 2c (+1) is row r (+1)
    const int n = n0 + wg * 64 + warp * 16 + 2 * g;
    if (n < N) {
      const bool single = gridDim.y == 1;
      const float s0 = single ? scale[n] : 1.f;
      const float s1 = single ? scale[n + 1] : 1.f;
#pragma unroll
      for (int j = 0; j < NR / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * j + 2 * c + e;
          if (r >= rows) continue;
          const size_t o = (size_t)r * N + n;
          if (single)
            *reinterpret_cast<e16x2*>(out + o) =
                to_e16x2(acc[4 * j + e] * s0, acc[4 * j + 2 + e] * s1);
          else
            *reinterpret_cast<float2*>(part + (size_t)ks * rows * N + o) =
                make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
        }
      }
    }
  }
}

// the weight's tensor map: (K, N) int8, 64 x 128 boxes, 128-byte swizzle
cudaError_t weight_map(CUtensorMap* m, const void* w8, int K, int N) {
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {kWgCols, kWgK};
  return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w8, dims, strides,
                    box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NR>
cudaError_t launch_wgmma(const CUtensorMap& w_map, const void* x,
                         const float* scale, void* out, float* part, int rows,
                         int K, int N, int ksplit, int k_chunk,
                         cudaStream_t st) {
  CUtensorMap x_map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {kWgK, NR};
  cudaError_t e = encode_map(&x_map, kTmaE16, 2, x, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  auto kernel = int8_matmul_wgmma_kernel<NR>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)WgCfg<NR>::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kWgCols - 1) / kWgCols, ksplit);
  kernel<<<grid, kWgThreads, WgCfg<NR>::kSmem, st>>>(
      w_map, x_map, scale, static_cast<e16*>(out), part, rows, K, N,
      k_chunk);
  return cudaSuccess;
}

cudaError_t dispatch_wgmma(const CUtensorMap& w_map, const void* x,
                           const float* s, void* out, float* p, int rows,
                           int K, int N, int ksplit, int k_chunk,
                           cudaStream_t st) {
  if (rows <= 8)
    return launch_wgmma<8>(w_map, x, s, out, p, rows, K, N, ksplit, k_chunk, st);
  if (rows <= 16)
    return launch_wgmma<16>(w_map, x, s, out, p, rows, K, N, ksplit, k_chunk, st);
  if (rows <= 32)
    return launch_wgmma<32>(w_map, x, s, out, p, rows, K, N, ksplit, k_chunk, st);
  if (rows <= 64)
    return launch_wgmma<64>(w_map, x, s, out, p, rows, K, N, ksplit, k_chunk, st);
  if (rows <= 128)
    return launch_wgmma<128>(w_map, x, s, out, p, rows, K, N, ksplit, k_chunk, st);
  return launch_wgmma<256>(w_map, x, s, out, p, rows, K, N, ksplit, k_chunk, st);
}

}  // namespace

// The bf16 build's tensor map of an int8 (K, N) weight (N % 16 == 0, w8
// 16-byte aligned), written to map_out (128 bytes): encode it once per
// weight and pass it to every int8_matmul call on that weight.
extern "C" int int8_matmul_weight_map(const void* w8, int K, int N,
                                      void* map_out) {
  if (K < 8 || N < 16 || K % 8 || N % 16 ||
      reinterpret_cast<uintptr_t>(w8) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  const cudaError_t e = weight_map(&m, w8, K, N);
  if (e == cudaSuccess) memcpy(map_out, &m, sizeof(m));
  return static_cast<int>(e);
}

// dtype: 0 = bfloat16, 1 = float32, 2 = float16 (x and out); the default
// library takes 0 and 1, the one compiled with -DPTT_F16 only 2.  rows in
// [1, 256]; K, N multiples of 8; x, w8, out contiguous; ksplit >= 1 splits
// of k_chunk k values each (ksplit = ceil(K / k_chunk)); part is float32
// scratch of (ksplit, rows, N), unused when ksplit == 1.  The 16-bit types
// also need N % 16 == 0, k_chunk % 64 == 0, x 16-byte aligned and w_map,
// the weight's map from int8_matmul_weight_map; float32 needs k_chunk % 16
// == 0 and ignores w_map.  Anything else returns cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launches.
extern "C" int int8_matmul(const void* x, const void* w8, const void* w_map,
                           const void* scale, void* out, void* part, int rows,
                           int K, int N, int ksplit, int k_chunk, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef PTT_F16
  const bool f32 = false;
#else
  const bool f32 = dtype == 1;
#endif
  const bool wg = dtype == kE16Code;
  const int chunk_align = wg ? 64 : 16;
  if (rows < 1 || rows > 256 || K < 8 || N < 8 || K % 8 || N % 8 ||
      k_chunk < chunk_align || k_chunk % chunk_align || ksplit < 1 ||
      (long long)ksplit * k_chunk < K ||
      (long long)(ksplit - 1) * k_chunk >= K ||
      (ksplit > 1 && part == nullptr) || (!wg && !f32) ||
      (wg && (N % 16 || w_map == nullptr ||
              reinterpret_cast<uintptr_t>(x) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* s = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  cudaError_t e;
  if (wg) {
    CUtensorMap m;
    memcpy(&m, w_map, sizeof(m));
    e = dispatch_wgmma(m, x, s, out, p, rows, K, N, ksplit, k_chunk, st);
  } else {
#ifdef PTT_F16
    e = cudaErrorInvalidValue;
#else
    e = rows <= 8 ? launch_f32<8>(static_cast<const float*>(x), w, s,
                                  static_cast<float*>(out), p, rows, K, N,
                                  ksplit, k_chunk, st)
                  : launch_f32<16>(static_cast<const float*>(x), w, s,
                                   static_cast<float*>(out), p, rows, K, N,
                                   ksplit, k_chunk, st);
#endif
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (ksplit > 1) {
    const size_t total = (size_t)rows * N;
    const unsigned blocks = (unsigned)((total + 255) / 256);
    if (wg)
      int8_matmul_reduce<<<blocks, 256, 0, st>>>(
          p, s, static_cast<e16*>(out), rows, N, ksplit);
#ifndef PTT_F16
    else
      int8_matmul_reduce<<<blocks, 256, 0, st>>>(
          p, s, static_cast<float*>(out), rows, N, ksplit);
#endif
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {
// the library's int8 -> 16-bit pair conversion (int8x4_to_e16x2x2) of
// every byte: word i holds bytes 4i..4i+3
__global__ void int8_table_kernel(uint32_t* out) {
  const int i = threadIdx.x;
  const uint32_t w = 0x03020100u + 0x04040404u * i;
  int8x4_to_e16x2x2(w, out[2 * i], out[2 * i + 1]);
}
}  // namespace

// Writes, for each word of bytes 4i..4i+3 (as int8), the converter's two
// 16-bit pairs {4i, 4i + 2}, {4i + 1, 4i + 3} into out (256 x 2 bytes).
extern "C" int int8_matmul_int8_table(void* out, void* stream) {
  int8_table_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
