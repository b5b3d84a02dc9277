// Weight-only int8 GEMM: kernel K4 of paddle_tpu_torch.
//
// Replaces paddle_tpu/ops/pallas/int8_matmul.py::int8_matmul_pallas (body
// _kernel :38-54): out[r, n] = (sum_k x[r, k] * w8[k, n]) * scale[n], x
// (rows, K) bfloat16 or float32, w8 (K, N) int8 row-major, scale (N,)
// float32 per output column, out (rows, N) in x's dtype.  The int8 -> float
// conversion happens in registers, the sums are float32, and the scale is
// applied once in the epilogue (it commutes with the sum over k), as the
// Pallas kernel does at its last K step.
//
// Bound on the H100: memory at decode's row counts.  At 8 rows the kernel
// does 16 operations per weight byte, far below the ~295 a byte where the
// tensor cores would bound it, so the time is the int8 weight stream
// (K * N bytes) over 3.35 TB/s -- half a bf16 GEMV's bytes.  The design:
//   * each lane owns 4 adjacent output columns and reads their 4 int8
//     weights of one k with one 32-bit load, so a warp reads 128
//     contiguous bytes of a weight row; the 4 warps of a CTA walk
//     interleaved groups of 4 k values of the CTA's k range, 16 weight
//     loads in flight per lane, and merge through shared memory at the end;
//   * a CTA covers 128 columns and up to RT rows (8 or 16): for rows <= 16
//     every weight byte is read from device memory once per launch; more
//     rows (up to 256) take row tiles that read the weights again;
//   * where N alone gives too few CTAs (k_proj/v_proj at N = 1024: 8
//     column tiles), K is split across CTAs, up to one full wave of 4 CTAs
//     an SM (the wrapper's split rule); split partials (float32) are
//     summed and scaled by a second small kernel;
//   * x is staged per 128 k values in shared memory as float32 and read
//     as broadcast 16-byte loads.
// The products run on the CUDA cores (f32 FMA): at 8 rows they are close
// to the FMA rate's limit; tensor cores (mma/wgmma) and TMA are the next
// step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;               // output columns per lane
constexpr int kBN = 32 * kCols;        // columns per CTA
constexpr int kKS = 128;               // k values staged per pass
constexpr int kUnroll = 4;             // 4-k groups a warp keeps in flight

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
template <typename T, int RT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out,
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
                      ? to_float(x[(size_t)(r0 + r) * K + kb + kk])
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
      out[o] = from_float<T>(s * scale[n]);
    else
      part[(size_t)ks * rows * N + o] = s;
  }
}

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
  out[i] = from_float<T>(s * scale[i % N]);
}

template <typename T, int RT>
cudaError_t launch(const void* x, const int8_t* w, const float* scale,
                   void* out, float* part, int rows, int K, int N,
                   int ksplit, int k_chunk, cudaStream_t st) {
  dim3 grid((N + kBN - 1) / kBN, ksplit, (rows + RT - 1) / RT);
  int8_matmul_kernel<T, RT><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), w, scale, static_cast<T*>(out), part, rows,
      K, N, k_chunk);
  if (ksplit > 1) {
    const size_t total = (size_t)rows * N;
    int8_matmul_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        part, scale, static_cast<T*>(out), rows, N, ksplit);
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_rows(const void* x, const int8_t* w, const float* s,
                          void* out, float* part, int rows, int K, int N,
                          int ksplit, int k_chunk, cudaStream_t st) {
  if (rows <= 8)
    return launch<T, 8>(x, w, s, out, part, rows, K, N, ksplit, k_chunk, st);
  return launch<T, 16>(x, w, s, out, part, rows, K, N, ksplit, k_chunk, st);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (x and out).  rows in [1, 256]; K, N
// multiples of 8; x, w8, out contiguous; ksplit >= 1 splits of k_chunk k
// values each (k_chunk a multiple of 16, ksplit = ceil(K / k_chunk)); part
// is float32 scratch of (ksplit, rows, N), unused when ksplit == 1.
// Anything else returns cudaErrorInvalidValue.  Returns cudaGetLastError()
// after the launches.
extern "C" int int8_matmul(const void* x, const void* w8, const void* scale,
                           void* out, void* part, int rows, int K, int N,
                           int ksplit, int k_chunk, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 256 || K < 8 || N < 8 || K % 8 || N % 8 ||
      k_chunk < 16 || k_chunk % 16 || ksplit < 1 ||
      (long long)ksplit * k_chunk < K ||
      (long long)(ksplit - 1) * k_chunk >= K ||
      (ksplit > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* s = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_rows<__nv_bfloat16>(x, w, s, out, p, rows, K, N, ksplit,
                                     k_chunk, st);
  else if (dtype == 1)
    e = dispatch_rows<float>(x, w, s, out, p, rows, K, N, ksplit, k_chunk,
                             st);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
