#!/usr/bin/env python3
"""The rate of the warp-level tensor-core product ``mma.sync`` on one NVIDIA
GPU: m16n8k8 TF32 (the float32 K5 / K6's three passes,
``paddle_tpu_torch/csrc/mma_tf32.cuh``) beside m16n8k16 bf16 (the K1
family's), with operands in registers and no memory traffic.

Run from the repository root::

    python3 chip_mma_rate.py

Each case launches 132 x 2 CTAs of ``warps`` warps; every warp runs
``chains`` independent accumulators through 4096 products each.  It prints
one JSON line a case with the TFLOP/s reached (2 m n k a product), the
card's name and power limit first.  The kernel is built with nvcc into
``paddle_tpu_torch/_build/`` (git-ignored).  Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ITERS = 4096

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int CHAINS, bool TF32>
__global__ void rate_kernel(float* out, uint32_t seed) {
  float acc[CHAINS][4];
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  const uint32_t x = seed ^ threadIdx.x;
  uint32_t a0 = x, a1 = x * 3u, a2 = x * 5u, a3 = x * 7u, b0 = x * 11u,
           b1 = x * 13u;
  for (int i = 0; i < %(iters)d; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%%0,%%1,%%2,%%3}, {%%4,%%5,%%6,%%7}, {%%8,%%9}, "
            "{%%0,%%1,%%2,%%3};\n"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
              "+f"(acc[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%%0,%%1,%%2,%%3}, {%%4,%%5,%%6,%%7}, {%%8,%%9}, "
            "{%%0,%%1,%%2,%%3};\n"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
              "+f"(acc[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  if (s == 1234.5f) out[0] = s;   // keeps the products
}

template <int CHAINS, bool TF32>
int launch(int blocks, int threads, float* out, void* stream) {
  rate_kernel<CHAINS, TF32><<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(out, 7u);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mma_rate(int tf32, int chains, int blocks, int threads,
                        float* out, void* stream) {
  if (tf32) {
    if (chains == 1) return launch<1, true>(blocks, threads, out, stream);
    if (chains == 2) return launch<2, true>(blocks, threads, out, stream);
    if (chains == 4) return launch<4, true>(blocks, threads, out, stream);
    return launch<8, true>(blocks, threads, out, stream);
  }
  if (chains == 1) return launch<1, false>(blocks, threads, out, stream);
  if (chains == 2) return launch<2, false>(blocks, threads, out, stream);
  if (chains == 4) return launch<4, false>(blocks, threads, out, stream);
  return launch<8, false>(blocks, threads, out, stream);
}
""" % {"iters": ITERS}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_mma_rate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.ops.cuda import _build
    build = ROOT / "paddle_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    src, lib_path = build / "mma_rate.cu", build / "mma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": limit.strip()}), flush=True)
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    for tf32 in (1, 0):
        for warps in (4, 8, 16):
            for chains in (1, 2, 4, 8):
                def run():
                    err = lib.mma_rate(tf32, chains, blocks, 32 * warps,
                                       out.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"launch error {err}")
                run()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    run()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 5
                flops = (2 * 16 * 8 * (8 if tf32 else 16) * ITERS * chains
                         * warps * blocks)
                print(json.dumps({
                    "mma": "m16n8k8 tf32" if tf32 else "m16n8k16 bf16",
                    "warps_a_cta": warps, "ctas": blocks, "chains": chains,
                    "ms": ms, "tflops": flops / ms / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
