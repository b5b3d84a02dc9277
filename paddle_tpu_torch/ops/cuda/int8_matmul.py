"""Weight-only int8 GEMM — kernel K4 of the port
(source: ``paddle_tpu_torch/csrc/int8_matmul.cu``).

Replaces ``paddle_tpu/ops/pallas/int8_matmul.py::int8_matmul_pallas``
(body ``_kernel`` :38-54): ``out = (x @ w8) * scale`` for x (..., K)
bfloat16 or float32, w8 (K, N) int8 and a float32 (N,) per-column scale;
out (..., N) in x's dtype.  The int8 weights are converted in registers,
sums are float32 and the scale is applied once in the epilogue.

Bound on the H100: memory at decode's row counts — the K * N int8 weight
bytes over 3.35 TB/s, half a bfloat16 GEMV's.  What the design does about
it: every weight byte is read once per launch for up to 16 rows (a warp
reads 128 contiguous bytes of a weight row, 16 loads in flight a lane),
and K is split across CTAs where N alone gives too few of them (k_proj and
v_proj at N = 1024), so all 132 SMs stream.  Up to 256 rows are taken
(more rows re-read the weights per 16-row tile); a prefill wave's larger
row counts go to the dequantize-then-matmul composition by the shape rule
of ``nn/quant.py::int8_matmul_path``.

:func:`int8_matmul_reference` is the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, dtype_code, require_cuda, stream_ptr

NAME = "int8_matmul"
MAX_ROWS = 256          # the kernel's row limit (the reference's too)
_SM_COUNT = 132         # H100 SXM
_CTAS_PER_SM = 4        # the kernel's occupancy (<= 128 registers a thread)
_BN = 128               # output columns per CTA (csrc: kBN)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    fn = lib.int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P,             # x w8 scale out part
                       _I, _I, _I, _I, _I, _I, _P]     # rows K N split kc dt st
        fn.restype = ctypes.c_int
    return lib


def int8_matmul_reference(x: torch.Tensor, w8: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The plain version of K4: ``((x @ w8) * scale)`` in float32, cast to
    x's dtype."""
    return ((x.float() @ w8.float()) * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=1024)
def split_k(rows: int, k: int, n: int):
    """(ksplit, k_chunk): the K split of one launch.  As many splits as
    keep the grid within one wave of 4 CTAs on each of the 132 SMs (the
    kernel's occupancy; a few CTAs past a full wave would double the
    time), chunks a multiple of 16 k values and no shorter than 128."""
    tiles = math.ceil(n / _BN) * math.ceil(rows / (8 if rows <= 8 else 16))
    want = max(1, min(_CTAS_PER_SM * _SM_COUNT // tiles, k // 128))
    chunk = max(16, math.ceil(k / want / 16) * 16)
    return math.ceil(k / chunk), chunk


def int8_matmul_cuda(x: torch.Tensor, w8: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Launch K4.  x: (..., K) bfloat16/float32, contiguous; w8: (K, N)
    int8; scale: (N,) float32.  Returns (..., N) in x.dtype.  Raises on what
    the kernel does not take (a CPU tensor, a row count outside [1, 256], K
    or N not a multiple of 8)."""
    require_cuda(NAME, x, w8, scale)
    code = dtype_code(x, NAME)
    if w8.dtype != torch.int8 or w8.dim() != 2:
        raise NotImplementedError(f"{NAME}: w8 must be a 2-d int8 tensor")
    k, n = w8.shape
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"{NAME}: scale must be float32 ({n},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.shape[-1] != k:
        raise ValueError(f"{NAME}: x {tuple(x.shape)} does not match w8 "
                         f"{tuple(w8.shape)}")
    if k % 8 or n % 8:
        raise NotImplementedError(
            f"{NAME}: K and N must be multiples of 8, got {k}, {n}")
    rows = x.numel() // k
    if not 0 < rows <= MAX_ROWS:
        raise NotImplementedError(
            f"{NAME}: the kernel takes 1..{MAX_ROWS} rows, got {rows}")
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    ksplit, chunk = split_k(rows, k, n)
    part = (torch.empty((ksplit, rows, n), dtype=torch.float32,
                        device=x.device) if ksplit > 1 else None)
    lib = _lib()
    err = lib.int8_matmul(
        x.data_ptr(), w8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, rows, k, n, ksplit,
        chunk, code, stream_ptr(x.device))
    _build.check(lib, NAME, err)
    int8_matmul_cuda.launches += 1
    return out


int8_matmul_cuda.launches = 0
