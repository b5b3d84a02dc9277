"""Weight-only int8 GEMM — kernel K4 of the port
(source: ``paddle_tpu_torch/csrc/int8_matmul.cu``).

Replaces ``paddle_tpu/ops/pallas/int8_matmul.py::int8_matmul_pallas``
(body ``_kernel`` :38-54): ``out = (x @ w8) * scale`` for x (..., K)
bfloat16, float16 or float32, w8 (K, N) int8 and a float32 (N,) per-column scale;
out (..., N) in x's dtype.  The int8 weights are converted in registers,
sums are float32 and the scale is applied once in the epilogue.

Bound on the H100: memory at decode's row counts — the K * N int8 weight
bytes over 3.35 TB/s, half a bfloat16 GEMV's — and the tensor cores from
about 150 rows up.  What the design does about it (bfloat16 x): the
product runs on ``wgmma`` with the operands swapped (the output columns
are M, the rows N), so a CTA of 128 columns reads each weight byte from
device memory once a launch at every row count up to 256; a producer warp
streams weight and x tiles by TMA into an mbarrier ring; consumers convert
the int8 tile to x's 16-bit type in registers (``ldmatrix.trans`` of byte
pairs, a byte permute and one exact subtraction) as wgmma's register A
operand; K is split across CTAs
where N alone gives too few of them (N = 1024 and 4096: k_proj, v_proj,
q_proj, o_proj, down_proj), up to one wave on the 132 SMs.  The weight's
tensor map is encoded once per weight and cached here by (data_ptr, K,
N).  float16 x runs the same kernel compiled over float16 (a library of
its own, ``_build.VARIANTS``).  The 16-bit builds need N % 16 == 0 (TMA's
16-byte row stride); float32 x (the tiny model) keeps the CUDA-core
kernel.  A prefill wave's row counts above 256 go to the
dequantize-then-matmul composition by the shape rule of
``nn/quant.py::int8_matmul_path``.

Under CUDA-graph capture (the serving engine's decode step) a launch
replays as captured: the K split is fixed by shape (:func:`split_k`), the
weight's map by its address, and x's map, encoded at each launch and
passed by value as a ``__grid_constant__`` parameter, holds the address
of x in the graph's memory pool, where every replay writes x again.  The
kernel's shared-memory attribute (``cudaFuncSetAttribute``, set at every
launch) is no stream operation and is allowed while capturing.

:func:`int8_matmul_reference` is the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import (HALF_DTYPES, _build, dtype_code, library, require_cuda,
               stream_ptr)

NAME = "int8_matmul"
MAX_ROWS = 256          # the kernel's row limit (the reference's too)
# the builds' N multiple
N_ALIGN = {torch.bfloat16: 16, torch.float16: 16, torch.float32: 8}
_SM_COUNT = 132         # H100 SXM
_BN = 128               # output columns per CTA, both builds (csrc: kBN,
                        # kWgCols)
_MAP_BYTES = 128        # sizeof(CUtensorMap)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(dtype: torch.dtype = torch.bfloat16) -> ctypes.CDLL:
    """The library of ``dtype``'s build (float16: its own)."""
    lib = _build.load(library(NAME, dtype))
    fn = lib.int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P,         # x w8 map scale out part
                       _I, _I, _I, _I, _I, _I, _P]     # rows K N split kc dt st
        fn.restype = ctypes.c_int
        wm = lib.int8_matmul_weight_map
        wm.argtypes = [_P, _I, _I, _P]                 # w8 K N map_out
        wm.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=4096)
def _weight_map(ptr: int, k: int, n: int) -> ctypes.Array:
    """The 16-bit builds' TMA tensor map of the int8 (K, N) weight at
    ``ptr``, encoded once: a map holds only the address, shape and
    strides, so a key of (address, K, N) is never stale."""
    lib = _lib()
    buf = ctypes.create_string_buffer(_MAP_BYTES)
    _build.check(lib, NAME, lib.int8_matmul_weight_map(ptr, k, n, buf))
    return buf


def int8_matmul_reference(x: torch.Tensor, w8: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The plain version of K4: ``((x @ w8) * scale)`` in float32, cast to
    x's dtype."""
    return ((x.float() @ w8.float()) * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=1024)
def split_k(rows: int, k: int, n: int, bf16: bool = True):
    """(ksplit, k_chunk): the K split of one launch.  As many splits as
    keep the grid within one wave of CTAs (a few CTAs past a full wave
    would double the time) with chunks no shorter than 256 k values
    (128 for float32).  16-bit x (``bf16``): one 384-thread CTA an SM covers 128
    columns and every row, chunks a multiple of 64 (the TMA k slice);
    float32: 4 CTAs an SM, each 128 columns x 8 or 16 rows, chunks a
    multiple of 16.  Split partials are summed by a second kernel."""
    if bf16:
        tiles, slots, align, least = math.ceil(n / _BN), _SM_COUNT, 64, 256
    else:
        tiles = math.ceil(n / _BN) * math.ceil(rows / (8 if rows <= 8 else 16))
        slots, align, least = 4 * _SM_COUNT, 16, 128
    want = max(1, min(slots // tiles, k // least))
    chunk = max(align, math.ceil(k / want / align) * align)
    return math.ceil(k / chunk), chunk


def int8_matmul_cuda(x: torch.Tensor, w8: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Launch K4.  x: (..., K) bfloat16/float16/float32, contiguous; w8: (K, N)
    int8; scale: (N,) float32.  Returns (..., N) in x.dtype.  Raises on what
    the kernel does not take (a CPU tensor, a row count outside [1, 256], K
    not a multiple of 8, N not a multiple of ``N_ALIGN[x.dtype]``, a
    16-bit x or w8 not 16-byte aligned)."""
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
    if k % 8 or n % N_ALIGN[x.dtype]:
        raise NotImplementedError(
            f"{NAME}: K must be a multiple of 8 and N of "
            f"{N_ALIGN[x.dtype]} ({x.dtype}), got {k}, {n}")
    rows = x.numel() // k
    if not 0 < rows <= MAX_ROWS:
        raise NotImplementedError(
            f"{NAME}: the kernel takes 1..{MAX_ROWS} rows, got {rows}")
    half = x.dtype in HALF_DTYPES
    if half and (x.data_ptr() % 16 or w8.data_ptr() % 16):
        raise NotImplementedError(f"{NAME}: x and w8 must be 16-byte aligned")
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    ksplit, chunk = split_k(rows, k, n, half)
    part = (torch.empty((ksplit, rows, n), dtype=torch.float32,
                        device=x.device) if ksplit > 1 else None)
    lib = _lib(x.dtype)
    err = lib.int8_matmul(
        x.data_ptr(), w8.data_ptr(),
        _weight_map(w8.data_ptr(), k, n) if half else None,
        scale.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, rows, k, n, ksplit,
        chunk, code, stream_ptr(x.device))
    _build.check(lib, NAME, err)
    int8_matmul_cuda.launches += 1
    return out


int8_matmul_cuda.launches = 0
