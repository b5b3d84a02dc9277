"""Kernels written in CUDA C++ for Hopper (``sm_90a``).

Sources live in ``paddle_tpu_torch/csrc/``; ``_build.py`` compiles them with
``nvcc`` at first use and loads them with ``ctypes``.  Each wrapper checks
device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch failed, and counts its launches in ``.launches``."""

import ctypes

import torch

# element type codes of the C entries
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
# the head dims every bf16 attention build takes -- the K1 family, K2 in
# every layout, the backward K5 / K6: any D <= 256 (the reference's
# MAX_HEAD_DIM) with D % 8 == 0 (tiles or ring rows 128 wide up to D 128
# and 256 wide above, whose columns past D hold zeros).  The float16
# builds, forward and backward, take the same set (the same bodies over
# float16), and so do the float32 builds (the K1 family's CUDA-core body,
# whose lanes past D hold zeros; K2 and K5 / K6 the 3xTF32 bodies, whose
# column tiles past D are never stored)
BF16_HEAD_DIMS = frozenset(range(8, 257, 8))
# the 16-bit types, whose kernels share one body (bfloat16 and float16)
HALF_DTYPES = (torch.bfloat16, torch.float16)


def dtype_code(t: torch.Tensor, what: str) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise NotImplementedError(
            f"{what}: dtype {t.dtype} (the kernel takes bfloat16, float16 "
            f"or float32)") from None


def library(name: str, dtype: torch.dtype) -> str:
    """The library of source ``name`` that holds ``dtype``'s build: the
    float16 kernels are the 16-bit bodies compiled on their own
    (``_build.VARIANTS``)."""
    return name + "_f16" if dtype == torch.float16 else name


def stream_ptr(device: torch.device) -> int:
    """The current stream's raw handle (the call Triton's launcher makes;
    ``torch.cuda.current_stream`` builds a Stream object, ~15 us a call)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: every tensor must be on one CUDA "
                             f"device (got {t.device})")
        if not t.is_contiguous():
            raise NotImplementedError(f"{what}: tensors must be contiguous")


def pos_vector(pos, b: int, device) -> torch.Tensor:
    """Per-row positions as a contiguous int32 (B,) tensor on ``device``
    (a scalar ``pos`` is broadcast)."""
    if isinstance(pos, torch.Tensor):
        if pos.dim() == 0:
            pos = pos.reshape(1).expand(b)
        if pos.shape != (b,):
            raise ValueError(f"pos must be a scalar or ({b},), got "
                             f"{tuple(pos.shape)}")
        return pos.to(device=device, dtype=torch.int32).contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def block_table(block_tables: torch.Tensor, b: int, device,
                what: str) -> torch.Tensor:
    """A (B, max_blocks) block table as a contiguous int32 tensor on
    ``device``."""
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"{what}: block_tables must be ({b}, max_blocks), "
                         f"got {tuple(block_tables.shape)}")
    if block_tables.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: block_tables must be an integer tensor")
    return block_tables.to(device=device, dtype=torch.int32).contiguous()


def check_attention_args(what: str, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, head_dim: dict,
                         int8: bool = False) -> int:
    """The checks every attention wrapper makes: one CUDA device,
    contiguous, 16-byte aligned 4-d tensors, ``v`` shaped like ``k``, q
    heads a multiple of k's (dim 2), head_dim (dim 3) equal and one built
    for q's dtype (``head_dim[dtype]``: the one head_dim, or a frozenset
    of them).  k and v share q's dtype, or with ``int8`` are both int8
    (the quantized cache).  Returns q's dtype code."""
    require_cuda(what, q, k, v)
    code = dtype_code(q, what)
    kv_dtype = torch.int8 if int8 else q.dtype
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise NotImplementedError(
            f"{what}: k and v must be {kv_dtype} (q is {q.dtype}), got "
            f"{k.dtype} / {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: 4-d q, k, v expected (k, v of one "
                         f"shape), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    hq, d = q.shape[2], q.shape[3]
    hkv = k.shape[2]
    if k.shape[3] != d:
        raise ValueError(f"{what}: head_dim mismatch between "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if hkv == 0 or hq % hkv:
        raise NotImplementedError(
            f"{what}: q heads ({hq}) must be a multiple of kv heads ({hkv})")
    built = head_dim.get(q.dtype)
    if built is None:
        raise NotImplementedError(
            f"{what}: no {q.dtype} build (ROADMAP B2)")
    if d not in (built if isinstance(built, frozenset) else (built,)):
        dims = (", ".join(map(str, sorted(built)))
                if isinstance(built, frozenset) else built)
        raise NotImplementedError(
            f"{what}: {q.dtype} is built for head_dim {dims}, got {d} "
            f"(other head dims: ROADMAP B2)")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise NotImplementedError(f"{what}: tensors must be 16-byte aligned")
    return code


def check_scales(what: str, cache: torch.Tensor, k_scale: torch.Tensor,
                 v_scale: torch.Tensor, shape: tuple) -> None:
    """The int8 cache's scales: float32, contiguous, on the device of
    ``cache``, both of ``shape``."""
    require_cuda(what, cache, k_scale, v_scale)
    for t in (k_scale, v_scale):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: scales must be float32 {tuple(shape)}"
                             f", got {t.dtype} {tuple(t.shape)}")
