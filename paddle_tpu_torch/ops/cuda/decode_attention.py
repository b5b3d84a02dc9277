"""Flash-decode over a contiguous KV cache — kernel K1 of the port
(source: ``paddle_tpu_torch/csrc/decode_attention.cu``).

Replaces ``paddle_tpu/ops/pallas/decode_attention.py::decode_attention_pallas``
(body ``_kernel`` :120), contiguous layout.  Computes
``out[b, si, h] = softmax_j(q . k_j * scale) . v_j`` over keys
``j <= pos_b + si`` only, GQA grouped (kv head = h // G, K/V never
broadcast), float32 accumulation with an online softmax; a row whose keys
are all masked returns 0.

Bound on the H100: memory — the live K+V bytes over 3.35 TB/s; at s = 1
each key is used for G query rows, ~1 operation per byte.  What the design
does about it: each (row, kv head) walks only its live prefix
``[0, pos_b + s)`` and never reads the dead cache tail, so a tick costs
what the rows' depths need, not ``max_length`` (the reason the TPU kernel
exists, ``decode_attention.py:13-31``).  The TPU kernel walks a row's
chunks in sequence on one core; on Hopper the walk is split across CTAs
(``FLAGS_decode_attention_block_kv`` keys each) so a batch of 8 rows x 8
kv heads still fills 132 SMs, and a second small kernel merges the splits'
(acc, m, l) partials with the LSE algebra of
``paddle_tpu/ops/ring_attention.py::merge_attention``.  Inside a split,
each warp walks its own 8-key blocks with its own online softmax and no
block barrier, K/V rows going straight from device memory to registers.
It is built for bfloat16 at head_dim 128 (the serving path) and float32
at head_dim 16 (the tiny model), the two builds held against the plain
version on the card (``chip_smoke.py``); any other pair raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ... import flags
from . import _build, dtype_code, require_cuda, stream_ptr

NAME = "decode_attention"
# the head_dim built for each dtype
HEAD_DIM = {torch.bfloat16: 128, torch.float32: 16}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    fn = lib.decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P,      # q k v pos out po pml
                       _I, _I, _I, _I, _I, _I, _I,      # B S Hq Hkv D L lim
                       _I, _I, ctypes.c_float, _I, _P]  # split nsplit scale dt st
        fn.restype = ctypes.c_int
    return lib


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        if pos.dim() == 0:
            pos = pos.reshape(1).expand(b)
        if pos.shape != (b,):
            raise ValueError(f"pos must be a scalar or ({b},), got "
                             f"{tuple(pos.shape)}")
        return pos.to(device=device, dtype=torch.int32).contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos,
                          scale: Optional[float] = None,
                          live_len: Optional[int] = None) -> torch.Tensor:
    """Launch K1.  q: (B, s, Hq, D); k_cache/v_cache: (B, L, Hkv, D), the
    new K/V already written; ``pos``: int or (B,) int tensor.  Returns
    (B, s, Hq, D) in q.dtype.  Each CTA walks at most
    ``FLAGS_decode_attention_block_kv`` keys.  Raises on what the kernel
    does not take."""
    require_cuda(NAME, q, k_cache, v_cache)
    code = dtype_code(q, NAME)
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise NotImplementedError(
            f"{NAME}: q, k_cache and v_cache must share one dtype")
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{NAME}: q (B, s, Hq, D) and caches (B, L, Hkv, "
                         f"D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, s, hq, d = q.shape
    bk, L, hkv, dk = k_cache.shape
    if bk != b or dk != d:
        raise ValueError(f"{NAME}: batch/head_dim mismatch between q "
                         f"{tuple(q.shape)} and cache {tuple(k_cache.shape)}")
    if hkv == 0 or hq % hkv:
        raise NotImplementedError(
            f"{NAME}: q heads ({hq}) must be a multiple of kv heads ({hkv})")
    if HEAD_DIM[q.dtype] != d:
        raise NotImplementedError(
            f"{NAME}: {q.dtype} is built for head_dim {HEAD_DIM[q.dtype]}, "
            f"got {d}")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise NotImplementedError(f"{NAME}: tensors must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    limit = L if live_len is None else max(1, min(L, int(live_len)))
    split_len = max(1, int(flags.flag("decode_attention_block_kv")))
    nsplit = max(1, math.ceil(limit / split_len))
    pos_t = _pos_vector(pos, b, q.device)
    if scale is None:
        scale = d ** -0.5
    rows = s * (hq // hkv)
    if nsplit > 1:
        # one float32 scratch: (B*Hkv, nsplit, rows, D) partial sums, then
        # (B*Hkv, nsplit, rows, 2) running max / normaliser
        n_o = b * hkv * nsplit * rows * d
        part = torch.empty(n_o + b * hkv * nsplit * rows * 2,
                           dtype=torch.float32, device=q.device)
        po = part.data_ptr()
        pml = po + 4 * n_o
    else:
        po = pml = None
    lib = _lib()
    err = lib.decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos_t.data_ptr(), out.data_ptr(), po, pml,
        b, s, hq, hkv, d, L, limit, split_len, nsplit, float(scale), code,
        stream_ptr(q.device))
    _build.check(lib, NAME, err)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
