"""Flash-attention forward — kernel K2 of the port
(source: ``paddle_tpu_torch/csrc/flash_attention_fwd.cu``).

Replaces ``paddle_tpu/ops/pallas/flash_attention.py`` ``_fwd`` (:192) /
``_fwd_kernel`` (:128): blocked online-softmax attention over
(B, S, H, D) inputs, causal or not, with bottom-right causal alignment
(``offset = Skv - Sq``) and GQA as an index map (kv head = h // G).
Returns ``out`` and the float32 log-sum-exp ``lse`` (B, Hq, Sq); a row with
every key masked gives out = 0 and lse = -1e30.  Any Sq / Skv works: the
ragged edge is masked in the kernel (the wave-prefill bucket is 8, 16, ...,
not 128-aligned, which the Pallas kernel refuses at :73-88).

Bound on the H100: max(causal FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s); at
the prefill shapes the operations bound it.  What the design does about
it: one CTA per (64-query tile, head, batch) streams 64-key K/V tiles
through shared memory, so the (Sq, Skv) score matrix never reaches device
memory, and skips the tiles above the causal diagonal.  bfloat16 at
head_dim 128 — the serving path — runs Q.K^T and P.V on the tensor cores
(``mma.sync.m16n8k16``, float32 accumulation, P re-packed in registers, V
through ``ldmatrix.trans``); float32 at head_dim 16 — the tiny model —
runs a CUDA-core kernel.  Those two builds are the ones held against the
plain version on the card (``chip_smoke.py``); any other dtype or head_dim
raises.  ``wgmma``/TMA are the next step; the gap to the bound is
recorded in PERF.md.

Segment ids and the backward (``_bwd`` dq/dkv) belong to the training
slice and are not taken here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, dtype_code, require_cuda, stream_ptr

NAME = "flash_attention_fwd"
# the head_dim built for each dtype
HEAD_DIM = {torch.bfloat16: 128, torch.float32: 16}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P,                 # q k v out lse
                       _I, _I, _I, _I, _I, _I,             # B Sq Skv Hq Hkv D
                       ctypes.c_float, _I, _I, _P]         # scale causal dt st
        fn.restype = ctypes.c_int
    return lib


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2.  q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D).  Returns
    (out (B, Sq, Hq, D) in q.dtype, lse (B, Hq, Sq) float32).  Raises on
    what the kernel does not take."""
    require_cuda(NAME, q, k, v)
    code = dtype_code(q, NAME)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(f"{NAME}: q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{NAME}: q (B, Sq, Hq, D) and k/v (B, Skv, Hkv, "
                         f"D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    bk, skv, hkv, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"{NAME}: batch/head_dim mismatch between "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if hkv == 0 or hq % hkv:
        raise NotImplementedError(
            f"{NAME}: q heads ({hq}) must be a multiple of kv heads ({hkv})")
    if HEAD_DIM[q.dtype] != d:
        raise NotImplementedError(
            f"{NAME}: {q.dtype} is built for head_dim {HEAD_DIM[q.dtype]}, "
            f"got {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise NotImplementedError(f"{NAME}: tensors must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0:
        return out, lse
    if scale is None:
        scale = d ** -0.5
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, skv, hq, hkv, d, float(scale), int(causal),
        code, stream_ptr(q.device))
    _build.check(lib, NAME, err)
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0
