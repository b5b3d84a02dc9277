"""Flash-attention backward — kernels K5 (dq) and K6 (dk, dv) of the port
(source: ``paddle_tpu_torch/csrc/flash_attention_bwd.cu``).

Replace ``paddle_tpu/ops/pallas/flash_attention.py`` ``_bwd_dq_kernel``
(:252, its ``pallas_call`` :377) and ``_bwd_dkv_kernel`` (:299, :407): the
Flash-2 backward from (q, k, v, dO, lse, delta), scores recomputed
blockwise, ``delta = rowsum(dO * O) - dlse``.  The same contract as K2:
bottom-right causal offset ``Skv - Sq``, GQA (kv head = h // G), optional
packed-document segment ids, ragged Sq / Skv masked in the kernel, tiles
above the diagonal skipped, and zero gradient for a row with every key
masked.

Bound on the H100: operations (14 * D FLOPs a visible query-key pair on
the bf16 tensor cores).  What the design does about it: K5 keeps a warp's
Q and dO fragments in registers and streams 64-key K / V tiles through
shared memory, dq in float32 registers; K6 gives one CTA a 64-key tile of
one KV head and walks every q head of its GQA group over the query tiles
at or below the diagonal, so dk and dv are summed over the group in
float32 registers and rounded once — the (B, Hq, Skv, D) per-q-head
partials the reference writes and sums (:428-440) never exist.  Both
build for bfloat16 at head_dim 128 (``mma.sync``) and float32 at head_dim
16 (CUDA cores); any other pair raises.  Each wrapper counts its launches
in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, check_attention_args, require_cuda, stream_ptr
from .flash_attention import HEAD_DIM, _ptr, segment_args

NAME = "flash_attention_bwd"

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    fq = lib.flash_attention_bwd_dq
    if fq.argtypes is None:
        # q k v dout lse delta seg_q seg_kv dq; B Sq Skv Hq Hkv D; scale;
        # causal dtype; stream
        fq.argtypes = [_P] * 9 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
        fq.restype = ctypes.c_int
        fk = lib.flash_attention_bwd_dkv
        # q k v dout lse delta seg_q seg_kv dk dv; B Sq Skv Hq Hkv D; ...
        fk.argtypes = [_P] * 10 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
        fk.restype = ctypes.c_int
    return lib


def _check(q, k, v, do, lse, delta):
    code = check_attention_args(NAME, q, k, v, HEAD_DIM)
    require_cuda(NAME, do, lse, delta)
    b, sq, hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{NAME}: dO must be {tuple(q.shape)} {q.dtype}, "
                         f"got {tuple(do.shape)} {do.dtype}")
    if k.shape[0] != b:
        raise ValueError(f"{NAME}: batch mismatch between "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, hq, sq):
            raise ValueError(f"{NAME}: {name} must be float32 "
                             f"{(b, hq, sq)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if do.data_ptr() % 16:
        raise NotImplementedError(f"{NAME}: tensors must be 16-byte aligned")
    return code


def flash_attention_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor,
                                lse: torch.Tensor, delta: torch.Tensor,
                                causal: bool = False,
                                scale: Optional[float] = None,
                                segment_ids=None,
                                kv_segment_ids=None) -> torch.Tensor:
    """Launch K5.  q, dO: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); lse,
    delta: float32 (B, Hq, Sq).  Returns dq (B, Sq, Hq, D) in q.dtype."""
    code = _check(q, k, v, do, lse, delta)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    seg_q, seg_kv = segment_args(NAME, segment_ids, kv_segment_ids, b, sq,
                                 skv, q.device)
    if b == 0 or sq == 0 or skv == 0:
        return torch.zeros_like(q)
    dq = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        _ptr(seg_q), _ptr(seg_kv), dq.data_ptr(),
        b, sq, skv, hq, hkv, d,
        float(d ** -0.5 if scale is None else scale), int(causal), code,
        stream_ptr(q.device))
    _build.check(lib, NAME, err)
    flash_attention_bwd_dq_cuda.launches += 1
    return dq


flash_attention_bwd_dq_cuda.launches = 0


def flash_attention_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 lse: torch.Tensor, delta: torch.Tensor,
                                 causal: bool = False,
                                 scale: Optional[float] = None,
                                 segment_ids=None, kv_segment_ids=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6.  Arguments as :func:`flash_attention_bwd_dq_cuda`.
    Returns (dk, dv), each (B, Skv, Hkv, D) in k.dtype and summed over the
    GQA group of its KV head."""
    code = _check(q, k, v, do, lse, delta)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    seg_q, seg_kv = segment_args(NAME, segment_ids, kv_segment_ids, b, sq,
                                 skv, q.device)
    if b == 0 or sq == 0 or skv == 0:
        return torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    err = lib.flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        _ptr(seg_q), _ptr(seg_kv), dk.data_ptr(),
        dv.data_ptr(), b, sq, skv, hq, hkv, d,
        float(d ** -0.5 if scale is None else scale), int(causal), code,
        stream_ptr(q.device))
    _build.check(lib, NAME, err)
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_bwd_dkv_cuda.launches = 0
