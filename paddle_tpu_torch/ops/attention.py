"""Attention: plain PyTorch versions + dispatch to the CUDA kernels
(mirrors ``paddle_tpu/ops/attention.py``).

Layout as in the reference: ``(batch, seq, heads, head_dim)``; GQA passes
fewer KV heads than query heads.  Two entries:

  * :func:`flash_attention` — blocked attention over fresh Q/K/V (the
    wave-prefill path at ``pos == 0``); kernel K2
    (``ops/cuda/flash_attention.py``);
  * :func:`cached_decode_attention` — attention of new tokens over a
    pre-allocated contiguous cache (every decode tick); kernel K1
    (``ops/cuda/decode_attention.py``).

Routing follows ``ops/_dispatch.py``: a CUDA tensor goes to the kernel,
which launches or raises; a CPU tensor goes to the plain version.  Features
outside this slice raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _dispatch
from .cuda.decode_attention import decode_attention_cuda
from .cuda.flash_attention import flash_attention_fwd_cuda

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def flash_attention_reference(q, k, v, attn_mask=None, causal: bool = False,
                              scale: Optional[float] = None,
                              return_lse: bool = True):
    """Stable attention in float32 — the plain version of kernel K2.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    ``attn_mask``: bool (True = keep) or additive float mask broadcastable
    to (B, Hq, Sq, Skv).  Causal masking is bottom-right aligned
    (query i sees keys j <= i + Skv - Sq).  Fully-masked rows give out = 0
    and lse = -1e30.  Returns (out, lse) with lse (B, Hq, Sq) float32."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    qt = q.transpose(1, 2).float() * scale
    kt = k.transpose(1, 2).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", qt, kt)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, NEG_INF)
        else:
            scores = scores + attn_mask.float()
    m = scores.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(scores - m)
    dead = m <= NEG_INF / 2
    p = p.masked_fill(dead, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(dead, torch.full_like(m, NEG_INF),
                      m + torch.log(l.clamp_min(1e-37))).squeeze(-1)
    p = p / l.clamp_min(1e-37)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.transpose(1, 2).float())
    out = out.transpose(1, 2).to(q.dtype)
    return (out, lse) if return_lse else out


class _ForwardOnly(torch.autograd.Function):
    """Runs a kernel under autograd and refuses the backward: the
    attention kernels' backward (flash ``_bwd``) is the training slice,
    ROADMAP B3, and a silently detached gradient would be wrong."""

    @staticmethod
    def forward(ctx, fn, kwargs, *tensors):
        return fn(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the backward of the attention kernels is ROADMAP B3 (training "
            "slice)")


def _launch(fn, tensors, **kwargs):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _ForwardOnly.apply(fn, kwargs, *tensors)
    return fn(*tensors, **kwargs)


def flash_attention(q, k, v, attn_mask=None, dropout_p: float = 0.0,
                    causal: bool = False, scale: Optional[float] = None,
                    return_lse: bool = False, segment_ids=None,
                    kv_segment_ids=None):
    """Public entry (parity: ``paddle.nn.functional.flash_attention``).

    CUDA tensors go to kernel K2, CPU tensors to
    :func:`flash_attention_reference`.  Packed-document ``segment_ids``,
    dropout and the backward belong to the training slice (ROADMAP A10,
    B2 segments / B3 backward) and raise; a custom ``attn_mask`` is taken
    by the plain version only."""
    if segment_ids is not None or kv_segment_ids is not None:
        raise NotImplementedError(
            "flash_attention: segment_ids belong to the training slice "
            "(ROADMAP A10 / B2 segments)")
    if dropout_p != 0.0:
        raise NotImplementedError(
            "flash_attention: dropout belongs to the training slice "
            "(ROADMAP A10)")
    if _dispatch.use_kernel(q):
        if attn_mask is not None:
            raise NotImplementedError(
                "flash_attention kernel: a custom attn_mask is not part of "
                "the kernel's contract")
        _dispatch.count_kernel_path("flash_attention", "kernel")
        out, lse = _launch(flash_attention_fwd_cuda, (q, k, v),
                           causal=causal, scale=scale)
        return (out, lse) if return_lse else out
    _dispatch.count_kernel_path("flash_attention", "plain")
    res = flash_attention_reference(q, k, v, attn_mask=attn_mask,
                                    causal=causal, scale=scale,
                                    return_lse=True)
    return res if return_lse else res[0]


def _is_per_row(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.dim() == 1


def cached_decode_attention_reference(q, k_cache, v_cache, pos,
                                      scale: Optional[float] = None,
                                      live_len: Optional[int] = None):
    """The plain version of kernel K1: masked softmax over the cache read.

    q: (B, s, Hq, D) new-token queries; k_cache/v_cache: (B, L, Hkv, D)
    with the new K/V already written at ``pos..pos+s-1``; key j is visible
    to query i of row b iff ``j <= pos_b + i``.  ``pos``: an int (or 0-d
    tensor) for the whole batch, or an int (B,) tensor of per-row
    positions.  ``live_len``: optional bound on max(pos)+s — only the
    first ``live_len`` slots are read.  GQA stays grouped (no K/V repeat).
    Math in float32; returns (B, s, Hq, D) in q.dtype.  A row with every
    key masked returns 0 (the kernels' convention)."""
    b, s, hq, d = q.shape
    if live_len is not None and live_len < k_cache.shape[1]:
        k_cache = k_cache[:, :live_len]
        v_cache = v_cache[:, :live_len]
    L, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    dev = q.device
    qg = q.float().reshape(b, s, hkv, g, d)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg, k_cache.float()) * scale
    kj = torch.arange(L, device=dev)
    si = torch.arange(s, device=dev)
    if _is_per_row(pos):
        qi = pos.to(dev).long()[:, None] + si[None, :]           # (B, s)
        keep = (kj[None, None] <= qi[:, :, None])[:, None, None]  # B,1,1,s,L
    else:
        qi = torch.as_tensor(pos, device=dev).long() + si[:, None]  # (s, 1)
        keep = (kj[None] <= qi)[None, None, None]                 # 1,1,1,s,L
    scores = scores.masked_fill(~keep, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * keep
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    out = torch.einsum("bkgsl,blkd->bskgd", w, v_cache.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def cached_decode_attention(q, k_cache, v_cache, pos,
                            scale: Optional[float] = None,
                            extra_mask=None, live_len: Optional[int] = None,
                            block_tables=None, k_scale=None, v_scale=None):
    """Incremental decode attention over a pre-allocated contiguous cache
    — the serving hot path.  Shapes and masking as in
    :func:`cached_decode_attention_reference`.

    CUDA tensors go to kernel K1, which walks only each row's live prefix
    ``[0, pos_b + s)``; CPU tensors go to the plain version.  The paged
    layout (``block_tables``: ROADMAP A6.1 / B1b), the int8 cache
    (``k_scale``/``v_scale``: A6.4 / B1d) and ``extra_mask`` (the
    reference's XLA-only option, B1 follow-up) raise."""
    if block_tables is not None:
        raise NotImplementedError(
            "cached_decode_attention: the paged cache is ROADMAP A6.1 / "
            "B1b")
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "cached_decode_attention: the int8 cache is ROADMAP A6.4 / B1d")
    if extra_mask is not None:
        raise NotImplementedError(
            "cached_decode_attention: extra_mask is not ported (ROADMAP "
            "B1, follow-up of the contiguous slice)")
    if _dispatch.use_kernel(q):
        _dispatch.count_kernel_path("decode_attention", "kernel")
        return _launch(decode_attention_cuda, (q, k_cache, v_cache),
                       pos=pos, scale=scale, live_len=live_len)
    _dispatch.count_kernel_path("decode_attention", "plain")
    return cached_decode_attention_reference(q, k_cache, v_cache, pos,
                                             scale=scale, live_len=live_len)


def cache_mask(pos, q_len: int, kv_len: int, device=None):
    """Bool (1, 1, q_len, kv_len) mask for attention over a pre-allocated
    cache: query i (position pos+i) may attend slot j iff j <= pos+i.  A
    (B,) ``pos`` tensor yields (B, 1, q_len, kv_len)."""
    if _is_per_row(pos):
        device = pos.device
    kj = torch.arange(kv_len, device=device)
    si = torch.arange(q_len, device=device)
    if _is_per_row(pos):
        qi = pos.long()[:, None] + si[None, :]
        return (kj[None, None] <= qi[:, :, None])[:, None]
    qi = torch.as_tensor(pos, device=device).long() + si[:, None]
    return (kj[None] <= qi)[None, None]
