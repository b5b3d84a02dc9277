"""Attention: plain PyTorch versions + dispatch to the CUDA kernels
(mirrors ``paddle_tpu/ops/attention.py``).

Layout as in the reference: ``(batch, seq, heads, head_dim)``; GQA passes
fewer KV heads than query heads.  Two entries:

  * :func:`flash_attention` — blocked attention over fresh Q/K/V (the
    wave-prefill path at ``pos == 0`` and every training forward), with
    packed-document segment ids; kernel K2 forward
    (``ops/cuda/flash_attention.py``) and, under autograd, K5/K6 backward
    (``ops/cuda/flash_attention_bwd.py``) through :class:`FlashAttention`,
    the counterpart of the reference's ``custom_vjp`` (``_flash``);
  * :func:`cached_decode_attention` — attention of new tokens over a
    pre-allocated cache: contiguous (every decode tick of the default
    engine; kernel K1, ``ops/cuda/decode_attention.py``) or the paged pool
    through a block table (the paged engine: K1's paged build at s = 1,
    K2's paged build for a suffix prefill at s > 1,
    ``ops/cuda/flash_attention.py``); an int8 cache with its float32
    scales (``k_scale`` / ``v_scale``) goes to the int8 builds of the same
    three kernels.  A contiguous window of ``CONTIGUOUS_Q_TILED_MIN`` or
    more queries, and a chunk addressed by cache row (``rows``: the
    chunked engine's prompt chunk), run the paged builds over the
    contiguous cache viewed as a pool under its identity table
    (:func:`identity_view`), the reference's "paged under the identity
    table" (``paddle_tpu/ops/pallas/decode_attention.py:303-311``).

Routing follows ``ops/_dispatch.py``: a CUDA tensor goes to the kernel,
which launches or raises; a CPU tensor goes to the plain version.  Features
outside this slice raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _dispatch
from .cuda.decode_attention import (decode_attention_cuda,
                                   decode_attention_int8_cuda,
                                   decode_attention_paged_cuda,
                                   decode_attention_paged_int8_cuda)
from .cuda.flash_attention import (flash_attention_fwd_cuda,
                                   flash_attention_fwd_paged_cuda,
                                   flash_attention_fwd_paged_int8_cuda)
from .cuda.flash_attention_bwd import (flash_attention_bwd_dkv_cuda,
                                       flash_attention_bwd_dq_cuda)

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def flash_attention_reference(q, k, v, attn_mask=None, causal: bool = False,
                              scale: Optional[float] = None,
                              return_lse: bool = True, segment_ids=None,
                              kv_segment_ids=None):
    """Stable attention in float32 — the plain version of kernel K2
    (float64 inputs are computed in float64 throughout: an exact yardstick
    for the float32 kernel).

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    ``attn_mask``: bool (True = keep) or additive float mask broadcastable
    to (B, Hq, Sq, Skv).  Causal masking is bottom-right aligned
    (query i sees keys j <= i + Skv - Sq); ``segment_ids`` /
    ``kv_segment_ids`` mask cross-document pairs (:func:`_keep_mask`).
    Fully-masked rows give out = 0 and lse = -1e30.  Returns (out, lse)
    with lse (B, Hq, Sq) float32 (float64 for float64 inputs)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    acc = torch.promote_types(q.dtype, torch.float32)
    qt = q.transpose(1, 2).to(acc) * scale
    kt = k.transpose(1, 2).to(acc)
    scores = torch.einsum("bhqd,bhkd->bhqk", qt, kt)
    keep = _keep_mask(sq, skv, causal, segment_ids, kv_segment_ids, q.device)
    if keep is not None:
        scores = scores.masked_fill(~keep, NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, NEG_INF)
        else:
            scores = scores + attn_mask.to(acc)
    m = scores.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(scores - m)
    dead = m <= NEG_INF / 2
    p = p.masked_fill(dead, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(dead, torch.full_like(m, NEG_INF),
                      m + torch.log(l.clamp_min(1e-37))).squeeze(-1)
    p = p / l.clamp_min(1e-37)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.transpose(1, 2).to(acc))
    out = out.transpose(1, 2).to(q.dtype)
    return (out, lse) if return_lse else out


def segment_mask(q_segment_ids, kv_segment_ids):
    """Packed-sequence (varlen) mask (the reference's ``segment_mask``,
    ``paddle_tpu/ops/attention.py`` :616): query i may attend key j iff
    they belong to the same packed document.  (B, Sq) / (B, Skv) ints ->
    bool (B, 1, Sq, Skv), combinable with ``causal=True``."""
    return (q_segment_ids[:, None, :, None]
            == kv_segment_ids[:, None, None, :])


def _keep_mask(sq: int, skv: int, causal: bool, segment_ids,
               kv_segment_ids, device):
    """Bool mask broadcastable to (B, H, Sq, Skv) of the visible pairs, or
    None when every pair is visible: the one rule of which (query, key)
    pairs the plain forward and backward see (causal bottom-right, same
    packed document; ``kv_segment_ids`` defaults to ``segment_ids``)."""
    keep = None
    if causal:
        qi = torch.arange(sq, device=device)[:, None] + (skv - sq)
        keep = torch.arange(skv, device=device)[None, :] <= qi
    if segment_ids is not None:
        seg = segment_mask(segment_ids.to(device),
                           (segment_ids if kv_segment_ids is None
                            else kv_segment_ids).to(device))
        keep = seg if keep is None else keep & seg
    return keep


def flash_attention_bwd_reference(q, k, v, out, lse, do, dlse=None,
                                  causal: bool = False,
                                  scale: Optional[float] = None,
                                  segment_ids=None, kv_segment_ids=None):
    """The plain version of kernels K5 / K6: the Flash-2 backward formulas
    of the reference's ``_bwd`` (``paddle_tpu/ops/pallas/flash_attention.py``
    :350) in float32, never the kernels.

    q, out, do: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); lse (and the lse
    cotangent ``dlse``, None = zeros): (B, Hq, Sq).  ``do`` is cast to
    q's dtype first (:353); ``delta = rowsum(dO * O) - dlse`` (:360-364);
    ``P = exp(S * scale - lse)``, zero where masked (causal bottom-right,
    segment ids), so a row with every key masked gets zero gradient;
    ``dS = P * (dP - delta) * scale``.  dk / dv are summed over each GQA
    group in float32 and rounded once (the reference rounds per q head,
    then sums: equal at float32).  float64 inputs are computed in float64
    throughout (an exact yardstick for the float32 kernels' long sums).
    Returns (dq, dk, dv) in the inputs' dtypes."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    do = do.to(q.dtype)
    qf = q.to(acc).transpose(1, 2)                     # (B, Hq, Sq, D)
    kf = _repeat_kv(k, g).to(acc).transpose(1, 2)      # (B, Hq, Skv, D)
    vf = _repeat_kv(v, g).to(acc).transpose(1, 2)
    dof = do.to(acc).transpose(1, 2)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.to(acc)[..., None])
    keep = _keep_mask(sq, skv, causal, segment_ids, kv_segment_ids,
                      q.device)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    delta = (dof * out.to(acc).transpose(1, 2)).sum(-1)
    if dlse is not None:
        delta = delta - dlse.to(acc)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, hkv, g, skv, d).sum(2)
    dv = dv.reshape(b, hkv, g, skv, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Flash attention with a kernel forward and a kernel backward — the
    counterpart of the reference's ``_flash`` ``custom_vjp``
    (``paddle_tpu/ops/pallas/flash_attention.py`` :453-464).  Forward is
    K2, which saves q, k, v, out and lse; backward folds the lse cotangent
    into ``delta = rowsum(dO * O) - dlse`` (plain elementwise work, as
    the reference leaves it to XLA) and launches K5 (dq) and K6 (dk, dv).
    Returns (out, lse), both differentiable.  K5 and K6 take K2's head
    dims and dtypes (``flash_attention_bwd.py`` ``BWD_HEAD_DIMS``: DiT's
    72 and a Gemma-2B-wide Llama's 256 among them, float16 too), so
    whatever runs forward here has its backward; K2 refuses any other head
    dim before a launch."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, kv_segment_ids, causal, scale):
        out, lse = flash_attention_fwd_cuda(
            q, k, v, causal=causal, scale=scale, segment_ids=segment_ids,
            kv_segment_ids=kv_segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids,
                              kv_segment_ids)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, seg, kv_seg = ctx.saved_tensors
        do = (torch.zeros_like(out) if dout is None
              else dout.to(q.dtype).contiguous())
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()
        kw = dict(causal=ctx.causal, scale=ctx.scale, segment_ids=seg,
                  kv_segment_ids=kv_seg)
        dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None


class _ForwardOnly(torch.autograd.Function):
    """Runs a cached-decode kernel under autograd and refuses the
    backward: the flash-decode kernels have no VJP in the reference
    either (they serve inference), and a silently detached gradient
    would be wrong."""

    @staticmethod
    def forward(ctx, fn, kwargs, *tensors):
        return fn(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the cached-decode attention kernels have no backward (nor does "
            "the reference's flash-decode kernel); train through "
            "flash_attention")


def _launch(fn, tensors, **kwargs):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _ForwardOnly.apply(fn, kwargs, *tensors)
    return fn(*tensors, **kwargs)


def flash_attention(q, k, v, attn_mask=None, dropout_p: float = 0.0,
                    causal: bool = False, scale: Optional[float] = None,
                    return_lse: bool = False, segment_ids=None,
                    kv_segment_ids=None):
    """Public entry (parity: ``paddle.nn.functional.flash_attention``).

    CUDA tensors go to kernel K2 — under autograd through
    :class:`FlashAttention`, whose backward is K5 / K6 — and CPU tensors
    to :func:`flash_attention_reference` under ordinary autograd.

    ``segment_ids``: (B, Sq) ints marking packed-document membership;
    cross-document pairs are masked (inside the kernels on the card).
    ``kv_segment_ids``: (B, Skv) ids for keys that are not the queries'
    own positions; defaults to ``segment_ids``, which then needs
    Sq == Skv (the reference's checks, :652-660).  Dropout is not ported
    (ROADMAP A10) and raises; a custom ``attn_mask`` is taken by the plain
    version only."""
    if (segment_ids is not None and kv_segment_ids is None
            and q.shape[1] != k.shape[1]):
        raise ValueError(
            "segment_ids without kv_segment_ids assume self-attention "
            f"(q and kv share positions); got sq={q.shape[1]}, "
            f"skv={k.shape[1]} — pass kv_segment_ids for cross-slice "
            "attention")
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError("kv_segment_ids requires segment_ids")
    if dropout_p != 0.0:
        raise NotImplementedError(
            "flash_attention: dropout is not ported (ROADMAP A10)")
    if _dispatch.use_kernel(q):
        if attn_mask is not None:
            raise NotImplementedError(
                "flash_attention kernel: a custom attn_mask is not part of "
                "the kernel's contract")
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v))
        _dispatch.count_kernel_path("flash_attention", "kernel")
        if grad:
            out, lse = FlashAttention.apply(q, k, v, segment_ids,
                                            kv_segment_ids, causal, scale)
        else:
            out, lse = flash_attention_fwd_cuda(
                q, k, v, causal=causal, scale=scale, segment_ids=segment_ids,
                kv_segment_ids=kv_segment_ids)
        return (out, lse) if return_lse else out
    _dispatch.count_kernel_path("flash_attention", "plain")
    res = flash_attention_reference(q, k, v, attn_mask=attn_mask,
                                    causal=causal, scale=scale,
                                    return_lse=True, segment_ids=segment_ids,
                                    kv_segment_ids=kv_segment_ids)
    return res if return_lse else res[0]


def _is_per_row(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.dim() == 1


# Contiguous windows of at least this many queries run K2-paged (the
# q-tiled flash kernel) over the identity view instead of K1, whose 8-row
# tiles each re-read the live prefix: on an H100 at the Llama-3-8B widths,
# 8 rows at the decode tick's depths, K1 is the faster at s = 4 and K2 at
# s = 16, 64 and 256 (the ``crossover`` line of chip_smoke.py phase 2,
# PERF.md).  At head_dim 256 (8 query heads over one KV head; the
# ``crossover_d256`` line, NVIDIA H100 80GB HBM3, 700 W) the two are even
# at s = 16 in bf16 (48.6 / 50.8 us) and K1-int8 is still the faster there
# (42.9 / 95.1 us); K2 wins from s = 64 in both.  Shorter windows (the
# spec-verify window, s = k + 1) stay on K1.
CONTIGUOUS_Q_TILED_MIN = 16
# the identity view's block length for a model-dtype cache: K2-paged's
# bfloat16 build loads 64-key boxes, each inside one block
IDENTITY_BLOCK = 64


def _identity_block(L: int, k_scale=None) -> int:
    if k_scale is not None:
        return L // k_scale.shape[1]
    return IDENTITY_BLOCK if L % IDENTITY_BLOCK == 0 else L


def identity_view(k_cache, v_cache, k_scale=None, v_scale=None):
    """The contiguous cache (B, L, Hkv, D) as a pool (B * L / bl, bl, Hkv,
    D) — a free reshape — with the block length ``bl``; row b's block j is
    pool block ``b * L / bl + j``.  A model-dtype cache takes
    ``IDENTITY_BLOCK`` (or L when it does not divide L); an int8 cache
    takes its scale granule ``L // n_gran``, so its (B, n_gran, Hkv)
    scales are the pool's (B * n_gran, Hkv) block scales unchanged (the
    unit layout of ``models/llama.py::quantized_contiguous_write``).
    Returns (k_pool, v_pool, k_scale, v_scale, bl); the scales stay None
    for a model-dtype cache."""
    b, L, hkv, d = k_cache.shape
    bl = _identity_block(L, k_scale)
    if k_scale is not None:
        k_scale = k_scale.reshape(-1, k_scale.shape[2])
        v_scale = v_scale.reshape(-1, v_scale.shape[2])
    return (k_cache.view(b * L // bl, bl, hkv, d),
            v_cache.view(b * L // bl, bl, hkv, d), k_scale, v_scale, bl)


def identity_tables(rows: torch.Tensor, L: int, bl: int) -> torch.Tensor:
    """(n, L / bl) int32 identity tables of the cache rows ``rows`` (n,):
    row r's block j is ``rows[r] * L / bl + j``."""
    nblk = L // bl
    j = torch.arange(nblk, device=rows.device, dtype=torch.int32)
    return rows.to(torch.int32)[:, None] * nblk + j[None, :]


def cached_decode_attention_reference(q, k_cache, v_cache, pos,
                                      scale: Optional[float] = None,
                                      live_len: Optional[int] = None,
                                      block_tables=None, k_scale=None,
                                      v_scale=None):
    """The plain version of kernel K1 (and of the paged builds of K1 and
    K2): masked softmax over the cache read.

    q: (B, s, Hq, D) new-token queries; k_cache/v_cache: (B, L, Hkv, D)
    with the new K/V already written at ``pos..pos+s-1``; key j is visible
    to query i of row b iff ``j <= pos_b + i``.  ``pos``: an int (or 0-d
    tensor) for the whole batch, or an int (B,) tensor of per-row
    positions.  ``live_len``: optional bound on max(pos)+s — only the
    first ``live_len`` slots are read.  GQA stays grouped (no K/V repeat).
    Math in float32 (float64 for float64 q: an exact yardstick for the
    float32 kernels); returns (B, s, Hq, D) in q.dtype.  A row with every
    key masked returns 0 (the kernels' convention).

    ``block_tables`` (int (B, max_blocks)): the PAGED layout
    (``serving/kv_cache.py``) — k_cache/v_cache are the pooled
    (num_blocks, block_len, Hkv, D) tensors; each row's physical blocks
    are gathered into a contiguous (B, max_blocks * block_len, Hkv, D)
    view first (``live_len`` trims whole table columns before the
    gather), after which the math is the same.

    ``k_scale`` / ``v_scale``: the int8 cache's float32 scales — paged
    ``(num_blocks, Hkv)``, one per (block, kv head), gathered with the
    blocks; contiguous ``(B, n_gran, Hkv)``, each row viewed as n_gran
    granules of ``L // n_gran`` positions.  The payload is widened to
    float32 and multiplied by its scale before the math (the reference's
    ``_dequant_decode_attention``)."""
    b, s, hq, d = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache needs both k_scale and v_scale")
    if block_tables is not None:
        n_pool, bl, hkv_p, _ = k_cache.shape
        mb = block_tables.shape[1]
        if live_len is not None and live_len < mb * bl:
            mb = -(-int(live_len) // bl)
            block_tables = block_tables[:, :mb]
        idx = block_tables.to(k_cache.device).long().clamp(0, n_pool - 1)
        k_cache, v_cache = k_cache[idx], v_cache[idx]   # (B, mb, bl, Hkv, D)
        if k_scale is not None:
            k_cache = k_cache.to(acc) * k_scale.to(acc)[idx][:, :, None, :,
                                                              None]
            v_cache = v_cache.to(acc) * v_scale.to(acc)[idx][:, :, None, :,
                                                              None]
        k_cache = k_cache.reshape(b, mb * bl, hkv_p, d)
        v_cache = v_cache.reshape(b, mb * bl, hkv_p, d)
    elif k_scale is not None:
        _, L0, hkv_c, _ = k_cache.shape
        n_gran = k_scale.shape[1]
        gr = L0 // n_gran
        k_cache = (k_cache.to(acc).reshape(b, n_gran, gr, hkv_c, d)
                   * k_scale.to(acc)[:, :, None, :, None]).reshape(
                       b, L0, hkv_c, d)
        v_cache = (v_cache.to(acc).reshape(b, n_gran, gr, hkv_c, d)
                   * v_scale.to(acc)[:, :, None, :, None]).reshape(
                       b, L0, hkv_c, d)
    if live_len is not None and live_len < k_cache.shape[1]:
        k_cache = k_cache[:, :live_len]
        v_cache = v_cache[:, :live_len]
    L, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    dev = q.device
    qg = q.to(acc).reshape(b, s, hkv, g, d)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg, k_cache.to(acc)) * scale
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
    out = torch.einsum("bkgsl,blkd->bskgd", w, v_cache.to(acc))
    return out.reshape(b, s, hq, d).to(q.dtype)


def cached_decode_attention(q, k_cache, v_cache, pos,
                            scale: Optional[float] = None,
                            extra_mask=None, live_len: Optional[int] = None,
                            block_tables=None, k_scale=None, v_scale=None,
                            rows=None):
    """Incremental decode attention over a pre-allocated cache — the
    serving hot path.  Shapes and masking as in
    :func:`cached_decode_attention_reference`.

    ``rows`` (contiguous only): an int (n,) tensor, query row r reading
    cache row ``rows[r]`` (q has n rows, the cache any number) — the
    chunked engine's prompt chunk, which streams into one slot's row
    (the reference slices that row out, ``_slot_row``).

    CUDA tensors go to a kernel, CPU tensors to the plain version:

      * contiguous cache: kernel K1, which walks only each row's live
        prefix ``[0, pos_b + s)``; at ``s >= CONTIGUOUS_Q_TILED_MIN``, or
        with ``rows``, the paged builds below over the cache's
        :func:`identity_view` (K2-paged at s > 1, K1-paged at s = 1);
      * paged pool (``block_tables``): K1's paged build at ``s == 1``
        (every decode tick), K2's paged build at ``s > 1`` (a suffix
        prefill: causal at per-row offset ``pos_b``);
      * an int8 cache (``k_scale`` / ``v_scale``, shapes as in the plain
        version): the int8 builds of the same kernels — K1-int8
        (contiguous), K1-paged-int8 (s = 1), K2-paged-int8 (s > 1).

    ``extra_mask`` (the reference's XLA-only option, B1 follow-up)
    raises."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache needs both k_scale and v_scale")
    int8 = k_scale is not None
    if extra_mask is not None:
        raise NotImplementedError(
            "cached_decode_attention: extra_mask is not ported (ROADMAP "
            "B1, follow-up of the contiguous slice)")
    if rows is not None and block_tables is not None:
        raise ValueError("rows addresses a contiguous cache; a paged pool "
                         "is addressed by its block_tables")
    sfx = "_int8" if int8 else ""
    if block_tables is None and (rows is not None or (
            q.shape[1] >= CONTIGUOUS_Q_TILED_MIN and _dispatch.use_kernel(q)
            and _identity_block(k_cache.shape[1], k_scale)
            % IDENTITY_BLOCK == 0)):
        L = k_cache.shape[1]
        k_cache, v_cache, k_scale, v_scale, bl = identity_view(
            k_cache, v_cache, k_scale, v_scale)
        if rows is None:
            rows = torch.arange(q.shape[0], device=q.device)
        block_tables = identity_tables(rows.to(q.device), L, bl)
    scales = dict(k_scale=k_scale, v_scale=v_scale) if int8 else {}
    if block_tables is not None:
        op = ("decode_attention_paged" if q.shape[1] == 1
              else "paged_prefill") + sfx
        if _dispatch.use_kernel(q):
            _dispatch.count_kernel_path(op, "kernel")
            if q.shape[1] == 1:
                fn = (decode_attention_paged_int8_cuda if int8
                      else decode_attention_paged_cuda)
                return _launch(fn, (q, k_cache, v_cache), pos=pos,
                               block_tables=block_tables, scale=scale,
                               live_len=live_len, **scales)
            fn = (flash_attention_fwd_paged_int8_cuda if int8
                  else flash_attention_fwd_paged_cuda)
            return _launch(fn, (q, k_cache, v_cache), pos=pos,
                           block_tables=block_tables, scale=scale, **scales)
        _dispatch.count_kernel_path(op, "plain")
        return cached_decode_attention_reference(
            q, k_cache, v_cache, pos, scale=scale, live_len=live_len,
            block_tables=block_tables, **scales)
    if _dispatch.use_kernel(q):
        _dispatch.count_kernel_path("decode_attention" + sfx, "kernel")
        fn = decode_attention_int8_cuda if int8 else decode_attention_cuda
        return _launch(fn, (q, k_cache, v_cache), pos=pos, scale=scale,
                       live_len=live_len, **scales)
    _dispatch.count_kernel_path("decode_attention" + sfx, "plain")
    return cached_decode_attention_reference(q, k_cache, v_cache, pos,
                                             scale=scale, live_len=live_len,
                                             **scales)


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
