"""Llama-family decoder (mirrors ``paddle_tpu/models/llama.py``).

Parameter names and layouts are the reference's, one to one: every
projection is an ``(in, out)`` matrix applied as ``x @ W``, the embedding is
``(vocab, hidden)``, the RoPE caches are the buffers ``model.rope_cos`` /
``model.rope_sin``.  ``models/convert.py`` loads a JAX ``state_dict`` into
this model by name.

Kernels on this path: attention at ``pos == 0`` (wave prefill) and in
``forward`` goes to flash-attention (K2), incremental decode to
flash-decode (K1), every RMSNorm to K3.  With a paged cache
(``block_tables``) a decode step goes to K1-paged and a suffix prefill
(s > 1) to K2-paged.  The int8 caches (``init_kv_cache`` /
``init_paged_kv_cache`` with ``quantized=True``, a ``{"kv", "scale"}``
dict) quantize K/V as they are written (:func:`quantized_paged_write`,
:func:`quantized_contiguous_write`) and are read by the int8 builds of
K1, K1-paged and K2-paged.  The projection, MLP and LM-head products go
through one seam, ``nn/quant.py::linear``: ``torch.matmul`` for a plain
weight (as the reference leaves them to XLA), ``weight_only_linear`` for
the int8 weights of ``models/quantized.py`` (kernel K4 at decode rows).

Training: ``forward`` / ``compute_loss`` take packed-document
``segment_ids`` (masked inside K2 and its backward K5/K6 on the card);
``config.recompute`` checkpoints each decoder block under
``self.training`` (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``).  On one GPU ``context_parallel`` "ring" / "ulysses"
run plain flash attention, as the reference does without a ``sep`` axis.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as TF
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from .. import default_device
from ..nn import functional as F
from ..nn.common import RMSNorm
from ..nn.quant import Int8Weight, embedding, linear
from ..ops import (build_rope_cache, cached_decode_attention,
                   flash_attention, fused_rope)

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "causal_lm_loss",
           "llama3_8b_config", "mask_boundary_labels", "tiny_llama_config"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    dtype: str = "float32"
    recompute: bool = False
    # remat policy when recompute=True: "full" (save only block
    # boundaries) or "dots" (save the matmul outputs, recompute the rest)
    recompute_policy: str = "full"
    # "ring" | "ulysses" | "gspmd": on one GPU all three run plain flash
    # attention (context parallelism across cards is ROADMAP A10)
    context_parallel: str = "ring"

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{self.dtype!r}")
        if self.context_parallel not in ("ring", "ulysses", "gspmd"):
            raise ValueError(
                f"context_parallel must be 'ring', 'ulysses' or 'gspmd', "
                f"got {self.context_parallel!r}")
        if self.recompute_policy not in ("full", "dots"):
            raise ValueError(
                f"recompute_policy must be 'full' or 'dots', "
                f"got {self.recompute_policy!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def llama3_8b_config(**overrides) -> LlamaConfig:
    """Llama-3-8B (the reference's BASELINE.md workload)."""
    cfg = LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=8192, rms_norm_eps=1e-5, rope_theta=500000.0,
        dtype="bfloat16")
    return dataclasses.replace(cfg, **overrides)


def tiny_llama_config(**overrides) -> LlamaConfig:
    """Small config for tests and dry runs."""
    cfg = LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128)
    return dataclasses.replace(cfg, **overrides)


def _param(shape, config: LlamaConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=config.torch_dtype,
                                    device=device))


def _touched(first_off: torch.Tensor, s: int, span: int):
    """(B, n) token indices, one in each ``span``-long block (or granule) a
    row's s consecutive positions touch, the first at in-block offset
    ``first_off``; n = ceil((s-1)/span) + 1 is the most a row can touch and
    short rows repeat their token 0 (a repeat rewrites the same block with
    the same payload).  None for s = 1: the token is its own
    representative."""
    if s == 1:
        return None
    n = -(-(s - 1) // span) + 1
    j = torch.arange(n, device=first_off.device)
    t1 = span - first_off.long()          # the first token of the 2nd block
    t = torch.where(j[None] == 0, 0, t1[:, None] + (j[None] - 1) * span)
    return torch.where(t < s, t, 0)


_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def _quantized_write(kvb: torch.Tensor, scb: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, unit: torch.Tensor, cell: torch.Tensor,
                     reps, drop=None) -> None:
    """The shared body of the two int8 writes, in place, for K and V of
    one layer at once.  ``kvb``: (2U, span, Hkv, D) int8 units (blocks or
    row granules), K's U then V's; ``scb``: (2U, Hkv) float32 scales, in
    the same order; ``k`` / ``v``: (B, s, Hkv, D) new K and V; ``unit`` /
    ``cell``: (B, s) each token's K unit and offset in it (its V unit is
    ``unit + U``); ``reps``: (B, n) token indices covering every unit the
    tokens touch (:func:`_touched`, None for s = 1).  K's and V's units
    are disjoint, so one pass over both is two passes' result.

    ``drop`` (bool (B, s), None = none): tokens whose write is dropped
    leave every scale and payload byte as it was.  A dropped token must
    carry a ``(unit, cell)`` that no kept token of the call writes (the
    caller's choice); it needs no scale, so a unit only dropped tokens
    touch keeps its scale and its payload (ratio 1), and it writes back
    at its cell what phase 1 left there.

    The payload ratio is ``old / new`` where the scale grew and 1 where
    it did not: equal to the reference's ``old / new`` (0 for a zero
    ``new``) except for a unit whose scale stays 0, whose payload bytes
    the reference clears and this write keeps — invisible, as a zero
    scale dequantizes any payload to 0, and the unit's first nonzero
    scale clears them (ratio 0)."""
    u = scb.shape[0] // 2
    hkv = k.shape[2]
    xf = torch.cat([k, v]).float()                          # (2B, s, Hkv, D)
    unit = torch.cat([unit, unit + u])
    cell = torch.cat([cell, cell])
    blk = unit if reps is None else unit.gather(1, torch.cat([reps, reps]))
    # absmax / 127 as the reference's compiled write computes it: XLA turns
    # the division by a constant into a product by its float32 reciprocal
    needed = xf.abs().amax(dim=-1) * _INV_127               # (2B, s, Hkv)
    if drop is not None:
        drop = torch.cat([drop, drop])
        needed = needed.masked_fill(drop[..., None], 0.0)
    old = scb[blk]                                          # (2B, n, Hkv)
    # phase 1: scatter-max the needed scales (order-independent under
    # duplicate units), then re-express each touched unit's payload under
    # its new scale; duplicates of a unit share (old, new) and so write
    # the same payload; a zero scale (a fresh unit) clears it
    scb.scatter_reduce_(0, unit.reshape(-1, 1).expand(-1, hkv),
                        needed.reshape(-1, hkv), "amax")
    new = scb[blk]
    ratio = torch.where(new > old, old / new, 1.0)
    pay = kvb[blk].float() * ratio[:, :, None, :, None]
    kvb[blk] = torch.round(pay).clamp_(-127, 127).to(torch.int8)
    # phase 2: each token under its unit's final scale (a guard divisor of
    # 1 where that is 0), at its own cell
    tsc = scb[unit]
    tok = torch.round(xf / torch.where(tsc > 0, tsc, 1.0)[..., None])
    tok = tok.clamp_(-127, 127).to(torch.int8)
    if drop is not None:
        tok = torch.where(drop[..., None, None], kvb[unit, cell], tok)
    kvb[unit, cell] = tok


def quantized_paged_write(kv: torch.Tensor, sc: torch.Tensor, idx: int,
                          k: torch.Tensor, v: torch.Tensor,
                          phys: torch.Tensor, off: torch.Tensor) -> None:
    """Scatter-time int8 quantization of one layer's new K and V into the
    paged pool, in place — the reference's ``_quantized_paged_write``
    (``paddle_tpu/models/llama.py`` :116), which the reference calls once
    for K and once for V.  ``kv``: (L, 2, nb, bl, Hkv, D) int8 pool;
    ``sc``: (L, 2, nb, Hkv) float32 per-block-per-kv-head scales; ``k`` /
    ``v``: (B, s, Hkv, D) of layer ``idx``; ``phys`` / ``off``: (B, s)
    physical block / in-block offset of each token, a row's tokens at
    consecutive positions.

    Scales are running maxima: a token whose absmax exceeds its block's
    scale grows it, and the block's existing payload is rewritten under
    the new scale (``round(payload * old / new)``).  The reference does
    that per token, gathering a (B, s, bl, Hkv, D) payload copy; here each
    touched block is rewritten once (at most ceil((s-1)/bl) + 1 a row),
    which gives the same result because every duplicate carries the same
    payload.  Pad tokens ride in with ``phys == 0`` (the null block), whose
    contents no reader trusts; a zero final scale quantizes through a
    guard divisor of 1."""
    nb, bl = kv.shape[2], kv.shape[3]
    _quantized_write(kv[idx].view(2 * nb, *kv.shape[3:]),
                     sc[idx].view(2 * nb, sc.shape[3]), k, v, phys, off,
                     _touched(off[:, 0], k.shape[1], bl))


@dataclasses.dataclass
class _RowWrites:
    """Where a per-row write into the contiguous cache goes, computed once
    a model pass (every layer writes the same cells): ``rows`` (B,) the
    cache row of each batch row; ``pos`` (B, s) the write positions, with
    every position at or past the row length dropped, as the reference's
    scatters drop them — the chunked engine's idle rows at ``max_length``
    and a chunk's pad tail past it; ``drop`` (B, s) which.  A dropped
    token is steered to position 0 of its own row, which no kept token of
    the call writes: a row that drops a token starts at
    ``pos > L - s > 0`` (callers keep s <= L)."""

    rows: torch.Tensor
    pos: torch.Tensor
    drop: torch.Tensor

    @classmethod
    def make(cls, position_ids: torch.Tensor, L: int, rows=None):
        b, s = position_ids.shape
        dev = position_ids.device
        drop = position_ids >= L
        return cls(torch.arange(b, device=dev) if rows is None
                   else rows.to(dev).long(),
                   position_ids.long().masked_fill(drop, 0), drop)


def quantized_contiguous_write(kv: torch.Tensor, sc: torch.Tensor,
                               idx: int, k: torch.Tensor, v: torch.Tensor,
                               position_ids: torch.Tensor) -> None:
    """The contiguous-row form of :func:`quantized_paged_write`, in place
    (the reference's ``_quantized_contiguous_write``, :161): the scale
    granule (``max_len // n_gran`` positions of one row) plays the block's
    role.  ``kv``: (L, 2, B, max_len, Hkv, D) int8; ``sc``: (L, 2, B,
    n_gran, Hkv) float32; ``position_ids``: (B, s) or (1, s).
    Positions at or past ``max_len`` are dropped (:class:`_RowWrites`):
    every scale and payload byte they would touch stays as it was, as in
    the reference."""
    b, s = k.shape[:2]
    _quantized_rows_write(kv, sc, idx, k, v, _RowWrites.make(
        position_ids.expand(b, s), kv.shape[3]))


def _quantized_rows_write(kv, sc, idx: int, k, v, w: _RowWrites) -> None:
    nrow, L = kv.shape[2], kv.shape[3]
    n_gran = sc.shape[3]
    gr = L // n_gran
    unit = w.rows[:, None] * n_gran + w.pos // gr
    _quantized_write(kv[idx].view(2 * nrow * n_gran, gr, *kv.shape[4:]),
                     sc[idx].view(2 * nrow * n_gran, sc.shape[4]), k, v,
                     unit, w.pos % gr, _touched(w.pos[:, 0] % gr,
                                                k.shape[1], gr), w.drop)


def _contiguous_write(cache: torch.Tensor, idx: int, k: torch.Tensor,
                      v: torch.Tensor, w: _RowWrites) -> None:
    """Per-row K/V write into the model-dtype contiguous cache (L, 2, B,
    max_len, Hkv, D), in place (:class:`_RowWrites`).  A dropped token
    writes back the value its row already holds at position 0, so one
    index write serves every row, kept or not, with no read back to the
    host."""
    layer = cache[idx]                                   # (2, B, L, Hkv, D)
    new = torch.stack([k, v]).to(cache.dtype)             # (2, b, s, Hkv, D)
    held = layer[:, w.rows, 0]                            # (2, b, Hkv, D)
    layer[:, w.rows[:, None], w.pos] = torch.where(
        w.drop[None, :, :, None, None], held[:, :, None], new)


def _row_writes(pos: torch.Tensor, rows, s: int, L: int) -> _RowWrites:
    """The :class:`_RowWrites` of a per-row pass of ``s`` tokens a row at
    positions ``pos`` (B,) into rows of ``L`` positions."""
    if s > L:
        raise ValueError(f"a per-row write of {s} tokens exceeds the "
                         f"cache's {L} positions")
    steps = torch.arange(s, device=pos.device)
    return _RowWrites.make(pos.long()[:, None] + steps[None, :], L, rows)


def pass_writes(x: torch.Tensor, cache, pos, block_tables=None, rows=None):
    """(pos, writes) of one decode pass over the contiguous cache: with
    per-row positions (or ``rows``) every layer writes the same cells, so
    they are found once (:class:`_RowWrites`), and a row at or past the
    row length — which writes nothing and whose output is discarded (the
    chunked engine's idle rows) — attends from position 0, so the decode
    kernel does not walk its whole row.  An int ``pos`` (or a paged
    pass) comes back unchanged with no writes."""
    if block_tables is not None or (rows is None and not (
            isinstance(pos, torch.Tensor) and pos.dim() == 1)):
        return pos, None
    if not isinstance(pos, torch.Tensor) or pos.dim() != 1:
        pos = torch.full((x.shape[0],), int(pos), dtype=torch.int32,
                         device=x.device)
    L = (cache["kv"] if isinstance(cache, dict) else cache).shape[3]
    pos = pos.to(x.device)
    writes = _row_writes(pos, rows, x.shape[1], L)
    return pos.masked_fill(pos >= L, 0), writes


class LlamaAttention(nn.Module):
    """GQA attention with RoPE."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        hd, nh, nkv = c.head_dim, c.num_attention_heads, c.num_key_value_heads
        self.q_proj = _param((c.hidden_size, nh * hd), c, device)
        self.k_proj = _param((c.hidden_size, nkv * hd), c, device)
        self.v_proj = _param((c.hidden_size, nkv * hd), c, device)
        self.o_proj = _param((nh * hd, c.hidden_size), c, device)

    def _qkv(self, x, rope_cache, position_ids=None):
        c = self.config
        b, s, _ = x.shape
        q = linear(x, self.q_proj).view(b, s, c.num_attention_heads,
                                        c.head_dim)
        k = linear(x, self.k_proj).view(b, s, c.num_key_value_heads,
                                        c.head_dim)
        v = linear(x, self.v_proj).view(b, s, c.num_key_value_heads,
                                        c.head_dim)
        cos, sin = rope_cache
        q, k = fused_rope(q, k, cos, sin, position_ids)
        return q, k, v

    def forward(self, x, rope_cache, position_ids=None, segment_ids=None):
        b, s, _ = x.shape
        q, k, v = self._qkv(x, rope_cache, position_ids)
        out = flash_attention(q, k, v, causal=True, segment_ids=segment_ids)
        return linear(out.reshape(b, s, -1), self.o_proj)

    def decode(self, x, rope_cache, pos, cache, idx: int,
               block_tables=None, rows=None, writes=None):
        """Incremental decode against the STACKED cache
        (L, 2, B, max_len, Hkv, D): write this chunk's K/V IN PLACE at
        ``(idx, ., ., pos)`` — where the reference donates the cache to
        XLA, the port writes into the caller's tensor — and attend over
        this layer's slices.

        Two regimes, as in the reference:

          * **prefill** (``pos`` is the int 0 and s > 1): attention over
            the cache at pos 0 is causal attention over the chunk's own
            fresh K/V, so it runs flash-attention (K2);
          * **incremental**: :func:`cached_decode_attention` (K1), which
            reads only each row's live prefix.

        ``pos`` is an int for the whole batch or an int (B,) tensor of
        per-row positions (the serving engine's slot batch: row i writes
        at ``pos[i]..pos[i]+s-1`` and attends ``[0, pos[i] + s)``).  As in
        the reference, writes at or past ``max_len`` are dropped and
        leave the cache as it was (the chunked engine's idle rows sit at
        ``max_len``; a prompt chunk's pad tail may pass it); their RoPE
        ids are clamped to the table.  Through :meth:`LlamaModel.decode`
        a row at or past ``max_len`` attends from position 0 (its output
        is discarded; the reference reads its whole row).

        ``rows`` (int (B,) tensor, contiguous only): batch row i is cache
        row ``rows[i]`` — the chunked engine's prompt chunk, one row of
        ``prefill_chunk`` tokens streaming into its slot (the reference
        slices that row out).  Its attention runs on K2-paged over the
        cache's identity view (``ops.attention.identity_view``).
        ``writes``: the pass's per-row write cells (:class:`_RowWrites`,
        computed once by :meth:`LlamaModel.decode`; None computes them).

        ``block_tables`` (int (B, max_blocks)) switches to the PAGED
        cache (``serving/kv_cache.py``): ``cache`` is the pooled
        (L, 2, num_blocks, block_len, Hkv, D) tensor and row i's logical
        position p lives at ``(block_tables[i, p // block_len],
        p % block_len)``; see :meth:`_decode_paged`.

        An int8 cache (a ``{"kv", "scale"}`` dict, either layout) is
        written through :func:`quantized_contiguous_write` /
        :func:`quantized_paged_write` and read with its scales; the
        ``pos == 0`` prefill still attends over the fresh K/V, so the
        quantization loss starts at the first cached read.

        x: (B, s, H*D).  Returns (out, cache) — ``cache`` is the same
        tensor (or dict), updated."""
        if block_tables is not None:
            return self._decode_paged(x, rope_cache, pos, cache, idx,
                                      block_tables)
        b, s, _ = x.shape
        per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
        if rows is not None and not per_row:
            raise ValueError("rows takes per-row positions (a (B,) pos)")
        steps = torch.arange(s, device=x.device)
        if per_row:
            position_ids = pos.long()[:, None] + steps[None, :]   # (B, s)
        else:
            position_ids = (int(pos) + steps)[None, :]              # (1, s)
        rope_ids = position_ids.clamp_max(rope_cache[0].shape[0] - 1)
        q, k, v = self._qkv(x, rope_cache, rope_ids)
        prefill = not per_row and int(pos) == 0 and s > 1
        quantized = isinstance(cache, dict)
        kvc = cache["kv"] if quantized else cache
        if per_row and writes is None:
            writes = _row_writes(pos, rows, s, kvc.shape[3])
        if quantized:
            sc = cache["scale"]
            if per_row:
                _quantized_rows_write(kvc, sc, idx, k, v, writes)
            else:
                quantized_contiguous_write(kvc, sc, idx, k, v, position_ids)
            scales = dict(k_scale=sc[idx, 0], v_scale=sc[idx, 1])
        elif per_row:
            _contiguous_write(cache, idx, k, v, writes)
            scales = {}
        else:
            p = int(pos)
            cache[idx, 0, :, p:p + s] = k.to(cache.dtype)
            cache[idx, 1, :, p:p + s] = v.to(cache.dtype)
            scales = {}
        if prefill:
            out = flash_attention(q, k, v, causal=True)
        else:
            out = cached_decode_attention(q, kvc[idx, 0], kvc[idx, 1], pos,
                                          rows=rows, **scales)
        return linear(out.reshape(b, s, -1), self.o_proj), cache

    def _decode_paged(self, x, rope_cache, pos, cache, idx, block_tables):
        """The paged branch of :meth:`decode` (the reference's
        ``LlamaAttention.decode`` with ``block_tables``, bf16 layout).

        Positions are per row (a scalar ``pos`` is broadcast).  The RoPE
        ids of prompt-pad positions past the table are clamped to the RoPE
        cache (pad outputs are never consumed).  Writes go to (physical
        block, offset) pairs; positions past the table's coverage are
        steered to the null block 0, so a padded wave never clobbers live
        or shared blocks (duplicate null-block writes are scratch).  The
        writes of ALL rows land before this layer's attention read, which
        is what lets a row of a wave adopt a block another row of the same
        wave writes in this very pass.  The read is
        :func:`cached_decode_attention` with the table: K1-paged at
        s = 1, K2-paged for a suffix prefill (their int8 builds for an
        int8 pool, which is written by :func:`quantized_paged_write`)."""
        b, s, _ = x.shape
        dev = x.device
        if not (isinstance(pos, torch.Tensor) and pos.dim() == 1):
            pos = torch.full((b,), int(pos), dtype=torch.int32, device=dev)
        position_ids = (pos.to(dev).long()[:, None]
                        + torch.arange(s, device=dev)[None, :])   # (B, s)
        rope_ids = position_ids.clamp_max(rope_cache[0].shape[0] - 1)
        q, k, v = self._qkv(x, rope_cache, rope_ids)
        quantized = isinstance(cache, dict)
        kvp = cache["kv"] if quantized else cache
        bl = kvp.shape[3]
        tables = block_tables.to(dev).long()
        max_blocks = tables.shape[1]
        lb = position_ids // bl
        rows = torch.arange(b, device=dev)[:, None]
        phys = torch.where(lb < max_blocks,
                           tables[rows, lb.clamp_max(max_blocks - 1)],
                           torch.zeros_like(lb))   # past the table -> null
        off = position_ids % bl
        if quantized:
            sc = cache["scale"]
            quantized_paged_write(kvp, sc, idx, k, v, phys, off)
            out = cached_decode_attention(
                q, kvp[idx, 0], kvp[idx, 1], pos, block_tables=block_tables,
                k_scale=sc[idx, 0], v_scale=sc[idx, 1])
            return linear(out.reshape(b, s, -1), self.o_proj), cache
        cache[idx, 0, phys, off] = k.to(cache.dtype)
        cache[idx, 1, phys, off] = v.to(cache.dtype)
        out = cached_decode_attention(q, cache[idx, 0], cache[idx, 1], pos,
                                      block_tables=block_tables)
        return linear(out.reshape(b, s, -1), self.o_proj), cache


class LlamaMLP(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = config
        self.gate_proj = _param((c.hidden_size, c.intermediate_size), c,
                                device)
        self.up_proj = _param((c.hidden_size, c.intermediate_size), c, device)
        self.down_proj = _param((c.intermediate_size, c.hidden_size), c,
                                device)

    def forward(self, x):
        return linear(F.swiglu(linear(x, self.gate_proj),
                               linear(x, self.up_proj)), self.down_proj)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = config
        self.input_layernorm = RMSNorm(c.hidden_size, epsilon=c.rms_norm_eps,
                                       dtype=c.torch_dtype, device=device)
        self.self_attn = LlamaAttention(c, device)
        self.post_attention_layernorm = RMSNorm(
            c.hidden_size, epsilon=c.rms_norm_eps, dtype=c.torch_dtype,
            device=device)
        self.mlp = LlamaMLP(c, device)

    def forward(self, x, rope_cache, position_ids=None, segment_ids=None):
        x = x + self.self_attn(self.input_layernorm(x), rope_cache,
                               position_ids, segment_ids)
        return x + self.mlp(self.post_attention_layernorm(x))

    def decode(self, x, rope_cache, pos, cache, idx: int,
               block_tables=None, rows=None, writes=None):
        a, cache = self.self_attn.decode(self.input_layernorm(x), rope_cache,
                                         pos, cache, idx, block_tables, rows,
                                         writes)
        x = x + a
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, cache


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        self.embed_tokens = _param((c.vocab_size, c.hidden_size), c, device)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(c, device) for _ in range(c.num_hidden_layers)])
        self.norm = RMSNorm(c.hidden_size, epsilon=c.rms_norm_eps,
                            dtype=c.torch_dtype, device=device)
        cos, sin = build_rope_cache(c.max_position_embeddings, c.head_dim,
                                    base=c.rope_theta, device=device)
        self.register_buffer("rope_cos", cos)
        self.register_buffer("rope_sin", sin)

    def forward(self, input_ids, position_ids=None, segment_ids=None):
        """``segment_ids``: optional (B, S) packed-document ids (several
        documents packed per row, no attention across them); pass matching
        ``position_ids`` that restart per document for the standard
        packing recipe.  With ``config.recompute`` and in training mode,
        each block runs under ``torch.utils.checkpoint``: its activations
        are recomputed in the backward (``recompute_policy`` "dots" keeps
        the matmul outputs)."""
        c = self.config
        x = embedding(self.embed_tokens, input_ids.long(), c.torch_dtype)
        rope = (self.rope_cos, self.rope_sin)
        remat = c.recompute and self.training and torch.is_grad_enabled()
        for block in self.layers:
            if remat:
                x = torch_checkpoint.checkpoint(
                    block, x, rope, position_ids, segment_ids,
                    use_reentrant=False, **_remat_kwargs(c.recompute_policy))
            else:
                x = block(x, rope, position_ids, segment_ids)
        return self.norm(x)

    def decode(self, input_ids, cache, pos, block_tables=None, rows=None):
        """Cache-carrying decode pass over the stacked cache of
        :func:`paddle_tpu_torch.models.generation.init_kv_cache` (or the
        paged pool of ``serving.kv_cache.init_paged_kv_cache`` with
        ``block_tables``); ``pos`` is the number of tokens already in the
        cache (int or per-row (B,) tensor); ``rows`` (contiguous) names
        the cache row of each batch row (:meth:`LlamaAttention.decode`).
        Returns (hidden, cache), the
        cache updated in place.  With a per-row ``pos`` tensor the pass
        reads nothing back to the host (no ``int(pos)``, no data-dependent
        shape; the int8 writes at s = 1 skip ``_touched``), which is what
        lets the serving engine capture its decode step in a CUDA graph
        (``serving/step_graph.py``); an int ``pos`` takes the scalar
        path."""
        x = embedding(self.embed_tokens, input_ids.long(),
                      self.config.torch_dtype)
        rope = (self.rope_cos, self.rope_sin)
        pos, writes = pass_writes(x, cache, pos, block_tables, rows)
        for i, block in enumerate(self.layers):
            x, cache = block.decode(x, rope, pos, cache, i, block_tables,
                                    rows, writes)
        return self.norm(x), cache


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of 2-d matrix products (the
    projections; the reference's ``dots_with_no_batch_dims_saveable``),
    recompute everything else."""
    P = torch_checkpoint.CheckpointPolicy
    return P.MUST_SAVE if op in _MATMULS else P.PREFER_RECOMPUTE


def _remat_kwargs(policy: str) -> dict:
    if policy == "dots":
        return {"context_fn": functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _save_matmuls)}
    return {}


def mask_boundary_labels(labels, segment_ids):
    """Drop labels at packed-document boundaries (the reference's
    ``mask_boundary_labels``, :532): the position whose next token opens
    another document is a packing artifact, not a target (-1 = ignored by
    :func:`causal_lm_loss`)."""
    boundary = segment_ids[:, :-1] != segment_ids[:, 1:]
    boundary = TF.pad(boundary, (0, 1))
    return torch.where(boundary, torch.full_like(labels, -1), labels)


def causal_lm_loss(logits, labels):
    """Mean next-token cross entropy in float32 (the reference's
    ``causal_lm_loss``, :540): the max is detached, labels < 0 are
    ignored, the mean is over the valid labels (at least 1)."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    labels = labels.to(logits.device).long()
    gold = shifted.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    valid = (labels >= 0).float()
    return ((lse - gold) * valid).sum() / valid.sum().clamp_min(1.0)


class LlamaForCausalLM(nn.Module):
    """Causal LM head over :class:`LlamaModel`.

    ``device`` defaults to the card (``paddle_tpu_torch.default_device``:
    raises without CUDA unless ``device="cpu"``).  Weights are drawn from
    N(0, initializer_range) by a ``torch.Generator`` seeded with ``seed``
    (norm weights are ones); load the reference's weights instead with
    :func:`paddle_tpu_torch.models.convert.load_jax_state_dict`."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        self.config = config
        self.model = LlamaModel(config, device)
        if not config.tie_word_embeddings:
            self.lm_head = _param((config.hidden_size, config.vocab_size),
                                  config, device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        dev = next(self.parameters()).device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        norms = {id(m.weight) for m in self.modules()
                 if isinstance(m, RMSNorm)}
        for p in self.parameters():
            if id(p) in norms:
                p.fill_(1.0)
            else:
                p.normal_(0.0, self.config.initializer_range, generator=gen)

    def logits(self, hidden):
        if self.config.tie_word_embeddings:
            w = self.model.embed_tokens
            if isinstance(w, Int8Weight):
                # per-column scales of the (vocab, hidden) table lie along
                # the product's K: the reference's dequantize-then-matmul
                w = w.dequantize(self.config.torch_dtype)
            return hidden @ w.t()
        return linear(hidden, self.lm_head)

    def forward(self, input_ids, position_ids=None, segment_ids=None):
        return self.logits(self.model(input_ids, position_ids, segment_ids))

    def compute_loss(self, input_ids, labels, position_ids=None,
                     segment_ids=None):
        """The train step's loss (the reference's ``compute_loss``, :577):
        with ``segment_ids`` the labels at document boundaries are masked
        first (:func:`mask_boundary_labels`)."""
        if segment_ids is not None:
            labels = mask_boundary_labels(labels, segment_ids)
        return causal_lm_loss(
            self.forward(input_ids, position_ids, segment_ids), labels)

    def decode_step(self, input_ids, cache, pos, block_tables=None,
                    rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, cache): one cache-carrying decode step — prefill when
        ``input_ids`` is the whole prompt at ``pos=0``, incremental when it
        is the last token.  The cache is updated in place and returned.
        ``block_tables`` (int (B, max_blocks)) selects the paged pool;
        ``rows`` addresses contiguous cache rows (:meth:`LlamaModel.decode`)."""
        hidden, cache = self.model.decode(input_ids, cache, pos,
                                          block_tables, rows)
        return self.logits(hidden), cache

    def generate(self, input_ids, max_new_tokens: int = 32, **kw):
        """Greedy, sampled or beam generation with the pre-allocated KV
        cache (the reference's ``generate``, :596; see
        :func:`paddle_tpu_torch.models.generation.greedy_generate`)."""
        from .generation import greedy_generate
        return greedy_generate(self, input_ids, max_new_tokens, **kw)


def draft_model_from(model, num_layers: int = 1) -> "LlamaForCausalLM":
    """A truncated-target draft model for speculative decoding (the
    reference's ``draft_model_from``, ``paddle_tpu/models/llama.py:604``):
    a :class:`LlamaForCausalLM` at ``num_layers`` decoder blocks whose
    embedding, first ``num_layers`` blocks, final norm, RoPE tables and LM
    head ARE the target's (the same modules, so the same storage: no
    weight is copied or drawn).  The only new memory is the draft's KV
    cache, which :class:`~paddle_tpu_torch.serving.drafter.DraftModelDrafter`
    owns.  A ``quantize_for_decode`` wrapper lends its int8 modules
    (``unwrapped``).  ``num_layers`` outside ``[1, num_hidden_layers]``
    raises ``ValueError``."""
    model = getattr(model, "unwrapped", model)
    n = int(num_layers)
    if not 1 <= n <= model.config.num_hidden_layers:
        raise ValueError(
            f"num_layers must be in [1, {model.config.num_hidden_layers}]"
            f", got {n}")
    cfg = dataclasses.replace(model.config, num_hidden_layers=n)
    src = model.model
    inner = LlamaModel.__new__(LlamaModel)
    nn.Module.__init__(inner)
    inner.config = cfg
    inner.embed_tokens = src.embed_tokens
    inner.layers = nn.ModuleList(list(src.layers)[:n])
    inner.norm = src.norm
    inner.register_buffer("rope_cos", src.rope_cos)
    inner.register_buffer("rope_sin", src.rope_sin)
    draft = LlamaForCausalLM.__new__(LlamaForCausalLM)
    nn.Module.__init__(draft)
    draft.config = cfg
    draft.model = inner
    if not cfg.tie_word_embeddings:
        draft.lm_head = model.lm_head
    return draft


def config_from(obj) -> LlamaConfig:
    """A :class:`LlamaConfig` with the same fields as ``obj`` (any object
    carrying the reference config's attribute names)."""
    return LlamaConfig(**{f.name: getattr(obj, f.name)
                          for f in dataclasses.fields(LlamaConfig)})
