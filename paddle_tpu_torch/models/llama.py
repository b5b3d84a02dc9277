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
(s > 1) to K2-paged.  The projection, MLP and LM-head
products are ``torch.matmul``, as the reference leaves them to XLA.

Training features of the reference (recompute, context parallelism,
packed-document segment ids) belong to a later slice (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .. import default_device
from ..nn import functional as F
from ..nn.common import RMSNorm
from ..ops import (build_rope_cache, cached_decode_attention,
                   flash_attention, fused_rope)

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "llama3_8b_config",
           "tiny_llama_config"]

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

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{self.dtype!r}")

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
        q = (x @ self.q_proj).view(b, s, c.num_attention_heads, c.head_dim)
        k = (x @ self.k_proj).view(b, s, c.num_key_value_heads, c.head_dim)
        v = (x @ self.v_proj).view(b, s, c.num_key_value_heads, c.head_dim)
        cos, sin = rope_cache
        q, k = fused_rope(q, k, cos, sin, position_ids)
        return q, k, v

    def forward(self, x, rope_cache, position_ids=None):
        b, s, _ = x.shape
        q, k, v = self._qkv(x, rope_cache, position_ids)
        out = flash_attention(q, k, v, causal=True)
        return out.reshape(b, s, -1) @ self.o_proj

    def decode(self, x, rope_cache, pos, cache, idx: int,
               block_tables=None):
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
        at ``pos[i]..pos[i]+s-1`` and attends ``[0, pos[i] + s)``).

        ``block_tables`` (int (B, max_blocks)) switches to the PAGED
        cache (``serving/kv_cache.py``): ``cache`` is the pooled
        (L, 2, num_blocks, block_len, Hkv, D) tensor and row i's logical
        position p lives at ``(block_tables[i, p // block_len],
        p % block_len)``; see :meth:`_decode_paged`.

        x: (B, s, H*D).  Returns (out, cache) — ``cache`` is the same
        tensor, updated."""
        if block_tables is not None:
            return self._decode_paged(x, rope_cache, pos, cache, idx,
                                      block_tables)
        b, s, _ = x.shape
        per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
        steps = torch.arange(s, device=x.device)
        if per_row:
            position_ids = pos.long()[:, None] + steps[None, :]   # (B, s)
        else:
            position_ids = (int(pos) + steps)[None, :]              # (1, s)
        q, k, v = self._qkv(x, rope_cache, position_ids)
        if per_row:
            rows = torch.arange(b, device=x.device)[:, None]
            cache[idx, 0, rows, position_ids] = k.to(cache.dtype)
            cache[idx, 1, rows, position_ids] = v.to(cache.dtype)
        else:
            p = int(pos)
            cache[idx, 0, :, p:p + s] = k.to(cache.dtype)
            cache[idx, 1, :, p:p + s] = v.to(cache.dtype)
        if not per_row and int(pos) == 0 and s > 1:
            out = flash_attention(q, k, v, causal=True)
        else:
            out = cached_decode_attention(q, cache[idx, 0], cache[idx, 1],
                                          pos)
        return out.reshape(b, s, -1) @ self.o_proj, cache

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
        s = 1, K2-paged for a suffix prefill."""
        b, s, _ = x.shape
        dev = x.device
        if not (isinstance(pos, torch.Tensor) and pos.dim() == 1):
            pos = torch.full((b,), int(pos), dtype=torch.int32, device=dev)
        position_ids = (pos.to(dev).long()[:, None]
                        + torch.arange(s, device=dev)[None, :])   # (B, s)
        rope_ids = position_ids.clamp_max(rope_cache[0].shape[0] - 1)
        q, k, v = self._qkv(x, rope_cache, rope_ids)
        bl = cache.shape[3]
        tables = block_tables.to(dev).long()
        max_blocks = tables.shape[1]
        lb = position_ids // bl
        rows = torch.arange(b, device=dev)[:, None]
        phys = torch.where(lb < max_blocks,
                           tables[rows, lb.clamp_max(max_blocks - 1)],
                           torch.zeros_like(lb))   # past the table -> null
        off = position_ids % bl
        cache[idx, 0, phys, off] = k.to(cache.dtype)
        cache[idx, 1, phys, off] = v.to(cache.dtype)
        out = cached_decode_attention(q, cache[idx, 0], cache[idx, 1], pos,
                                      block_tables=block_tables)
        return out.reshape(b, s, -1) @ self.o_proj, cache


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
        return F.swiglu(x @ self.gate_proj, x @ self.up_proj) @ self.down_proj


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

    def forward(self, x, rope_cache, position_ids=None):
        x = x + self.self_attn(self.input_layernorm(x), rope_cache,
                               position_ids)
        return x + self.mlp(self.post_attention_layernorm(x))

    def decode(self, x, rope_cache, pos, cache, idx: int,
               block_tables=None):
        a, cache = self.self_attn.decode(self.input_layernorm(x), rope_cache,
                                         pos, cache, idx, block_tables)
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

    def forward(self, input_ids, position_ids=None):
        x = self.embed_tokens[input_ids.long()]
        rope = (self.rope_cos, self.rope_sin)
        for block in self.layers:
            x = block(x, rope, position_ids)
        return self.norm(x)

    def decode(self, input_ids, cache, pos, block_tables=None):
        """Cache-carrying decode pass over the stacked cache of
        :func:`paddle_tpu_torch.models.generation.init_kv_cache` (or the
        paged pool of ``serving.kv_cache.init_paged_kv_cache`` with
        ``block_tables``); ``pos`` is the number of tokens already in the
        cache (int or per-row (B,) tensor).  Returns (hidden, cache), the
        cache updated in place."""
        x = self.embed_tokens[input_ids.long()]
        rope = (self.rope_cos, self.rope_sin)
        for i, block in enumerate(self.layers):
            x, cache = block.decode(x, rope, pos, cache, i, block_tables)
        return self.norm(x), cache


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
            return hidden @ self.model.embed_tokens.t()
        return hidden @ self.lm_head

    def forward(self, input_ids, position_ids=None):
        return self.logits(self.model(input_ids, position_ids))

    def decode_step(self, input_ids, cache, pos, block_tables=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, cache): one cache-carrying decode step — prefill when
        ``input_ids`` is the whole prompt at ``pos=0``, incremental when it
        is the last token.  The cache is updated in place and returned.
        ``block_tables`` (int (B, max_blocks)) selects the paged pool."""
        hidden, cache = self.model.decode(input_ids, cache, pos,
                                          block_tables)
        return self.logits(hidden), cache


def config_from(obj) -> LlamaConfig:
    """A :class:`LlamaConfig` with the same fields as ``obj`` (any object
    carrying the reference config's attribute names)."""
    return LlamaConfig(**{f.name: getattr(obj, f.name)
                          for f in dataclasses.fields(LlamaConfig)})
