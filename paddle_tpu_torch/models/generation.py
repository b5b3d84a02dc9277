"""Decoding helpers (mirrors ``paddle_tpu/models/generation.py``):
the pre-allocated KV cache and next-token selection.

The cache is ONE stacked tensor ``(layers, 2, batch, max_len, kv_heads,
head_dim)`` (k at index 0, v at index 1), allocated once and written in
place by ``LlamaAttention.decode``.  ``greedy_generate`` and the static-knob
regime of ``sample_tokens`` wait for a later slice (ROADMAP A3b).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import default_device


def init_kv_cache(config, batch_size: int, max_length: int, dtype=None,
                  quantized: bool = False, device=None) -> torch.Tensor:
    """Pre-allocated zero cache (L, 2, B, max_len, kv_heads, head_dim) in
    the model dtype (or ``dtype``).  The int8 cache is ROADMAP A6.4."""
    if quantized:
        raise NotImplementedError("the int8 KV cache is ROADMAP A6.4")
    dt = dtype if dtype is not None else config.torch_dtype
    shape = (config.num_hidden_layers, 2, batch_size, max_length,
             config.num_key_value_heads, config.head_dim)
    return torch.zeros(shape, dtype=dt, device=default_device(device))


def _nucleus_mask(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Top-p (nucleus) truncation: keep the smallest set of tokens whose
    cumulative probability reaches ``top_p``; mask the rest to -inf (the
    first token is always kept).  ``top_p``: float or a broadcastable
    (B, 1) per-row tensor (1.0 keeps everything)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    drop = (cum - probs) >= top_p
    kth = torch.where(drop, torch.full_like(sorted_logits, float("inf")),
                      sorted_logits).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < kth, float("-inf"))


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: Optional[torch.Tensor] = None,
                  top_p: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Next-token selection with per-row knobs — the serving engine's
    regime of the reference's ``sample_tokens``.

    ``logits``: (B, vocab); ``temperature``: (B,) float, ``<= 0`` means
    greedy; ``top_k``: (B,) int, 0 keeps the whole row; ``top_p``: (B,)
    float, 1.0 keeps everything.  Sampled rows draw from ``generator``
    (``torch.multinomial``); JAX's PRNG stream is not reproduced, so
    sampled outputs agree with the reference in distribution only.
    Argmax ties resolve to the first maximal index, as in JAX.  Returns
    int32 (B,)."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1).to(torch.int32)
    vocab = logits.shape[-1]
    temperature = temperature.to(logits.device, torch.float32)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    if top_k is not None:
        top_k = top_k.to(logits.device).long()
        srt = torch.sort(scaled, dim=-1, descending=True).values
        k_eff = torch.where(top_k > 0, top_k.clamp(1, vocab),
                            torch.full_like(top_k, vocab))
        kth = srt.gather(-1, (k_eff - 1)[:, None])
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    if top_p is not None:
        scaled = _nucleus_mask(scaled, top_p.to(logits.device,
                                                torch.float32)[:, None])
    probs = torch.softmax(scaled, dim=-1)
    samp = torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
    return torch.where(temperature <= 0.0, greedy, samp)
