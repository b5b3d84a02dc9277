"""Decoding helpers (mirrors ``paddle_tpu/models/generation.py``):
the pre-allocated KV cache, next-token selection and the speculative
verify window's acceptance (:func:`accept_draft_tokens`).

The cache is ONE stacked tensor ``(layers, 2, batch, max_len, kv_heads,
head_dim)`` (k at index 0, v at index 1), allocated once and written in
place by ``LlamaAttention.decode``.  ``greedy_generate`` and the static-knob
regime of ``sample_tokens`` wait for a later slice (ROADMAP A3b).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import default_device


def scale_granules(max_length: int) -> int:
    """Scale granules of an int8 cache row: one per 128 positions when 128
    divides ``max_length``, else one for the whole row (the reference's
    rule, ``paddle_tpu/models/generation.py:55``)."""
    return max_length // 128 if max_length % 128 == 0 else 1


def init_kv_cache(config, batch_size: int, max_length: int, dtype=None,
                  quantized: bool = False, device=None):
    """Pre-allocated zero cache (L, 2, B, max_len, kv_heads, head_dim) in
    the model dtype (or ``dtype``).

    ``quantized=True`` returns the int8 cache instead: ``{"kv": int8
    payload (same shape), "scale": float32 (L, 2, B, n_gran, kv_heads)}``,
    one symmetric absmax/127 scale per granule of ``max_len // n_gran``
    positions per kv head (:func:`scale_granules`); a zero scale is an
    empty granule.  ``LlamaAttention.decode`` sees the dict and quantizes
    as it writes."""
    dev = default_device(device)
    shape = (config.num_hidden_layers, 2, batch_size, max_length,
             config.num_key_value_heads, config.head_dim)
    if quantized:
        return {"kv": torch.zeros(shape, dtype=torch.int8, device=dev),
                "scale": torch.zeros(
                    (shape[0], 2, batch_size, scale_granules(max_length),
                     config.num_key_value_heads),
                    dtype=torch.float32, device=dev)}
    dt = dtype if dtype is not None else config.torch_dtype
    return torch.zeros(shape, dtype=dt, device=dev)


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


def _row_knob(value, b: int, dtype, device) -> torch.Tensor:
    """A per-row sampling knob as a (B,) tensor: a scalar broadcast, or a
    (B,) array / tensor moved to ``device``."""
    t = torch.as_tensor(value)
    return t.to(device=device, dtype=dtype).expand(b)


def _target_probs(logits: torch.Tensor, temperature, top_k=None,
                  top_p=None) -> torch.Tensor:
    """The distribution :func:`sample_tokens` samples from, as explicit
    probabilities — the p(x) of the rejection-sampling acceptance (the
    reference's ``_target_probs``, ``paddle_tpu/models/generation.py:112``):
    float32, the temperature clamped at 1e-6, per-row top-k, the nucleus
    mask, then the softmax.

    ``logits``: (B, S, V); knobs: scalars or (B,) per row.  Returns
    float32 (B, S, V), rows summing to 1."""
    logits = logits.float()
    b, vocab = logits.shape[0], logits.shape[-1]
    dev = logits.device
    t = _row_knob(temperature, b, torch.float32, dev)
    scaled = logits / t.clamp_min(1e-6)[:, None, None]
    if top_k is not None:
        tk = _row_knob(top_k, b, torch.int64, dev)
        srt = torch.sort(scaled, dim=-1, descending=True).values
        k_eff = torch.where(tk > 0, tk.clamp(1, vocab),
                            torch.full_like(tk, vocab))
        kth = srt.gather(-1, (k_eff - 1)[:, None, None].expand(
            b, scaled.shape[1], 1))
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    if top_p is not None:
        tp = _row_knob(top_p, b, torch.float32, dev)
        scaled = _nucleus_mask(scaled, tp[:, None, None])
    return torch.softmax(scaled, dim=-1)


def _any_sampled(temperature) -> bool:
    if isinstance(temperature, torch.Tensor):
        return bool((temperature > 0).any())
    return bool((np.asarray(temperature) > 0).any())


def accept_draft_tokens(logits: torch.Tensor, drafts: torch.Tensor,
                        draft_mask: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        temperature=0.0, top_k=None, top_p=None,
                        pad_token_id: int = 0, draft_probs=None,
                        greedy: Optional[torch.Tensor] = None):
    """Keep each row's longest verified draft prefix plus one token — the
    acceptance of the speculative verify window (the reference's
    ``accept_draft_tokens``, ``paddle_tpu/models/generation.py:140``).

    ``logits[:, j]`` (B, S, V) is the next-token distribution after the
    window's first j + 1 tokens ``[t, d_1 .. d_{S-1}]``; ``drafts`` int
    (B, S-1) and ``draft_mask`` bool (B, S-1), True where a column holds a
    real proposal.  Knobs as in :func:`sample_tokens` (scalars, or (B,)
    numpy arrays or tensors).  Every draw comes from ``generator``; JAX's
    ``fold_in`` streams are not reproduced, so sampled rows agree with the
    reference in distribution only.

      * greedy rows (``temperature <= 0``): draft ``d_{j+1}`` is verified
        when it equals the argmax at column j (``greedy``, (B, S), when
        the caller has it), so the committed stream is token-identical to
        one-token greedy decode;
      * sampled rows, ``draft_probs=None``: column 0's sample only;
      * sampled rows with ``draft_probs`` (float32 (B, S-1, V), the
        drafter's proposal q; one-hot for a deterministic drafter, all
        zero on a column without a draft): rejection sampling against
        the target p of :func:`_target_probs` — accept ``d_j`` when
        ``u * q(d_j) < p(d_j)``, u ~ U[0, 1); the first rejected column
        takes a sample of the residual ``max(0, p - q)`` normalised (p
        itself where the residual has no mass), and a row whose every
        draft survived takes the bonus sample at the last column.

    Returns ``(tokens, n_accepted)``: int32 (B, S), columns past each
    row's ``n_accepted`` set to ``pad_token_id``, and int32 (B,) in
    [1, S]."""
    b, s, _ = logits.shape
    dev = logits.device
    temps = _row_knob(temperature, b, torch.float32, dev)
    greedy_row = temps <= 0.0
    if greedy is None:
        greedy = logits.float().argmax(dim=-1)
    out = greedy.to(torch.int32)
    sampled = _any_sampled(temperature)
    if sampled:
        flat = logits.reshape(b * s, -1)

        def rep(knob, dtype):
            return (None if knob is None else
                    _row_knob(knob, b, dtype, dev).repeat_interleave(s))
        out = sample_tokens(flat, rep(temperature, torch.float32),
                            rep(top_k, torch.int64),
                            rep(top_p, torch.float32),
                            generator=generator).view(b, s)
    if s == 1:
        return out, torch.ones((b,), dtype=torch.int32, device=dev)
    drafts = drafts.to(dev, torch.int32)
    draft_mask = draft_mask.to(dev, torch.bool)
    match = (out[:, :-1] == drafts) & draft_mask
    pad = torch.full((), int(pad_token_id), dtype=torch.int32, device=dev)
    col = torch.arange(s, device=dev)[None, :]
    if draft_probs is None or not sampled:
        match = match & greedy_row[:, None]
        n = 1 + torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        return torch.where(col < n[:, None], out, pad), n.to(torch.int32)
    p = _target_probs(logits[:, :-1], temps, top_k, top_p)
    q = draft_probs.to(dev, torch.float32)
    d = drafts.long()[..., None]
    p_d = p.gather(-1, d)[..., 0]
    q_d = q.gather(-1, d)[..., 0]
    u = torch.rand((b, s - 1), generator=generator, device=dev)
    acc = torch.where(greedy_row[:, None], match,
                      (u * q_d < p_d) & draft_mask)
    n = 1 + torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    # the first rejected column's residual; a zero-mass residual (q == p,
    # or an all-zero pad-column q) falls back to the target itself
    res = (p - q).clamp_min(0.0)
    res = torch.where(res.sum(dim=-1, keepdim=True) > 1e-9, res, p)
    resampled = torch.multinomial(res.reshape(b * (s - 1), -1), 1,
                                  generator=generator).view(b, s - 1)
    cand = torch.cat([resampled.to(torch.int32), out[:, -1:]], dim=1)
    cand = torch.where(greedy_row[:, None], out, cand)
    drafts_pad = torch.cat([drafts, pad.expand(b, 1)], dim=1)
    last = (n - 1)[:, None]
    toks = torch.where(col < last, drafts_pad,
                       torch.where(col == last, cand, pad))
    return toks, n.to(torch.int32)
