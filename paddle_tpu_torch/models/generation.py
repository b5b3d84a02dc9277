"""Decoding (mirrors ``paddle_tpu/models/generation.py``): the
pre-allocated KV cache, next-token selection, the speculative verify
window's acceptance (:func:`accept_draft_tokens`), and whole-sequence
generation — :func:`greedy_generate` (greedy or sampled) and
:func:`beam_search_generate`, behind ``model.generate``.

The cache is ONE stacked tensor ``(layers, 2, batch, max_len, kv_heads,
head_dim)`` (k at index 0, v at index 1), allocated once and written in
place by ``LlamaAttention.decode``.

Built once.  The reference jits one ``lax.scan`` per static generation
config and caches it on the model (``_generate_jit_cache``,
``paddle_tpu/models/generation.py:421-434``).  The port builds one
:class:`GreedyProgram` or :class:`BeamProgram` per key, cached on the
model under the same name and counted by the watchdog (sites
``generation.greedy`` and ``generation.beam``, budget 1 a key).  A run
prefills the prompt eagerly at the static ``pos=0`` (flash-attention, K2,
for a prompt of more than one token), then decodes one token a step over
static buffers: the token (B, 1), the per-row positions (B,) int32 — the
decode path that reads nothing back to the host, so flash-decode (K1)
takes it at any position — the cache and the ``extra_inputs``.  On the
card that decode step is captured once as a CUDA graph at the build and
replayed ``max_new_tokens - 1`` times; beam search captures it once for
each of its two cache buffers (below).  Token selection, the EOS / done
mask and the beams' bookkeeping run on the device after each replay, as
the serving engine samples after its replay: no host read per token.  On
the CPU, and inside ``serving.step_graph.disable_graphs()`` (read at the
build), the same step runs eagerly on the same buffers.

A captured graph reads the weights at the addresses it saw.  Each program
therefore records the data pointers of the model's parameters and buffers
(``serving.step_graph.weights_key``), and a call first drops the
programs built over other ones (``serving.step_graph.cached_program``): a
model whose tensors moved (``.to(dtype)``, ``.float()``) builds anew.

Sampling draws from a ``torch.Generator`` on the model's device seeded
with ``seed``; JAX's PRNG streams are not reproduced, so sampled tokens
match the reference in distribution only.  Beam search breaks ties of its
top-k by the lower flat index, as ``jax.lax.top_k`` does, so float32
beams are token-identical.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import default_device
from ..observability import track_retraces


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


def sample_tokens(logits: torch.Tensor, temperature=0.0,
                  top_k=None, top_p=None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Next-token selection (the reference's ``sample_tokens``,
    ``paddle_tpu/models/generation.py:66``).  Two regimes, chosen by the
    type of ``temperature``, as in the reference:

      * **static knobs** (Python numbers, the ``generate()`` call's
        config): ``temperature == 0`` is the argmax; otherwise the logits
        divided by ``temperature``, ``top_k`` (int) keeps the k largest
        (the k-th largest value and every logit equal to it), ``top_p``
        (float) the nucleus (:func:`_nucleus_mask`), then one draw;
      * **per-row knobs** (tensors, the serving engine's regime):
        ``temperature`` (B,) float, ``<= 0`` means greedy; ``top_k`` (B,)
        int, 0 keeps the whole row; ``top_p`` (B,) float, 1.0 keeps
        everything.

    ``logits``: (B, vocab).  Sampled rows draw from ``generator``
    (``torch.multinomial``); JAX's PRNG stream is not reproduced, so
    sampled outputs agree with the reference in distribution only.
    Argmax ties resolve to the first maximal index, as in JAX.  Returns
    int32 (B,)."""
    logits = logits.float()
    if isinstance(temperature, (int, float)):
        if temperature == 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        logits = logits / temperature
        if top_k is not None:
            kth = torch.topk(logits, int(top_k), dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        if top_p is not None:
            logits = _nucleus_mask(logits, float(top_p))
        return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                 generator=generator)[:, 0].to(torch.int32)
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


# -- whole-sequence generation ---------------------------------------------------

def _model_device(model) -> torch.device:
    m = getattr(model, "unwrapped", model)
    for t in (*m.parameters(), *m.buffers()):
        return t.device
    raise ValueError("the model holds no tensor to place generation on")


def _check_lengths(model, s: int, max_new_tokens: int,
                   max_length: Optional[int]) -> int:
    """The reference's refusals (:386-401); returns the cache length."""
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    total = max_length if max_length is not None else s + max_new_tokens
    if total < s + max_new_tokens:
        raise ValueError(f"max_length {total} < prompt {s} + "
                         f"max_new_tokens {max_new_tokens}")
    limit = getattr(model.config, "max_position_embeddings", None)
    if limit is not None and total > limit:
        # past the RoPE table the positions would be clamped: refuse
        raise ValueError(
            f"prompt + max_new_tokens = {total} exceeds the model's "
            f"max_position_embeddings ({limit})")
    return total


def _gather_state(state, idx: torch.Tensor, out):
    """Reorder a decode state by flat beam indices ``idx`` (B*K,) into
    ``out``, a state of the same structure (the reference's
    ``_gather_state``, :489, which returns a new one): the stacked KV
    cache (L, 2, B·K, S, H, D) along axis 2, a recurrent state's tensors
    (layers, B·K, ...) along axis 1."""
    if isinstance(state, torch.Tensor):
        torch.index_select(state, 2, idx, out=out)
        return out
    pairs = (zip(state.values(), out.values()) if isinstance(state, dict)
             else zip(state, out))
    for a, o in pairs:
        torch.index_select(a, 1, idx, out=o)
    return out


def _copy_state(dst, src) -> None:
    if dst is src:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    pairs = (zip(dst.values(), src.values()) if isinstance(dst, dict)
             else zip(dst, src))
    for d, s in pairs:
        d.copy_(s)


class _DecodeProgram:
    """One generation key's decode step over static buffers, built once;
    see the module docstring.  ``rows`` batch rows (B, or B·K for beams)
    over ``n_states`` decode states (the KV cache, or a recurrent state
    from ``model.init_decode_state``) of ``total`` positions;
    ``extra`` names a template of each ``extra_inputs`` tensor, which
    lives in a static buffer of its shape.  :meth:`step` decodes the
    token in ``tok`` at ``pos`` on state ``c`` and returns the last
    position's logits (the graph's static output on the card)."""

    SITE = "generation.greedy"

    def __init__(self, model, rows: int, total: int, extra: dict,
                 labels: dict, n_states: int = 1):
        from ..serving import step_graph
        dev = _model_device(model)
        self.model, self.device = model, dev
        if hasattr(model, "init_decode_state"):
            self.states = [model.init_decode_state(rows, total)
                           for _ in range(n_states)]
        else:
            self.states = [init_kv_cache(model.config, rows, total,
                                         device=dev)
                           for _ in range(n_states)]
        self.tok = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros(rows, dtype=torch.int32, device=dev)
        self.extra = {n: torch.zeros_like(v, device=dev)
                      for n, v in extra.items()}
        # eager on the CPU or inside disable_graphs() (read here, and the
        # build follows at once): an eager twin is a build of its own
        self.eager = dev.type != "cuda" or step_graph._disabled
        self._graphs: list = []
        self._outs: list = []
        self._counts: list = []
        self._counters: dict = {}
        self._stream = None
        self.replays = 0
        self.prefill_logits: Optional[torch.Tensor] = None
        self.weights = step_graph.weights_key(model)
        self._tracked = track_retraces(self._build, self.SITE, budget=1,
                                       labels=dict(labels, model=id(model),
                                                   eager=self.eager,
                                                   weights=self.weights))

    @property
    def traces(self) -> int:
        """Builds of this key (1 once built)."""
        return self._tracked.traces

    @property
    def graphed(self) -> bool:
        return bool(self._graphs)

    def build(self) -> None:
        self._tracked()

    def _decode(self, ids, c: int, pos) -> torch.Tensor:
        state = self.states[c]
        logits, new = self.model.decode_step(ids, state, pos, **self.extra)
        _copy_state(state, new)
        return logits

    def _prefill(self, ids: torch.Tensor) -> torch.Tensor:
        """The prompt into state 0 at the static ``pos=0``; returns (and
        keeps, as ``prefill_logits``) the last position's logits."""
        logits = self._decode(ids, 0, 0)[:, -1]
        self.prefill_logits = logits
        return logits

    def _body(self, c: int) -> torch.Tensor:
        logits = self._decode(self.tok, c, self.pos)[:, -1]
        self.pos.add_(1)
        return logits

    def _build(self) -> None:
        if self.eager:
            return
        from ..serving.step_graph import capture
        # one warm-up step on every state (token 0 at position 0, which the
        # prefill rewrites), then one graph a state
        graphs, self._counters, self._stream = capture(
            [functools.partial(self._body, c)
             for c in range(len(self.states))], self.device, 1,
            what=self.SITE)
        self._graphs = [g for g, _, _ in graphs]
        self._outs = [o for _, o, _ in graphs]
        self._counts = [n for _, _, n in graphs]

    def step(self, c: int = 0) -> torch.Tensor:
        """Decode ``tok`` at ``pos`` on state ``c`` (``pos`` += 1): one
        replay, or the step run eagerly."""
        if not self._graphs:
            return self._body(c)
        self._graphs[c].replay()
        self._counts[c].add()
        self.replays += 1
        return self._outs[c]

    def _load_extra(self, extra: dict) -> None:
        for n, v in extra.items():
            self.extra[n].copy_(v)


class GreedyProgram(_DecodeProgram):
    """A :func:`greedy_generate` key: (B, S) prompts, ``max_new_tokens``
    tokens a row, greedy or sampled with static knobs, EOS rows padded.
    :meth:`run` is one generation."""

    SITE = "generation.greedy"

    def __init__(self, model, b: int, s: int, total: int,
                 max_new_tokens: int, eos_token_id, pad_token_id: int,
                 temperature, top_k, top_p, extra: dict, labels: dict):
        super().__init__(model, b, total, extra, labels)
        self.s, self.max_new_tokens = s, max_new_tokens
        self.eos, self.pad = eos_token_id, int(pad_token_id)
        self.knobs = (temperature, top_k, top_p)

    def _pick(self, logits, generator):
        return sample_tokens(logits, *self.knobs, generator=generator)

    def run(self, input_ids: torch.Tensor, seed: int, extra: dict
            ) -> torch.Tensor:
        b, n = input_ids.shape[0], self.max_new_tokens
        gen = None
        if self.knobs[0] != 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        with torch.no_grad():
            self._load_extra(extra)
            nxt = self._pick(self._prefill(input_ids), gen)
            done = None if self.eos is None else nxt == self.eos
            out = torch.empty((b, n), dtype=torch.int32, device=self.device)
            out[:, 0] = nxt
            self.tok[:, 0] = nxt
            self.pos.fill_(self.s)
            for i in range(1, n):
                new = self._pick(self.step(), gen)
                if done is not None:
                    new = new.masked_fill(done, self.pad)
                    done = done | (new == self.eos)
                out[:, i] = new
                self.tok[:, 0] = new
            return torch.cat([input_ids, out], dim=1)


def _top_k_first(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, ties broken by
    the lower index (a stable descending sort keeps equal values in index
    order; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class BeamProgram(_DecodeProgram):
    """A :func:`beam_search_generate` key: B prompts, K beams each.  The
    decode state is held twice: each step's beam reorder gathers the
    state it read into the other buffer (the reference's
    ``_gather_state``), so the decode step is captured once for each
    buffer and the two alternate — two static states instead of a fresh
    one a step.  :meth:`run` is one search."""

    SITE = "generation.beam"

    def __init__(self, model, b: int, s: int, total: int,
                 max_new_tokens: int, num_beams: int, eos_token_id,
                 pad_token_id: int, length_penalty: float, extra: dict,
                 labels: dict):
        super().__init__(model, b * num_beams, total, extra, labels,
                         n_states=2)
        self.b, self.s, self.k = b, s, num_beams
        self.max_new_tokens = max_new_tokens
        self.eos, self.pad = eos_token_id, int(pad_token_id)
        self.length_penalty = float(length_penalty)

    def _reorder(self, c: int, top, flat, v: int):
        """Beams from the flat (B, K·V) choices: tokens, parents, and the
        state ``c`` gathered into the other buffer (returned)."""
        b, k = self.b, self.k
        tok = (flat % v).to(torch.int32)
        parent = flat // v
        gidx = (torch.arange(b, device=self.device)[:, None] * k
                + parent).reshape(-1)
        _gather_state(self.states[c], gidx, out=self.states[1 - c])
        return tok, parent, 1 - c

    def run(self, input_ids: torch.Tensor, extra: dict) -> torch.Tensor:
        b, k, n = self.b, self.k, self.max_new_tokens
        dev = self.device
        with torch.no_grad():
            self._load_extra(extra)
            tiled = input_ids.repeat_interleave(k, dim=0)
            logp0 = torch.log_softmax(self._prefill(tiled).float(), dim=-1)
            v = logp0.shape[-1]
            # beam 0 carries the prompt; the rest start at -inf, so the
            # first expansion draws K distinct tokens from beam 0
            init_bias = torch.full((k,), float("-inf"), device=dev)
            init_bias[0] = 0.0
            scores0 = logp0.view(b, k, v) + init_bias[None, :, None]
            scores, flat = _top_k_first(scores0.view(b, k * v), k)
            tok, _, c = self._reorder(0, scores, flat, v)
            done = (torch.zeros((b, k), dtype=torch.bool, device=dev)
                    if self.eos is None else tok == self.eos)
            lengths = torch.ones((b, k), dtype=torch.int32, device=dev)
            buf = torch.full((b, k, n), self.pad, dtype=torch.int32,
                             device=dev)
            buf[:, :, 0] = tok
            pad_row = torch.full((v,), float("-inf"), device=dev)
            pad_row[self.pad] = 0.0
            self.tok[:, 0] = tok.reshape(-1)
            self.pos.fill_(self.s)
            for i in range(1, n):
                logp = torch.log_softmax(self.step(c).float(),
                                         dim=-1).view(b, k, v)
                if self.eos is not None:
                    # finished beams extend with pad at probability 1:
                    # their score freezes
                    logp = torch.where(done[:, :, None], pad_row, logp)
                cand = scores[:, :, None] + logp
                scores, flat = _top_k_first(cand.view(b, k * v), k)
                tok, parent, c = self._reorder(c, scores, flat, v)
                buf = buf.gather(1, parent[:, :, None].expand(b, k, n))
                buf[:, :, i] = tok
                done = done.gather(1, parent)
                lengths = lengths.gather(1, parent)
                lengths = torch.where(done, lengths, lengths + 1)
                if self.eos is not None:
                    done = done | (tok == self.eos)
                self.tok[:, 0] = tok.reshape(-1)
            norm = scores / lengths.float().pow(self.length_penalty)
            best = norm.argmax(dim=1)
            out = buf.gather(1, best[:, None, None].expand(b, 1, n))[:, 0]
            return torch.cat([input_ids, out], dim=1)


def _prompt(model, input_ids) -> torch.Tensor:
    dev = _model_device(model)
    return torch.as_tensor(np.asarray(input_ids) if not isinstance(
        input_ids, torch.Tensor) else input_ids).to(dev, torch.int32)


def _extra_template(extra: dict, dev) -> dict:
    return {n: torch.as_tensor(v).to(dev) for n, v in extra.items()}


def _extra_sig(extra: dict) -> tuple:
    return tuple(sorted((n, tuple(v.shape), str(v.dtype))
                        for n, v in extra.items()))


def greedy_generate(model, input_ids, max_new_tokens: int,
                    eos_token_id: Optional[int] = None,
                    pad_token_id: int = 0,
                    temperature: float = 0.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    seed: int = 0,
                    max_length: Optional[int] = None,
                    extra_inputs: Optional[dict] = None,
                    num_beams: int = 1,
                    length_penalty: float = 1.0) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations for a batch of prompts
    (the reference's ``greedy_generate``,
    ``paddle_tpu/models/generation.py:349``).

    ``model`` exposes ``decode_step(input_ids, cache, pos, **extra) ->
    (logits, cache)`` and ``.config``; it runs on its own device.
    ``temperature == 0`` is greedy; ``temperature > 0`` samples from a
    generator seeded with ``seed``, optionally top-k and / or top-p
    truncated.  ``num_beams > 1`` is :func:`beam_search_generate` (the
    sampling knobs must be unset).  ``extra_inputs``: tensors passed to
    every ``decode_step`` as keyword arguments (a VLM's vision features),
    copied into the program's static buffers each call.  Rows that emit
    ``eos_token_id`` continue with ``pad_token_id``.  Returns int32
    (batch, prompt + max_new_tokens) on the model's device.  The first
    call of a key builds its :class:`GreedyProgram`
    (``model._generate_jit_cache``); later calls reuse it."""
    if num_beams > 1:
        if temperature != 0.0 or top_k is not None or top_p is not None:
            raise ValueError("beam search is deterministic: temperature/"
                             "top_k/top_p must be unset with num_beams > 1")
        return beam_search_generate(
            model, input_ids, max_new_tokens, num_beams=num_beams,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            length_penalty=length_penalty, max_length=max_length,
            extra_inputs=extra_inputs)
    ids = _prompt(model, input_ids)
    b, s = ids.shape
    total = _check_lengths(model, s, max_new_tokens, max_length)
    extra = _extra_template(extra_inputs or {}, ids.device)
    key = (b, s, total, max_new_tokens, eos_token_id, pad_token_id,
           temperature, top_k, top_p, _extra_sig(extra))
    labels = dict(b=b, s=s, total=total, new=max_new_tokens,
                  eos=eos_token_id, pad=pad_token_id,
                  temperature=temperature, top_k=top_k, top_p=top_p,
                  extra=key[-1])
    from ..serving.step_graph import cached_program
    prog = cached_program(model, "_generate_jit_cache", key,
                          lambda: GreedyProgram(
        model, b, s, total, max_new_tokens, eos_token_id, pad_token_id,
        temperature, top_k, top_p, extra, labels))
    return prog.run(ids, seed, extra)


def beam_search_generate(model, input_ids, max_new_tokens: int,
                         num_beams: int = 4,
                         eos_token_id: Optional[int] = None,
                         pad_token_id: int = 0,
                         length_penalty: float = 1.0,
                         max_length: Optional[int] = None,
                         extra_inputs: Optional[dict] = None
                         ) -> torch.Tensor:
    """Beam search (the reference's ``beam_search_generate``,
    ``paddle_tpu/models/generation.py:501``): every beam advances every
    step, finished beams extend with ``pad_token_id`` at probability 1
    (their score freezes), scores are summed float32 log-probs, and the
    returned beam maximises ``score / length ** length_penalty`` with
    ``length`` the tokens generated before EOS (GNMT).  The decode step
    sees B·K rows, so ``extra_inputs`` are repeated K times along the
    batch.  Returns int32 (batch, prompt + max_new_tokens).  Built once
    per key (:class:`BeamProgram`)."""
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if num_beams < 2:
        raise ValueError(f"num_beams must be >= 2, got {num_beams}")
    ids = _prompt(model, input_ids)
    b, s = ids.shape
    k = num_beams
    total = _check_lengths(model, s, max_new_tokens, max_length)
    extra = {n: v.repeat_interleave(k, dim=0) for n, v in
             _extra_template(extra_inputs or {}, ids.device).items()}
    key = ("beam", b, s, total, max_new_tokens, k, eos_token_id,
           pad_token_id, length_penalty, _extra_sig(extra))
    labels = dict(b=b, s=s, total=total, new=max_new_tokens, beams=k,
                  eos=eos_token_id, pad=pad_token_id,
                  length_penalty=length_penalty, extra=key[-1])
    from ..serving.step_graph import cached_program
    prog = cached_program(model, "_generate_jit_cache", key,
                          lambda: BeamProgram(
        model, b, s, total, max_new_tokens, k, eos_token_id, pad_token_id,
        length_penalty, extra, labels))
    return prog.run(ids, extra)
