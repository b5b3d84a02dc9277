"""Continuous-batching serving engine — core slice
(mirrors ``paddle_tpu/serving/engine.py``).

``submit()`` enqueues, ``step()`` runs one scheduler tick (admit queued
requests in batched prefill waves, then ONE decode step over every slot,
then retire), ``drain()`` runs ticks until every request is done.  Two
cache layouts are served, with wave or chunked prefill, plain or
speculative decode, greedy unless a request asks to sample:

  * contiguous (the default): one ``max_length`` cache row per slot;
  * paged (``paged=True`` or ``FLAGS_serving_paged_kv``): a pool of
    ``block_len``-token blocks addressed through per-slot block tables,
    with the prefix cache (``serving/kv_cache.py``) so a shared prompt
    prefix is stored once and prefilled once.

Each in the model dtype or, with ``kv_cache_dtype="int8"``
(``FLAGS_serving_kv_cache_dtype``), as int8 with float32 scales per
(granule or block, kv head), quantized as K/V are written and read by the
int8 kernels.  ``int8_weights=True`` (``FLAGS_serving_int8_weights``)
serves the model's ``quantize_for_decode`` wrapper: int8 weights, decode
projections on kernel K4.

**Chunked prefill** (``chunked=True`` or
``FLAGS_serving_chunked_prefill``; the reference's token-budget scheduler,
``paddle_tpu/serving/engine.py:70-96``): admission turns the FIFO head
into a cursor (:class:`_Prefill`) instead of a prefill wave, and each tick
runs the decode rows plus at most one ``prefill_chunk``-token slice of
that prompt (``FLAGS_serving_prefill_chunk``), so a long prompt costs the
decoding requests a bounded bump a tick instead of a whole-prompt stall.
``chunk_policy`` (``FLAGS_serving_chunk_policy``): ``"prefill"`` runs a
pending chunk every tick, ``"decode"`` only on alternate ticks while any
slot decodes.  Paged admission adopts the cached prefix (the cursor
starts past it), grows the chain per chunk and registers a full prompt
block in the prefix trie only after the chunk that writes it is
dispatched.  A contiguous int8 row taken by a new prompt has its granule
scales zeroed first.  The engine has no prefill program: every prompt
token goes through the mixed step (``step_graph.MixedStep``, built once),
and ticks that carry no chunk replay the decode step.  In the contiguous
chunked engine every row that is not decoding (idle, or being filled by
chunks) sits at position ``max_length``, whose writes the model drops.

**Speculative decode** (``spec_decode=True`` or
``FLAGS_serving_spec_decode``; the reference's spec engine,
``paddle_tpu/serving/engine.py:102-136``), in either layout, bf16 or int8,
wave or chunked: each tick a drafter (``serving/drafter.py``: the n-gram
prompt-lookup drafter, a draft model, or any :class:`Drafter` given to
``submit(drafter=...)``) proposes up to ``spec_k`` tokens a slot, capped
so an accepted window never passes the request's budget or
``max_length - 1``; one verify step (``step_graph.VerifyStep``, built once
as the decode step is) scores every row's window ``[current, d_1 ..
d_k]`` at its own depth — K1 at s = k + 1 on the contiguous cache,
K2-paged on the pool — and ``models.generation.accept_draft_tokens``
keeps each row's longest verified prefix plus one token: 1 .. k + 1
tokens a step, token-identical to plain greedy decode for greedy rows,
rejection sampling against the drafter's q for sampled ones.  The
acceptance runs on the step's outputs with the engine's generator; an
all-greedy tick needs only the graph's argmax.  Rollback is bookkeeping:
a row's position stays at its accept point (the stale cells above it are
rewritten before they are read), and the paged engine returns the blocks
that held only rejected drafts (``BlockManager.truncate_to``).  Rows
without drafts ride the same step with pad columns, whose writes land
where the rejected ones do (paged: past the chain, in the null block).
In the chunked engine the mixed step's decode half is the verify window,
and a row whose prompt is still streaming drafts nothing.

**The paged cache's memory tiers** (the reference's preemption, host tier
and migration, ``paddle_tpu/serving/engine.py:405-470``), paged only:

  * ``kv_cache_dtype="mixed"``: the pool stays in the model dtype and each
    block carries a dtype tag (``serving/kv_cache.py``).  A full prompt
    block that registers in the prefix trie is cold: it demotes to int8,
    one in-place quantize -> dequantize rewrite of the block over every
    layer (:class:`_DemoteOp`, the reference's ``_demote_impl``, site
    ``serving.demote``), queued at registration and applied after the
    dispatch that wrote the block.  The kernels see a model-dtype pool;
  * ``preempt="swap"`` / ``"recompute"`` (``FLAGS_serving_preempt``): a
    paged admission that finds the pool full may preempt a running
    request of lower priority (``submit(priority=...)``; the same
    priority only after ``FLAGS_serving_preempt_after`` blocked ticks, and
    never twice).  ``swap`` moves the victim's private blocks to the host
    tier and later restores them bit for bit; ``recompute`` frees the
    chain and re-prefills the prompt plus the committed tokens through the
    prefix trie, forcing the last committed token back;
  * ``host_blocks`` (``FLAGS_serving_host_blocks``; needed by ``swap``): a
    host tier of that many blocks, in pinned memory on the card.  Besides
    swap records it holds evicted prefix blocks, promoted back by a later
    admission's prefix hit;
  * ``cancel(rid)`` tears a request down wherever it is (queued, awaiting
    a recompute resume, swapped out, mid chunked prefill, decoding);
    ``export_request`` / ``import_request`` move a decoding request,
    its KV chain by value, to another engine.

Blocks move between the pool and the host through one pair of one-block
movers (:meth:`ServingEngine._read_block`, :meth:`ServingEngine._write_block`):
a read into pinned host memory that is complete when it returns (before the
manager can hand the block to a new owner), and a write in place into the
pool's storage, on the stream the next replay runs on.  No step is built
again and no pool tensor is replaced: the captured graphs hold the pool's
address.

**Observability** (the reference's, ``paddle_tpu/serving/engine.py:1000-
1100``, ``:3052-3220``): every series lives in the metrics registry under
``engine=<id>`` (``observability.snapshot()``), and :meth:`metrics` reads
them back.  Each request carries a uid minted by the request log at
``submit`` (``observability.get_request_log()``), with the reference's
lifecycle events at the reference's points (``submitted``, ``admitted``,
``prefill`` / ``prefill_chunk``, ``first_token``, ``spec_accept``,
``retired``, the preemption, migration and admission events) and its SLO
accounting (``submit(ttft_slo_ms=, tpot_slo_ms=)``,
``serving.slo_violations`` by cause).  Ticks, waves and draft phases are
host spans (``serving.step``, ``serving.decode``, ``serving.prefill``,
...).  With ``FLAGS_perf_model`` on (the default) a roofline cost model
prices every tick (``perf_report()``; the ``h100`` profile on the card)
and ``FLAGS_serving_admission="predictive"`` arms its admission gate.
Every timestamp is taken after the tick's one host fetch, and no
observability code reads a CUDA tensor: the layer adds no device
synchronisation, and none of it runs inside a captured graph.

A mesh (``mesh=``) raises ``NotImplementedError`` naming its ROADMAP item.

The decode tick is built once, as the reference jits its step once
(``step_traces``, budget 1 under ``FLAGS_retrace_watchdog``): on the card a
warm-up and one CUDA-graph capture at construction, while no slot holds a
request, then one graph replay a tick (``serving/step_graph.py``; inside
``disable_graphs()`` the same step runs eagerly, as on the CPU).  Where
the reference donates the cache, the port writes the one cache tensor in
place, so the graph's cache is the engine's own.  Sampling of rows with
``temperature > 0`` stays outside the graph, on its logits, with the
engine's ``torch.Generator``; the paged bookkeeping (block growth,
copy-on-write, fresh int8 scales) runs eagerly before each replay.

Each prefill wave is built once too, as the reference jits its prefill
once a padded bucket (``prefill_traces``): one ``step_graph.PrefillStep``
a (bucket, rows) key, built on the key's first use (counted under
``serving.prefill``, budget 1 a key) and replayed by every later wave of
that key; on the card the graphs share one memory pool per engine.  A
wave runs only its real rows, and differs from the reference in one
more detail: the reference scatters whole fresh cache rows into the
slots (dummy rows dropped); the port writes only the real rows' first
``bucket`` positions.  A slot's stale tail past its prompt is never read:
flash-decode (K1) walks only ``[0, pos + s)``, and each decode tick writes
position ``pos`` before it attends over it.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import contextlib
import itertools
import json
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import default_device, flags
from .. import observability as _obs
from ..models.generation import (accept_draft_tokens, init_kv_cache,
                                 sample_tokens)
from ..models.llama import _INV_127
from ..observability import track_retraces
from .drafter import DraftModelDrafter, NgramDrafter
from .kv_cache import BlockManager, init_paged_kv_cache
from .step_graph import DecodeStep, MixedStep, PrefillStep, VerifyStep


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.  ``temperature <= 0`` means greedy;
    ``top_k == 0`` means no top-k; ``top_p == 1.0`` means no top-p."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


@dataclasses.dataclass(eq=False)
class Request:
    """A queued generation request (created by ``submit``).  Identity
    equality: the scheduler's queues remove entries by identity."""

    request_id: int
    prompt: np.ndarray                 # (plen,) int32
    max_new_tokens: int
    sampling: SamplingParams
    t_submit: float = 0.0              # perf_counter at submit (SLO clock)
    # speculative engine: the request's drafter ('ngram', 'model', a
    # Drafter, or None for the engine's default)
    drafter: Optional[object] = None
    uid: int = -1                      # RequestLog correlation uid
    t_admit: float = 0.0               # perf_counter at admission
    ttft_slo_ms: float = 0.0           # deadlines recorded at submit;
    tpot_slo_ms: float = 0.0           # 0 = that deadline disabled
    priority: int = 0                  # preemption class (higher wins)
    preempt_count: int = 0             # times this request was preempted
    blocked_ticks: int = 0             # pool-full admission refusals
    defer_ticks: int = 0               # predictive-admission deferrals
    # set only on the request a recompute preemption enqueues
    resume: Optional["_ResumeInfo"] = None


@dataclasses.dataclass
class _Slot:
    rid: int
    remaining: int                     # new tokens still allowed
    t_first: float = 0.0               # perf_counter at first token (TPOT)
    # speculative engine: the request's prompt (the n-gram drafter's
    # corpus) and its drafter
    prompt: Optional[np.ndarray] = None
    drafter: Optional[object] = None
    req: Optional[Request] = None      # the request (preemption reads it)


@dataclasses.dataclass
class _Prefill:
    """A partially-prefilled request (chunked mode): admitted to a slot,
    its prompt streaming into the cache one chunk per mixed step."""

    req: Request
    slot: int
    cursor: int                        # prompt tokens already in the cache


@dataclasses.dataclass
class _ResumeInfo:
    """A recompute resume (the reference's ``_ResumeInfo``): the re-prefill
    covers the prompt and every committed token but the last; at the
    slot's re-creation the re-sampled token is discarded and
    ``last_token`` forced back, so the decode continues where the victim
    stopped."""

    orig: Request                      # the preempted request
    last_token: int                    # last committed token (forced back)
    remaining: int                     # decode budget left at preemption
    t_first: float                     # the original TPOT clock


@dataclasses.dataclass
class _SwapResume:
    """A swapped-out request parked on the host tier (the reference's
    ``_SwapResume``): the manager's swap record and the slot state that
    restores the slot exactly once the pool has room."""

    req: Request
    record: Dict[str, object]          # BlockManager.swap_out's record
    last_token: int
    position: int
    remaining: int
    t_first: float
    blocked_ticks: int = 0             # failed resume attempts


class _Rejected(Exception):
    """Admission refused at submit: the user-facing message with a stable
    reason for the request log (``rejected`` event,
    ``slo_violations{kind="rejected"}``)."""

    def __init__(self, reason: str, msg: str):
        super().__init__(msg)
        self.reason = reason


def hist_summary(h) -> Dict[str, float]:
    """A registry histogram's readout in :meth:`ServingEngine.metrics`:
    count and the p50 / p90 / p99 the buckets interpolate (the
    reference's)."""
    d = {"count": h.count}
    for q, k in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
        p = h.percentile(q)
        if p is not None:
            d[k] = round(p, 3)
    return d


# constructor arguments of the reference engine that the port does not
# take yet: name -> (values that mean the default, ROADMAP item)
_UNSUPPORTED = {
    "mesh": ((None,), "A8 (multi-GPU serving)"),
}
# engine instances label their series and build counters with their own
# id, so their budgets are independent (the reference's ``_ENGINE_IDS``)
_ENGINE_IDS = itertools.count()


class _DemoteOp:
    """The mixed pool's demotion, the reference's ``_demote_impl``
    (``paddle_tpu/serving/engine.py:587-598``): block ``bid`` of the
    model-dtype ``pool`` (L, 2, num_blocks, block_len, Hkv, D), over every
    layer and K / V, rewritten in place through int8 — per (layer, K / V,
    kv head) the scale ``absmax * (1 / 127)`` in float32 (the product XLA
    makes of the reference's ``/ 127.0``), the block divided by it,
    rounded half to even, clipped to +-127 and multiplied back, in the
    pool's dtype.  Plain PyTorch on the pool's device (no TPU kernel
    stands behind it).  ``bid`` reaches the body through a device index
    buffer, so the op built once (site ``serving.demote``, budget 1)
    serves every block."""

    def __init__(self, pool: torch.Tensor, engine_id):
        self._pool = pool
        self._bid = torch.zeros(1, dtype=torch.long, device=pool.device)
        self._inv127 = _INV_127.to(pool.device)
        self._tracked = track_retraces(lambda: None, "serving.demote",
                                       budget=1,
                                       labels={"engine": engine_id})
        self._tracked()

    @property
    def traces(self) -> int:
        return self._tracked.traces

    def __call__(self, bid: int) -> None:
        self._bid.fill_(int(bid))
        pool = self._pool
        blk = pool.index_select(2, self._bid).float()  # (L, 2, 1, bl, H, D)
        sc = blk.abs().amax(dim=(3, 5), keepdim=True) * self._inv127
        safe = torch.where(sc > 0, sc, torch.ones_like(sc))
        q = torch.clamp(torch.round(blk / safe), -127, 127)
        pool.index_copy_(2, self._bid, (q * safe).to(pool.dtype))


class ServingEngine:
    """Continuous-batching serving over a causal LM with the stacked KV
    cache (``decode_step`` + ``init_kv_cache`` layout).

    ``device`` defaults to the card and must be where the model lives.
    Sampling draws from a ``torch.Generator`` seeded with ``seed``.

    ``paged`` (default ``FLAGS_serving_paged_kv``) selects the paged
    cache: ``block_len`` tokens a block (``FLAGS_kv_cache_block_len``;
    must divide ``max_length``), ``num_blocks`` in the pool
    (``FLAGS_kv_cache_num_blocks``, 0 = ``num_slots * max_blocks + 1``),
    ``prefix_cache`` (``FLAGS_serving_prefix_cache``).

    ``chunked`` (default ``FLAGS_serving_chunked_prefill``) selects
    chunked prefill: ``prefill_chunk`` prompt tokens a mixed step
    (``FLAGS_serving_prefill_chunk``), ``chunk_policy`` ``"prefill"`` or
    ``"decode"`` (``FLAGS_serving_chunk_policy``); see the module
    docstring.

    ``spec_decode`` (default ``FLAGS_serving_spec_decode``) selects
    speculative decode: up to ``spec_k`` drafts a slot a tick
    (``FLAGS_serving_spec_k``) from ``drafter`` (default
    ``FLAGS_serving_spec_drafter``): ``"ngram"`` (longest n-gram
    ``FLAGS_serving_spec_ngram``), ``"model"`` (``draft_model``, e.g.
    ``models.draft_model_from(model, num_layers)``; None drafts with the
    target itself) or a :class:`~paddle_tpu_torch.serving.drafter.Drafter`
    instance; ``submit(drafter=...)`` overrides it a request.

    ``kv_cache_dtype`` (default ``FLAGS_serving_kv_cache_dtype``):
    ``"bf16"`` keeps the cache in the model dtype, ``"int8"`` quantizes it
    (either layout), ``"mixed"`` (paged only) keeps a model-dtype pool
    whose cold full prefix blocks demote to int8 precision.
    ``int8_weights`` (default ``FLAGS_serving_int8_weights``) wraps the
    model with ``models.quantized.quantize_for_decode`` unless it is
    wrapped already (has ``unwrapped``).

    ``preempt`` (default ``FLAGS_serving_preempt``; paged only):
    ``"off"``, ``"swap"`` or ``"recompute"``, what a blocked admission may
    do to a running request of lower priority; ``host_blocks`` (default
    ``FLAGS_serving_host_blocks``; at least 1 for ``"swap"``) the host
    tier's capacity in blocks.  See the module docstring."""

    def __init__(self, model, num_slots: int = 8, max_length: int = 1024,
                 eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                 prefill_batch: int = 4, seed: int = 0, *,
                 paged: Optional[bool] = None,
                 block_len: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 kv_cache_dtype: Optional[str] = None,
                 int8_weights: Optional[bool] = None,
                 chunked: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 chunk_policy: Optional[str] = None,
                 spec_decode: Optional[bool] = None,
                 spec_k: Optional[int] = None, drafter=None,
                 draft_model=None, preempt: Optional[str] = None,
                 host_blocks: Optional[int] = None, device=None,
                 **unsupported):
        for name, value in unsupported.items():
            if name not in _UNSUPPORTED:
                raise TypeError(f"ServingEngine got an unexpected keyword "
                                f"argument {name!r}")
            defaults, item = _UNSUPPORTED[name]
            if value not in defaults:
                raise NotImplementedError(
                    f"ServingEngine({name}={value!r}) is ROADMAP {item}")
        self.int8_weights = bool(flags.flag("serving_int8_weights")
                                 if int8_weights is None else int8_weights)
        if self.int8_weights and not hasattr(model, "unwrapped"):
            from ..models.quantized import quantize_for_decode
            model = quantize_for_decode(model)
        self.device = default_device(device)
        mdev = next(model.parameters()).device
        if mdev.type != self.device.type or (
                mdev.index is not None and self.device.index is not None
                and mdev.index != self.device.index):
            raise ValueError(f"the model lives on {mdev}, the engine runs "
                             f"on {self.device}")
        limit = getattr(model.config, "max_position_embeddings", None)
        if limit is not None and max_length > limit:
            raise ValueError(
                f"max_length {max_length} exceeds the model's "
                f"max_position_embeddings ({limit})")
        self.model = model
        self.config = model.config
        self._init_host_state(
            num_slots, max_length, eos_token_id, pad_token_id,
            prefill_batch, paged=paged, block_len=block_len,
            num_blocks=num_blocks, prefix_cache=prefix_cache,
            kv_cache_dtype=kv_cache_dtype, preempt=preempt,
            host_blocks=host_blocks, chunked=chunked,
            prefill_chunk=prefill_chunk, chunk_policy=chunk_policy,
            spec_decode=spec_decode, spec_k=spec_k)
        if self.paged:
            c = self.config
            tok = c.num_hidden_layers * 2 * c.num_key_value_heads * c.head_dim
            native = torch.empty((), dtype=c.torch_dtype).element_size()
            bl = self.block_len
            # a block's bytes: payload (+ the int8 block's scale row)
            self.kv.set_block_nbytes({
                "bf16": tok * bl * native,
                "int8": tok * bl
                + c.num_hidden_layers * 2 * c.num_key_value_heads * 4})
            with torch.no_grad():
                self._cache = init_paged_kv_cache(
                    self.config, self.kv.num_blocks, bl,
                    quantized=self.quantized, device=self.device)
        else:
            with torch.no_grad():
                self._cache = init_kv_cache(self.config, self.num_slots,
                                            self.max_length,
                                            quantized=self.quantized,
                                            device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

        # the steps, built once; the host mirrors of their inputs are
        # views of their staging buffers (uploaded per tick).  The
        # chunked engine's mixed step is its serving.step site; its
        # decode step (chunk-free ticks) is labelled graph="decode"
        s = self.num_slots
        eid = self._eid
        mb = self.max_blocks if self.paged else None
        label = "decode" if self.chunked else None
        if self.spec:
            # the verify step takes the decode step's place: its window's
            # column 0 is the rows' current token, columns 1.. the drafts
            self._step = VerifyStep(self.model, self._cache, s,
                                    self.spec_k + 1, mb, self.device, eid,
                                    graph=label)
            self._window = self._step.tokens_host
            self._ok = self._step.ok_host
            self._tokens = self._window[:, 0]
        else:
            self._step = DecodeStep(self.model, self._cache, s, mb,
                                    self.device, eid, graph=label)
            self._tokens = self._step.tokens_host
        self._positions = self._step.positions_host
        if self.paged:
            self._tables = self._step.tables_host
        # the position of a row that is not decoding: the contiguous
        # chunked engine drops its writes there (a chunk may be filling
        # the row); elsewhere position 0 (paged: of the null block)
        self._idle_pos = (self.max_length if self.chunked and not self.paged
                          else 0)
        self._positions[:] = self._idle_pos
        if self.chunked:
            # a chunk never holds more than max_length tokens (a prompt is
            # shorter), so the buffer is capped there
            self._mixed = MixedStep(self._step,
                                    min(self.prefill_chunk, self.max_length),
                                    mb, eid)
            # the build's dummy chunk: every write drops (contiguous:
            # at max_length; paged: the all-null table row)
            self._mixed.pos_host[0] = self._idle_pos
            self._mixed.len_host[0] = 1
        self._step.build()
        if self._mixed is not None:
            self._mixed.build()
        if self.paged:
            # the builds' warm-up ran the steps on idle rows, whose writes
            # land in the null block; a padded wave's rows read that block
            # back, and an int8 pool's padding writes then reach a live
            # block's running-max scale: give back the fresh pool's null
            # block, so a graphed engine serves as its eager twin does
            for t in self._leaves():
                t[:, :, 0] = 0
        if self.kv_dtype == "mixed":
            self._demote_fn = _DemoteOp(self._cache, eid)
            self.kv.on_demote = self._pending_demote.extend
        # drafters, by kind; the default one is built now, the others on a
        # request's first use (a draft model's steps on its first tick)
        self._draft_model = draft_model
        if self.spec:
            self._drafter = self._make_drafter(
                drafter if drafter is not None
                else str(flags.flag("serving_spec_drafter")))
            self._drafters[getattr(self._drafter, "kind", "custom")] = \
                self._drafter
        # the per-tick roofline (reference :713-716): predictions are
        # memoized host math, so a steady tick pays a dict lookup;
        # FLAGS_perf_model "off" skips the layer
        self._perf = (self._build_perf_model()
                      if flags.flag("perf_model") == "on" else None)

    def _init_host_state(self, num_slots: int, max_length: int,
                         eos_token_id: Optional[int], pad_token_id: int,
                         prefill_batch: int, *, paged: Optional[bool],
                         block_len: Optional[int],
                         num_blocks: Optional[int],
                         prefix_cache: Optional[bool],
                         kv_cache_dtype: Optional[str],
                         preempt: Optional[str],
                         host_blocks: Optional[int],
                         chunked: Optional[bool],
                         prefill_chunk: Optional[int],
                         chunk_policy: Optional[str],
                         spec_decode: Optional[bool],
                         spec_k: Optional[int]) -> None:
        """The engine's host-side state, with no model and no device: the
        options (each ``None`` read from its flag), the paged pool's
        :class:`BlockManager`, the engine id, the scheduler's queues,
        slots and per-slot numpy state, the clock and the registry
        series.  The constructor adds the cache, the steps and their
        staging mirrors; ``fleet_sim.SimEngine`` calls this alone and
        adds its cost-model clock, so every scheduler attribute has one
        home."""
        self.paged = bool(flags.flag("serving_paged_kv")
                          if paged is None else paged)
        self.kv_dtype = str(kv_cache_dtype
                            or flags.flag("serving_kv_cache_dtype"))
        if self.kv_dtype not in ("bf16", "int8", "mixed"):
            raise ValueError(f"kv_cache_dtype must be bf16|int8|mixed, got "
                             f"{self.kv_dtype!r}")
        if self.kv_dtype == "mixed" and not self.paged:
            raise ValueError(
                "kv_cache_dtype='mixed' requires the paged cache: "
                "demotion is per-block, and contiguous rows have no "
                "block registration point")
        # 'int8' quantizes the pool; 'mixed' keeps it in the model dtype
        self.quantized = self.kv_dtype == "int8"
        # preemption and the host tier (reference engine.py:448-470)
        self.preempt = str(flags.flag("serving_preempt")
                           if preempt is None else preempt)
        if self.preempt not in ("off", "swap", "recompute"):
            raise ValueError(f"preempt must be off|swap|recompute, got "
                             f"{self.preempt!r}")
        if self.preempt != "off" and not self.paged:
            raise ValueError(
                "preemption requires the paged cache: victim block free "
                "and swap/recompute resume are BlockManager operations")
        self._preempt_after = int(flags.flag("serving_preempt_after"))
        hb = int(flags.flag("serving_host_blocks")
                 if host_blocks is None else host_blocks)
        if self.preempt == "swap" and hb < 1:
            raise ValueError(
                "preempt='swap' needs a host tier: pass host_blocks "
                "(or FLAGS_serving_host_blocks) >= 1")
        self._host_blocks = hb if self.paged else 0
        self.chunked = bool(flags.flag("serving_chunked_prefill")
                            if chunked is None else chunked)
        self.prefill_chunk = int(prefill_chunk
                                 or flags.flag("serving_prefill_chunk"))
        self._chunk_policy = str(chunk_policy
                                 or flags.flag("serving_chunk_policy"))
        if self._chunk_policy not in ("prefill", "decode"):
            raise ValueError(
                f"chunk_policy must be 'prefill' or 'decode', got "
                f"{self._chunk_policy!r}")
        if self.chunked and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        self.spec = bool(flags.flag("serving_spec_decode")
                         if spec_decode is None else spec_decode)
        self.spec_k = int(spec_k or flags.flag("serving_spec_k"))
        if self.spec and self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        self.num_slots = int(num_slots)
        self.max_length = int(max_length)
        self.eos_token_id = eos_token_id
        self.pad_token_id = int(pad_token_id)
        self.prefill_batch = int(prefill_batch)
        if self.paged:
            bl = int(block_len or flags.flag("kv_cache_block_len"))
            if self.max_length % bl:
                raise ValueError(
                    f"max_length {self.max_length} is not a multiple of "
                    f"block_len {bl}")
            self.block_len = bl
            self.max_blocks = self.max_length // bl
            nb = int(num_blocks or flags.flag("kv_cache_num_blocks")
                     or self.num_slots * self.max_blocks + 1)
            self.kv = BlockManager(
                nb, bl, prefix_cache=bool(flags.flag("serving_prefix_cache")
                                          if prefix_cache is None
                                          else prefix_cache),
                kv_dtype=self.kv_dtype, host_blocks=self._host_blocks)
        self._eid = str(next(_ENGINE_IDS))
        s = self.num_slots
        self._mixed: Optional[MixedStep] = None
        # the wave steps, one a (bucket, rows) key, built on first use
        self._prefill_steps: Dict[Tuple[int, int], PrefillStep] = {}
        self._prefill_pool = None
        self._active = np.zeros((s,), bool)
        self._temps = np.zeros((s,), np.float32)
        self._topk = np.zeros((s,), np.int32)
        self._topp = np.ones((s,), np.float32)

        self._slots: List[Optional[_Slot]] = [None] * s
        self._cursor: Optional[_Prefill] = None   # chunked-mode cursor
        self._queue: Deque[Request] = collections.deque()
        # preempted work awaiting resume, each kept in (-priority, request
        # id) order; every preemption decision, in order
        self._swap_resume: List[_SwapResume] = []
        self._resume_q: Deque[Request] = collections.deque()
        self._preempt_log: List[Dict[str, object]] = []
        self._results: Dict[int, List[int]] = {}
        self._next_rid = 0
        self._ticks = 0
        self._clock = time.perf_counter
        self._init_metrics()
        # the mixed pool's demotions: queued by the manager at registration
        # (on_demote is a bound extend of the list, so it is drained in
        # place), applied after the dispatch that writes the blocks
        self._pending_demote: List[int] = []
        self._demote_fn: Optional[_DemoteOp] = None
        if self._host_blocks > 0:
            self.kv.on_swap_out = self._host_swap_out
            self.kv.on_swap_in = self._host_swap_in
        self._draft_model = None
        self._drafters: Dict[str, object] = {}
        self._drafter = None

    # -- metrics -------------------------------------------------------------

    def _init_metrics(self):
        """Declare this engine's series in the registry (the reference's
        ``_init_metrics``, ``paddle_tpu/serving/engine.py:1000``): names,
        help texts and the ``engine=<id>`` label are the reference's, so
        the two engines' snapshots compare series by series.  The port
        adds ``serving.mixed_step_ms`` and ``serving.prefill_wave_ms``
        (and keeps its tick counts as attributes).  Every update on the
        tick's path is O(1) host work."""
        reg = _obs.default_registry()
        self._tracer = _obs.get_tracer()
        self._rlog = _obs.get_request_log()
        self._uids: Dict[int, int] = {}    # engine rid -> lifecycle uid
        lbl = self._lbl = {"engine": self._eid}
        hist, ctr, gauge = reg.histogram, reg.counter, reg.gauge
        self._m_queue_wait = hist(
            "serving.queue_wait_ms",
            "submit → admission wait per request").labels(**lbl)
        self._m_ttft = hist(
            "serving.ttft_ms",
            "time to first token: submit → first sampled token "
            "fetched").labels(**lbl)
        self._m_tpot = hist(
            "serving.tpot_ms",
            "per-token decode latency per finished request: "
            "(t_last - t_first) / (tokens - 1)").labels(**lbl)
        self._m_step_ms = hist(
            "serving.decode_step_ms",
            "wall time of one jitted decode step incl. the (num_slots,) "
            "token fetch").labels(**lbl)
        self._m_mixed_ms = hist(
            "serving.mixed_step_ms",
            "wall time of the chunked engine's ticks that carried a "
            "prompt chunk (a subset of serving.decode_step_ms)").labels(
                **lbl)
        self._m_prefill_ms = hist(
            "serving.prefill_wave_ms",
            "wall time of one admission wave: prefill through its "
            "first tokens' fetch").labels(**lbl)
        self._m_active = gauge(
            "serving.active_slots",
            "busy slots at the last scheduler tick").labels(**lbl)
        self._m_occ = gauge(
            "serving.slot_occupancy",
            "active_slots / num_slots at the last tick").labels(**lbl)
        self._m_submitted = ctr(
            "serving.requests_submitted", "submit() calls").labels(**lbl)
        self._m_finished = ctr(
            "serving.requests_finished",
            "requests retired (all reasons)").labels(**lbl)
        self._f_retired = ctr(
            "serving.retired",
            "retirements by reason: eos | max_new_tokens | max_length")
        self._f_slo_viol = ctr(
            "serving.slo_violations",
            "requests that missed their recorded TTFT/TPOT deadline, by "
            "attributed cause: rejected (admission refused) | queue_wait "
            "| prefill (missed TTFT, split by larger segment) | decode "
            "(missed TPOT); BASELINE.md 'SLO accounting conventions'")
        self._m_tokens = ctr(
            "serving.tokens_generated",
            "sampled tokens returned to requests (prefill first tokens "
            "included)").labels(**lbl)
        self._f_bucket = ctr(
            "serving.prefill_bucket",
            "admission waves per padded prefill bucket length (paged: "
            "suffix bucket)")
        self._m_waves = ctr(
            "serving.prefill_waves", "batched prefill waves").labels(**lbl)
        self._m_blocked = ctr(
            "serving.admission_blocked",
            "admission attempts deferred because the paged pool could "
            "not cover the request yet").labels(**lbl)
        self._m_deferred = ctr(
            "serving.admission_deferred",
            "admission attempts held back by the predictive SLO gate "
            "(serving_admission='predictive'): the cost model priced "
            "the post-admission tick over the pooled TPOT deadline")\
            .labels(**lbl)
        self._m_prefill_computed = ctr(
            "serving.prefill_tokens_computed",
            "prompt tokens actually prefilled (pads excluded; prefix "
            "hits skip these)").labels(**lbl)
        self._m_prefill_total = ctr(
            "serving.prefill_tokens_total",
            "prompt tokens submitted across admitted requests").labels(
                **lbl)
        self._m_chunks = ctr(
            "serving.prefill_chunks",
            "prompt chunks folded into mixed steps (chunked "
            "admission)").labels(**lbl)
        self._m_chunk_tokens = ctr(
            "serving.prefill_chunk_tokens",
            "real prompt tokens carried by mixed-step chunks (chunk "
            "padding excluded)").labels(**lbl)
        self._m_chunk_queue = hist(
            "serving.chunk_queue_depth",
            "pending prefill chunks at each scheduler tick: the active "
            "prompt's remaining chunks plus every queued prompt's",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512)).labels(
                **lbl)
        # speculative decode: accounting in COMMITTED tokens; every spec
        # series has an engine-total child and a child a drafter kind
        # (``drafter=`` label, built on first use by _spec_m)
        self._f_drafted = ctr(
            "serving.spec_drafted_tokens",
            "draft tokens the drafter proposed (sent to verification)")
        self._f_draft_hits = ctr(
            "serving.spec_draft_hit_tokens",
            "proposed draft tokens verified AND committed")
        self._f_draft_miss = ctr(
            "serving.spec_draft_miss_tokens",
            "proposed draft tokens rejected by verification (rolled "
            "back)")
        self._f_rollbacks = ctr(
            "serving.spec_rollbacks",
            "row-steps whose rejected draft suffix was rolled back "
            "(position pinned at the accept point; paged: draft-only "
            "blocks returned via truncate_to)")
        self._f_spec_accept = hist(
            "serving.spec_accepted_per_step",
            "tokens committed per active slot per verify step (1 = no "
            "speculative win that step; k+1 = whole window accepted)",
            buckets=(1, 2, 3, 4, 5, 6, 7, 8, 16))
        self._m_drafted = self._f_drafted.labels(**lbl)
        self._m_draft_hits = self._f_draft_hits.labels(**lbl)
        self._m_draft_miss = self._f_draft_miss.labels(**lbl)
        self._m_rollbacks = self._f_rollbacks.labels(**lbl)
        self._m_spec_accept = self._f_spec_accept.labels(**lbl)
        self._spec_children: Dict[str, tuple] = {}
        self._m_demoted = ctr(
            "serving.kv_demoted_blocks",
            "mixed-mode blocks rewritten to simulated int8 at trie "
            "registration").labels(**lbl)
        self._m_dequant_err = hist(
            "serving.kv_dequant_error",
            "max |logit(bf16) - logit(int8-KV)| observed by a parity "
            "oracle (tests / bench feed this; the engine never computes "
            "it on the hot path)",
            buckets=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                     1.0)).labels(**lbl)
        # preemption and the host tier: swap bytes are pool traffic,
        # never streamed-KV bytes
        self._f_preempt = ctr(
            "serving.preemptions",
            "running slots evicted at blocked admission, by resume "
            "mode: swap (chain parked on the host tier) | recompute "
            "(chain freed, re-prefilled through the prefix trie)")
        self._f_resumed = ctr(
            "serving.resumes",
            "preempted requests restored to a slot, by mode")
        self._m_swap_out_bytes = ctr(
            "serving.swap_out_bytes",
            "HBM→host bytes moved by swap-outs and trie demotions "
            "(pool traffic, not streamed KV bytes)").labels(**lbl)
        self._m_swap_in_bytes = ctr(
            "serving.swap_in_bytes",
            "host→HBM bytes moved by swap-ins and trie "
            "promotions").labels(**lbl)
        self._m_cancelled = ctr(
            "serving.cancelled",
            "cancel() calls that found and tore down a live "
            "request").labels(**lbl)
        # migration bytes are pool traffic over the transport, never
        # streamed-KV or swap bytes
        self._m_mig_out = ctr(
            "migration.requests_out",
            "requests exported for cross-worker migration").labels(**lbl)
        self._m_mig_in = ctr(
            "migration.requests_in",
            "migration records imported into this engine").labels(**lbl)
        self._m_mig_bytes_out = ctr(
            "migration.bytes_out",
            "KV payload bytes serialized out by export_request "
            "(block payloads + scale rows)").labels(**lbl)
        self._m_mig_bytes_in = ctr(
            "migration.bytes_in",
            "KV payload bytes written into the pool by "
            "import_request").labels(**lbl)
        # the port's tick counts (no reference series)
        self._n_decode_ticks = 0
        self._n_mixed_ticks = 0
        self._tick_swap_bytes = 0      # host <-> device bytes this tick

    def _spec_m(self, kind: str):
        """The drafter-labelled spec children for one drafter kind:
        (drafted, hits, miss, rollbacks, accept_hist), built on first
        use (reference :1182)."""
        m = self._spec_children.get(kind)
        if m is None:
            lbl = dict(self._lbl, drafter=kind)
            m = self._spec_children[kind] = (
                self._f_drafted.labels(**lbl),
                self._f_draft_hits.labels(**lbl),
                self._f_draft_miss.labels(**lbl),
                self._f_rollbacks.labels(**lbl),
                self._f_spec_accept.labels(**lbl))
        return m

    def _set_occupancy(self, n: int) -> None:
        self._m_active.set(n)
        self._m_occ.set(n / self.num_slots if self.num_slots else 0.0)

    # -- cost model / perf attribution (reference :719-800) ------------------

    def _model_bytes(self) -> Tuple[int, int]:
        """(weight bytes, parameter count) the tick streams: every
        parameter and buffer of the served model (an int8-weight wrapper's
        int8 payloads and scales; the RoPE tables), each counted once.
        The reference counts its params tree, which holds the same
        tensors (see ROADMAP §C on where the two differ)."""
        seen = set()
        nbytes = n = 0
        for t in itertools.chain(self.model.parameters(),
                                 self.model.buffers()):
            if id(t) in seen:
                continue
            seen.add(id(t))
            nbytes += t.numel() * t.element_size()
            n += t.numel()
        return int(nbytes), int(n)

    def _build_perf_model(self):
        """The tick roofline (reference ``_build_perf_model``, :719): the
        model's bytes (int8 weights shrink the weight-stream term), the
        pool's dtype-aware per-token KV cost, no collective term (no
        mesh), priced on ``resolve_profile()`` for this engine's device
        (``h100`` on the card)."""
        from ..observability import costmodel as _cm
        weight_bytes, n_params = self._model_bytes()
        # int8 scale granule: a block in the paged pool, 128 positions in
        # the contiguous one (models/generation.init_kv_cache)
        kv_tok = _cm.kv_bytes_per_token(
            self.config, self.kv_dtype,
            block_len=self.block_len if self.paged else 128)
        model = _cm.CostModel(
            _cm.resolve_profile(device=self.device),
            weight_bytes=weight_bytes, n_params=n_params,
            kv_token_bytes=kv_tok, num_slots=self.num_slots)
        return _cm.TickAttribution(model, engine_id=self._eid)

    def _perf_tick(self, measured_ms: float, occ: int,
                   chunk_tokens: int = 0) -> None:
        """Stamp one measured tick with the model's prediction at the
        tick's occupancy, live depths (the host mirrors, still
        pre-advance: the depths the step just read) and chunk; host <->
        device bytes moved since the last dispatch ride along as the swap
        term (reference :747)."""
        swap_bytes, self._tick_swap_bytes = self._tick_swap_bytes, 0
        if self._perf is None:
            return
        live = int(self._positions[self._active].sum()) if occ else 0
        self._perf.on_tick(
            measured_ms, occ=occ, live_tokens=live,
            chunk_tokens=chunk_tokens,
            window=self.spec_k + 1 if self.spec else 1,
            swap_bytes=swap_bytes)

    def perf_report(self) -> Dict[str, object]:
        """Predicted-vs-measured attribution for this engine: per-bound
        tick shares, per-term predicted totals, measured / predicted ratio
        percentiles, drift findings and anomaly counts (reference :765).
        The predicted side is a pure function of the schedule
        (``observability.perf_signature``)."""
        if self._perf is None:
            return {"enabled": False}
        return dict(self._perf.report(), enabled=True)

    # -- predictive SLO admission (reference :779-860) ----------------------

    def admission_armed(self) -> bool:
        """True when the predictive gate prices admissions:
        FLAGS_serving_admission is "predictive", the cost model is built
        and it carries no drift finding."""
        return (self._perf is not None
                and str(flags.flag("serving_admission")) == "predictive"
                and not self._perf.has_drift())

    def admission_probe(self, prompt_len: int) -> Optional[Dict[str, float]]:
        """Price admitting one more request now: the predicted
        post-admission tick (the per-slot TPOT) and a coarse TTFT (ticks
        to drain the backlog ahead, a wave a tick, times the tick); None
        when FLAGS_perf_model is off."""
        if self._perf is None:
            return None
        occ_now = self.num_active
        backlog = self.queue_depth + self.num_pending + self.num_preempted
        occ_after = min(self.num_slots, occ_now + backlog + 1)
        live = int(self._positions[self._active].sum()) if occ_now else 0
        chunk = (self.prefill_chunk
                 if self.chunked and (backlog or self._cursor is not None)
                 else 0)
        pred = self._perf.model.predicted_tick_ms(
            occ_after, live + int(prompt_len), chunk_tokens=chunk,
            window=self.spec_k + 1 if self.spec else 1)
        waves = 1 + backlog // max(1, self.prefill_batch)
        return {"predicted_tick_ms": pred,
                "predicted_tpot_ms": pred,
                "predicted_ttft_ms": pred * waves,
                "occupancy_after": float(occ_after),
                "backlog": float(backlog)}

    def _admission_defer(self, req: Request, occ_after: int,
                         live_after: int, chunk_tokens: int = 0) -> bool:
        """The gate: True holds ``req`` in the submit queue this tick.  A
        pure function of scheduler state (no wall clock); never defers
        into an empty engine, never a recompute resume, and ages out after
        FLAGS_serving_admission_max_defer_ticks."""
        if req.resume is not None or not self.admission_armed():
            return False
        if occ_after <= 1:
            return False
        maxd = int(flags.flag("serving_admission_max_defer_ticks"))
        if maxd > 0 and req.defer_ticks >= maxd:
            return False
        # the pooled guard: the tightest TPOT deadline among running
        # slots and the candidate itself
        guards = [s.req.tpot_slo_ms for s in self._slots
                  if s is not None and s.req is not None
                  and s.req.tpot_slo_ms > 0]
        if req.tpot_slo_ms > 0:
            guards.append(req.tpot_slo_ms)
        if not guards:
            return False
        pred = self._perf.model.predicted_tick_ms(
            occ_after, live_after, chunk_tokens=chunk_tokens,
            window=self.spec_k + 1 if self.spec else 1)
        calib = float(flags.flag("serving_admission_calib"))
        slack = float(flags.flag("serving_admission_slack"))
        return pred * calib > min(guards) * slack

    def _defer(self, req: Request) -> None:
        """Account one predictive deferral (the request stays at its
        place in the submit queue)."""
        req.defer_ticks += 1
        self._m_deferred.inc()
        self._tracer.instant("serving.admission_deferred",
                             rid=req.request_id)
        if req.defer_ticks == 1:
            self._rlog.event(req.uid, "admission_deferred",
                             engine=self._eid, reason="predicted_slo")

    @property
    def prefill_tokens_computed(self) -> int:
        """Prompt tokens actually prefilled (pads excluded; paged prefix
        hits skip these — computed < total proves the cache worked)."""
        return int(self._m_prefill_computed.value())

    @property
    def prefill_tokens_total(self) -> int:
        return int(self._m_prefill_total.value())


    @property
    def step_traces(self) -> int:
        """Builds of the ``serving.step`` site — the decode step, or the
        chunked engine's mixed step (the reference's jit traces of its
        one step program; the continuous-batching contract is exactly 1):
        on the card the warm-up and capture of its CUDA graph, on the CPU
        (or inside ``disable_graphs()``) the build of the eager
        static-buffer step."""
        return (self._mixed or self._step).traces

    @property
    def prefill_traces(self) -> int:
        """Builds of the ``serving.prefill`` site — one a (bucket, rows)
        key the engine's waves used (the reference's compilations of its
        prefill, one a padded bucket); 0 in the chunked engine, which runs
        no wave."""
        return sum(st.traces for st in self._prefill_steps.values())

    @property
    def draft_traces(self) -> int:
        """Builds of the draft models' draft steps (``serving.draft_step``,
        budget 1 each)."""
        return sum(getattr(d, "draft_traces", 0)
                   for d in self._drafters.values())

    @property
    def decode_step_traces(self) -> int:
        """Builds of the decode step (in the chunked engine its own
        labelled site, beside :attr:`step_traces`)."""
        return self._step.traces

    @property
    def graphed(self) -> bool:
        """True when each tick replays a CUDA graph."""
        return self._step.graphed and (self._mixed is None
                                       or self._mixed.graphed)

    @property
    def pending_chunks(self) -> int:
        """Prompt chunks still to ingest (chunked mode): the active
        prompt's remainder plus every queued prompt's worth."""
        ch = self.prefill_chunk
        n = 0
        if self._cursor is not None:
            n += -(-(self._cursor.req.prompt.size
                     - self._cursor.cursor) // ch)
        for req in itertools.chain(self._resume_q, self._queue):
            n += -(-req.prompt.size // ch)
        return n

    @property
    def demote_traces(self) -> int:
        """Builds of the mixed pool's demote op (``serving.demote``, budget
        1); 0 for other pools."""
        return self._demote_fn.traces if self._demote_fn is not None else 0

    @property
    def host_cache_bytes(self) -> int:
        """Host memory the KV tier may take (0 without one); not part of
        :attr:`cache_hbm_bytes`."""
        return int(self.kv.host_cache_bytes()) if self.paged else 0

    @property
    def num_preempted(self) -> int:
        """Preempted requests awaiting resume (swapped-out chains plus
        recompute re-prefills still queued)."""
        return len(self._swap_resume) + len(self._resume_q)

    def metrics(self) -> Dict[str, object]:
        """This engine's series read back from the registry, under the
        reference engine's key names: latency readouts (ms: count, p50,
        p90, p99 from the buckets), occupancy, request / token / wave
        counters, ``slo_violations`` by cause, ``retired`` by reason,
        plus ``ticks`` (scheduler ticks that dispatched work: waves,
        decode and mixed steps), ``decode_ticks`` (ticks that ran the
        decode step alone), ``step_traces`` and ``graph_replays`` (ticks
        that replayed a CUDA graph), ``prefill_wave_ms``,
        ``prefill_traces`` and ``prefill_graph_replays`` (waves that
        replayed a CUDA graph), ``cancelled`` and ``migration`` (requests
        and payload bytes exported and imported).  ``decode_step_ms``
        times every tick that ran a step (the chunked engine's mixed ticks
        too, as the reference's does).  The paged engine adds the pool's
        accounting under ``kv_cache`` (with a host tier its ``host_tier``
        block; a mixed pool's ``demoted_blocks`` and ``demote_traces``),
        a preempting engine the reference's ``preempt`` block, the chunked
        engine ``mixed_ticks`` (ticks that carried a chunk),
        ``mixed_step_ms``, ``decode_step_traces`` and the reference's
        ``chunked`` block, the speculative engine the reference's ``spec``
        block (an N-token accept is one step, one ``accepted_per_step``
        observation and N tokens) and ``draft_traces``.
        ``observability.snapshot()`` is the process-wide superset."""
        def by_label(fam, key):
            return {str(c.labels[key]): int(c.value())
                    for c in fam.children()
                    if c.labels.get("engine") == self._eid}

        out = {"ttft_ms": hist_summary(self._m_ttft),
               "tpot_ms": hist_summary(self._m_tpot),
               "queue_wait_ms": hist_summary(self._m_queue_wait),
               "decode_step_ms": hist_summary(self._m_step_ms),
               "prefill_wave_ms": hist_summary(self._m_prefill_ms),
               "slot_occupancy": round(self._m_occ.value(), 3),
               "requests_submitted": int(self._m_submitted.value()),
               "requests_finished": int(self._m_finished.value()),
               "tokens_generated": int(self._m_tokens.value()),
               "prefill_waves": int(self._m_waves.value()),
               "ticks": self._ticks,
               "decode_ticks": self._n_decode_ticks,
               "step_traces": self.step_traces,
               "graph_replays": self._step.replays + (
                   self._mixed.replays if self._mixed else 0),
               "prefill_traces": self.prefill_traces,
               "prefill_graph_replays": sum(
                   st.replays for st in self._prefill_steps.values()),
               "prefill_tokens_computed": self.prefill_tokens_computed,
               "prefill_tokens_total": self.prefill_tokens_total,
               "slo_violations": by_label(self._f_slo_viol, "kind"),
               "retired": by_label(self._f_retired, "reason"),
               "cancelled": int(self._m_cancelled.value()),
               "migration": {
                   "requests_out": int(self._m_mig_out.value()),
                   "requests_in": int(self._m_mig_in.value()),
                   "bytes_out": int(self._m_mig_bytes_out.value()),
                   "bytes_in": int(self._m_mig_bytes_in.value())}}
        if self._m_dequant_err.count:
            out["kv_dequant_error"] = hist_summary(self._m_dequant_err)
        if self.spec:
            out["spec"] = {"spec_k": self.spec_k,
                           "default_drafter": getattr(self._drafter, "kind",
                                                      "custom"),
                           **self._spec_summary(
                               self._m_drafted, self._m_draft_hits,
                               self._m_draft_miss, self._m_rollbacks,
                               self._m_spec_accept)}
            if self._spec_children:
                out["spec"]["by_drafter"] = {
                    k: self._spec_summary(*m) for k, m in sorted(
                        self._spec_children.items())}
            out["draft_traces"] = self.draft_traces
        if self.chunked:
            out["mixed_ticks"] = self._n_mixed_ticks
            out["mixed_step_ms"] = hist_summary(self._m_mixed_ms)
            out["decode_step_traces"] = self.decode_step_traces
            out["chunked"] = {
                "prefill_chunk": self.prefill_chunk,
                "chunk_policy": self._chunk_policy,
                "prefill_chunks": int(self._m_chunks.value()),
                "prefill_chunk_tokens": int(self._m_chunk_tokens.value()),
                "chunk_queue_depth": hist_summary(self._m_chunk_queue)}
        if self.paged:
            st = self.kv.stats
            total = self.prefill_tokens_total
            out["kv_cache"] = {
                "kv_dtype": self.kv.kv_dtype,
                "quantized_blocks": st["quantized_blocks"],
                "bytes_by_dtype": st["bytes_by_dtype"],
                "blocks_in_use": self.kv.blocks_in_use(),
                "peak_blocks_in_use": st["peak_blocks_in_use"],
                "peak_pool_occupancy": round(
                    st["peak_blocks_in_use"] / self.kv.usable_blocks, 3),
                "prefix_lookups": st["prefix_lookups"],
                "prefix_hit_blocks": st["prefix_hit_blocks"],
                "prefix_hit_tokens": st["prefix_hit_tokens"],
                "prefix_hit_rate": round(st["prefix_hit_tokens"] / total,
                                         3) if total else 0.0,
                "evictions": st["evictions"],
                "cow_copies": st["cow_copies"],
                "admission_blocked": int(self._m_blocked.value())}
            if self.kv_dtype == "mixed":
                out["kv_cache"]["demoted_blocks"] = int(
                    self._m_demoted.value())
                out["kv_cache"]["demote_traces"] = self.demote_traces
            if self._host_blocks > 0:
                out["kv_cache"]["host_tier"] = {
                    "host_blocks": self._host_blocks,
                    "host_cache_bytes": self.host_cache_bytes,
                    "host_blocks_used": self.kv.host_blocks_used(),
                    "host_trie_blocks": self.kv.host_trie_blocks(),
                    **{k: st[k] for k in (
                        "host_demotions", "host_promotions",
                        "swapped_out_blocks", "swapped_in_blocks")},
                    "swap_out_bytes": int(self._m_swap_out_bytes.value()),
                    "swap_in_bytes": int(self._m_swap_in_bytes.value())}
            if self.preempt != "off":
                out["preempt"] = {
                    "mode": self.preempt,
                    "preemptions": by_label(self._f_preempt, "mode"),
                    "resumes": by_label(self._f_resumed, "mode"),
                    "awaiting_resume": self.num_preempted,
                    "decisions": len(self._preempt_log),
                    "signature": self.preempt_signature()}
        return out

    @staticmethod
    def _spec_summary(drafted, hits, miss, rollbacks, accept
                      ) -> Dict[str, object]:
        """One spec block (engine total or a drafter kind's) read from
        its children; the hit rate's denominator is that block's own
        proposals."""
        d, h = int(drafted.value()), int(hits.value())
        acc = hist_summary(accept)
        if acc["count"]:
            acc["mean"] = round(accept.sum / acc["count"], 3)
        return {"drafted_tokens": d,
                "draft_hit_tokens": h,
                "draft_miss_tokens": int(miss.value()),
                "draft_hit_rate": round(h / d, 3) if d else 0.0,
                "rollbacks": int(rollbacks.value()),
                "accepted_per_step": acc}

    # -- public API ------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               sampling: Optional[SamplingParams] = None,
               drafter=None, priority: int = 0,
               request_uid: Optional[int] = None,
               ttft_slo_ms: Optional[float] = None,
               tpot_slo_ms: Optional[float] = None) -> int:
        """Enqueue a request; returns its id.  Admission happens inside
        ``step()`` as slots free up (FIFO; with ``preempt`` armed, by
        ``priority`` class, higher first, FIFO within a class, and a
        blocked admission may preempt a running request of lower
        priority: :meth:`_try_preempt`).  ``request_uid`` threads an
        existing uid through (a router minted it and logged
        ``submitted``); None mints one from the request log and logs
        ``submitted`` (:meth:`request_uid`).  ``ttft_slo_ms`` /
        ``tpot_slo_ms``: the request's deadlines (None reads
        ``FLAGS_serving_slo_ttft_ms`` / ``FLAGS_serving_slo_tpot_ms``; 0
        disables one), recorded for the SLO accounting at retirement.
        A refused request logs ``rejected`` and counts in
        ``slo_violations["rejected"]``.  Raises ``ValueError`` for an
        empty prompt (``bad_prompt``), ``max_new_tokens < 1``
        (``bad_max_new_tokens``) or a request longer than ``max_length``
        (``too_long``), and in the paged engine for a request needing more
        blocks than the whole pool holds (``pool_too_small``).
        ``drafter`` (speculative engine): this request's drafter,
        ``"ngram"``, ``"model"`` or a ``Drafter`` (string kinds are built
        once an engine); None takes the engine's."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if ttft_slo_ms is None:
            ttft_slo_ms = float(flags.flag("serving_slo_ttft_ms"))
        if tpot_slo_ms is None:
            tpot_slo_ms = float(flags.flag("serving_slo_tpot_ms"))
        if request_uid is None:
            uid = self._rlog.new_uid()
            self._rlog.event(
                uid, "submitted", engine=self._eid,
                prompt_len=int(prompt.size),
                max_new_tokens=int(max_new_tokens),
                ttft_slo_ms=float(ttft_slo_ms),
                tpot_slo_ms=float(tpot_slo_ms))
        else:
            uid = int(request_uid)
        try:
            if prompt.size < 1:
                raise _Rejected("bad_prompt",
                                "prompt must contain at least one token")
            if max_new_tokens < 1:
                raise _Rejected(
                    "bad_max_new_tokens",
                    f"max_new_tokens must be >= 1, got {max_new_tokens}")
            if prompt.size + max_new_tokens > self.max_length:
                raise _Rejected(
                    "too_long",
                    f"prompt ({prompt.size}) + max_new_tokens "
                    f"({max_new_tokens}) exceeds the engine's max_length "
                    f"({self.max_length})")
            if self.paged:
                need = self.kv.blocks_needed(prompt.size, max_new_tokens)
                if need > self.kv.usable_blocks:
                    raise _Rejected(
                        "pool_too_small",
                        f"request needs {need} KV blocks but the pool "
                        f"only has {self.kv.usable_blocks} usable blocks")
        except _Rejected as e:
            self._rlog.event(uid, "rejected", engine=self._eid,
                             reason=e.reason)
            self._f_slo_viol.labels(engine=self._eid,
                                    kind="rejected").inc()
            raise ValueError(str(e)) from None
        rid = self._next_rid
        self._next_rid += 1
        self._results[rid] = []
        self._uids[rid] = uid
        self._queue.append(Request(
            rid, prompt, int(max_new_tokens), sampling or SamplingParams(),
            t_submit=self._clock(), drafter=drafter, uid=uid,
            ttft_slo_ms=float(ttft_slo_ms), tpot_slo_ms=float(tpot_slo_ms),
            priority=int(priority)))
        self._m_submitted.inc()
        return rid

    def request_uid(self, rid: int) -> int:
        """The lifecycle uid behind engine request ``rid``: the key into
        ``observability.get_request_log()`` (kept across a migration:
        :meth:`import_request` adopts the record's)."""
        return self._uids[rid]

    def step(self) -> List[int]:
        """One scheduler tick: admit queued requests into free slots
        (batched prefill waves), then ONE decode step over the slot batch.
        Returns the request ids finished this tick.  Idle ticks return at
        once."""
        if (not self._queue and not self._resume_q and not self._swap_resume
                and not self._active.any() and self._cursor is None):
            self._set_occupancy(0)
            return []
        with torch.no_grad(), self._tracer.span("serving.step",
                                                tick=self._ticks):
            if self.chunked:
                return self._step_inner_chunked()
            if self.spec:
                return self._step_inner_spec()
            return self._step_inner()

    def drain(self) -> List[Tuple[int, List[int]]]:
        """Run ticks until every submitted request completes; returns
        ``[(request_id, generated_tokens)]`` in arrival order (outputs end
        at EOS inclusive)."""
        while (self._queue or self._resume_q or self._swap_resume
               or self._cursor is not None
               or any(s is not None for s in self._slots)):
            self.step()
        return [(rid, list(toks))
                for rid, toks in sorted(self._results.items())]

    def result(self, rid: int) -> List[int]:
        """Tokens generated so far for ``rid`` (complete once finished)."""
        return list(self._results[rid])

    @property
    def cache_hbm_bytes(self) -> int:
        """Bytes of the KV cache (contiguous rows or paged pool, payload
        and scales) this engine keeps on its device."""
        return self._payload_bytes(self._leaves())

    def observe_dequant_error(self, max_abs_logit_delta: float) -> None:
        """Record one int8-KV parity observation — the max absolute logit
        delta against a full-precision run of the same trace — in
        ``metrics()["kv_dequant_error"]``.  For oracle runs; the serving
        path never computes logits twice."""
        self._m_dequant_err.observe(float(max_abs_logit_delta))

    @property
    def num_active(self) -> int:
        return self.num_slots - self._slots.count(None)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def num_pending(self) -> int:
        """Requests admitted but still prefilling (the chunked engine's
        cursor; 0 in wave mode, where admission prefills in its tick)."""
        return int(self._cursor is not None)

    # -- the mixed pool's demotions and the block movers --------------------

    def _apply_demotions(self) -> None:
        """Run the queued demotions (the reference's ``_apply_demotions``,
        ``paddle_tpu/serving/engine.py:1600``): only after the dispatch
        that wrote the blocks (a wave registers before its prefill, a
        chunk after its dispatch), on the same stream, so no prefill
        overwrites a demotion.  The list is drained in place: the
        manager's hook is a bound ``extend`` of it."""
        if not self._pending_demote:
            return
        pending = list(self._pending_demote)
        self._pending_demote.clear()
        for bid in pending:
            self._demote_fn(bid)
        self._m_demoted.inc(len(pending))

    def _leaves(self) -> Tuple[torch.Tensor, ...]:
        """The cache's tensors: the pool, or the int8 pool's payload and
        scales."""
        return (tuple(self._cache.values()) if isinstance(self._cache, dict)
                else (self._cache,))

    def _read_block(self, bid: int) -> Tuple[torch.Tensor, ...]:
        """One block of every cache leaf (an int8 block's scale row with
        its payload), copied into host memory (pinned on the card): the
        reference's one-block reader (``_block_movers``, :1619).  The copy
        is complete when this returns, so the manager may hand the block
        to a new owner right after."""
        pin = self.device.type == "cuda"
        out = []
        for t in self._leaves():
            h = torch.empty(t.shape[:2] + t.shape[3:], dtype=t.dtype,
                            pin_memory=pin)
            h.copy_(t[:, :, bid])
            out.append(h)
        return tuple(out)

    def _write_block(self, bid: int, payload) -> None:
        """Write a payload of :meth:`_read_block` into block ``bid`` IN
        PLACE: the pool's storage keeps its address, which the captured
        steps read.  The copy is queued on the current stream, before the
        next replay that reads the block."""
        for t, h in zip(self._leaves(), payload):
            t[:, :, bid].copy_(h, non_blocking=True)

    @staticmethod
    def _payload_bytes(payload) -> int:
        return int(sum(h.numel() * h.element_size() for h in payload))

    def _host_swap_out(self, pairs) -> None:
        """The manager's ``on_swap_out`` (:1663): each ``(bid, hid)``
        pair's block copied into its host payload (swap-outs and prefix
        blocks evicted to the host)."""
        tier = self.kv.host_tier
        for bid, hid in pairs:
            payload = self._read_block(bid)
            tier.put(hid, payload)
            nbytes = self._payload_bytes(payload)
            self._tick_swap_bytes += nbytes
            self._m_swap_out_bytes.inc(nbytes)

    def _host_swap_in(self, pairs) -> None:
        """The manager's ``on_swap_in`` (:1680): each ``(hid, bid)`` pair's
        host payload written back into its (re)allocated block."""
        tier = self.kv.host_tier
        for hid, bid in pairs:
            payload = tier.get(hid)
            self._write_block(bid, payload)
            nbytes = self._payload_bytes(payload)
            self._tick_swap_bytes += nbytes
            self._m_swap_in_bytes.inc(nbytes)

    # -- preemption (reference engine.py:1699-1911) --------------------------

    def _try_preempt(self, *, priority: int, rid: int,
                     blocked_ticks: int) -> bool:
        """Pick and preempt ONE victim so the blocked waiter's admission
        can retry (:1699).  Victims rank by (priority ascending, loosest
        TTFT deadline first (the relative budget; none ranks loosest),
        shortest progress, youngest request, slot).  A strictly
        lower-priority victim is preempted
        at once; one of the same priority only after the waiter has been
        blocked ``FLAGS_serving_preempt_after`` ticks, and never one that
        was preempted before.  Returns True when a victim was preempted
        (the caller retries admission)."""
        if self.preempt == "off":
            return False
        cands = []
        for i, slot in enumerate(self._slots):
            if slot is None or slot.req is None:
                continue
            vr = slot.req
            if vr.priority < priority:
                pass                       # strictly lower: at once
            elif (vr.priority == priority
                  and blocked_ticks >= self._preempt_after
                  and vr.preempt_count == 0):
                pass                       # the fairness gate passed
            else:
                continue
            dl = vr.ttft_slo_ms if vr.ttft_slo_ms > 0 else float("inf")
            prog = len(self._results[vr.request_id])
            cands.append(((vr.priority, -dl, prog, -vr.request_id, i), i))
        if not cands:
            return False
        _, victim = min(cands)
        self._do_preempt(victim, waiter_rid=rid)
        return True

    def _do_preempt(self, i: int, waiter_rid: int) -> None:
        """Evict slot ``i``'s request (:1744): swap its private blocks to
        the host tier (recompute when the tier cannot take them) or free
        its chain for a recompute, then park it on its resume queue."""
        slot = self._slots[i]
        req = slot.req
        mode = self.preempt
        record = None
        if mode == "swap":
            record = self.kv.swap_out(i)
            if record is None:
                mode = "recompute"         # the host tier is full
        if mode == "recompute":
            self.kv.preempt_free(i)
        req.preempt_count += 1
        gen = self._results[req.request_id]
        self._preempt_log.append({
            "tick": self._ticks, "victim_rid": req.request_id,
            "waiter_rid": waiter_rid, "mode": mode, "slot": i,
            "progress": len(gen)})
        self._f_preempt.labels(engine=self._eid, mode=mode).inc()
        self._tracer.instant("serving.preempted", rid=req.request_id,
                             mode=mode, slot=i)
        self._rlog.event(req.uid, "preempted", engine=self._eid,
                         mode=mode, slot=int(i), tokens=len(gen),
                         waiter=int(waiter_rid))
        if mode == "swap":
            n_host = sum(1 for e in record["entries"] if e[0] == "host")
            self._rlog.event(req.uid, "swapped_out", engine=self._eid,
                             blocks=len(record["entries"]),
                             host_blocks=int(n_host))
            self._push_swap_resume(_SwapResume(
                req=req, record=record, last_token=int(self._tokens[i]),
                position=int(self._positions[i]), remaining=slot.remaining,
                t_first=slot.t_first))
        else:
            # the re-prefill covers the prompt and every committed token
            # but the last: exactly the positions the cache held, and the
            # same blocks_needed as the first admission
            prompt2 = (np.concatenate(
                [req.prompt, np.asarray(gen[:-1], np.int32)])
                if len(gen) > 1 else req.prompt)
            self._push_resume_q(dataclasses.replace(
                req, prompt=prompt2, max_new_tokens=slot.remaining + 1,
                blocked_ticks=0,
                resume=_ResumeInfo(orig=req, last_token=int(gen[-1]),
                                   remaining=slot.remaining,
                                   t_first=slot.t_first)))
        self._clear_slot(i)

    def _push_swap_resume(self, entry: _SwapResume) -> None:
        self._swap_resume.append(entry)
        self._swap_resume.sort(
            key=lambda e: (-e.req.priority, e.req.request_id))

    def _push_resume_q(self, req: Request) -> None:
        # re-ordered IN PLACE: admission may hold this deque across a
        # preemption that pushes here
        self._resume_q.append(req)
        if len(self._resume_q) > 1:
            items = sorted(self._resume_q,
                           key=lambda r: (-r.priority, r.request_id))
            self._resume_q.clear()
            self._resume_q.extend(items)

    def _next_admit(self) -> Tuple[Deque, Request]:
        """The next request to admit and the queue it lives in (:1815):
        with preemption off, recompute resumes (none unless preemption
        ran) then FIFO; with it armed, across both queues by (-priority,
        request id), as with the predictive admission gate armed (a
        deferred batch head must not block the interactive class its
        deferral protects)."""
        if self.preempt == "off" and not self.admission_armed():
            src = self._resume_q if self._resume_q else self._queue
            return src, src[0]
        best = None
        for q in (self._resume_q, self._queue):
            for r in q:
                key = (-r.priority, r.request_id)
                if best is None or key < best[0]:
                    best = (key, q, r)
        return best[1], best[2]

    def _free_slots(self) -> List[int]:
        """Slots a request may take: no ``_Slot`` and not the chunked
        cursor's (it owns a chain but no ``_Slot`` yet)."""
        busy = self._cursor.slot if self._cursor is not None else None
        return [i for i, s in enumerate(self._slots)
                if s is None and i != busy]

    def _seat(self, si: int, slot: _Slot, req: Request, token: int,
              position: int) -> None:
        """Put ``slot`` into row ``si``: its host mirrors and, paged, its
        table row."""
        self._slots[si] = slot
        self._drafter_reset(si)
        self._active[si] = True
        self._tokens[si] = token
        self._positions[si] = position
        self._temps[si] = req.sampling.temperature
        self._topk[si] = req.sampling.top_k
        self._topp[si] = req.sampling.top_p
        if self.paged:
            self._tables[si] = self.kv.table_row(si, self.max_blocks)

    def _service_swap_resumes(self) -> None:
        """Admission's preamble (:1845): restore swapped-out requests
        (highest priority, then oldest, first) into free slots whenever the
        pool can hold their chains again; a blocked resume may itself
        preempt a running lower-priority request.  The slot state is the
        one at preemption, and the prompt registers again (the dtype tags
        came back with the blocks, so a mixed pool demotes nothing
        twice)."""
        while self._swap_resume:
            entry = self._swap_resume[0]
            free = self._free_slots()
            if not free:
                return
            si = free[0]
            got = self.kv.resume_swapped(si, entry.record)
            if got is None:
                entry.blocked_ticks += 1
                if not self._try_preempt(priority=entry.req.priority,
                                         rid=entry.req.request_id,
                                         blocked_ticks=entry.blocked_ticks):
                    return
                continue                   # a victim freed room: retry
            self._swap_resume.pop(0)
            req = entry.req
            self._seat(si, _Slot(req.request_id, entry.remaining,
                                 t_first=entry.t_first, prompt=req.prompt,
                                 drafter=req.drafter, req=req),
                       req, entry.last_token, entry.position)
            self.kv.register_prompt_upto(si, req.prompt,
                                         int(req.prompt.size))
            self._rlog.event(req.uid, "swapped_in", engine=self._eid,
                             slot=int(si), blocks=int(got))
            self._rlog.event(req.uid, "resumed", engine=self._eid,
                             mode="swap", slot=int(si))
            self._f_resumed.labels(engine=self._eid, mode="swap").inc()
            self._tracer.instant("serving.resumed", rid=req.request_id,
                                 mode="swap", slot=int(si))

    def preempt_signature(self) -> str:
        """SHA-256 over the ordered preemption decisions (victim, waiter,
        tick, mode, slot, progress): the same traffic must give the same
        victims."""
        blob = json.dumps(self._preempt_log, sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    @property
    def preempt_decisions(self) -> List[Dict[str, object]]:
        return list(self._preempt_log)

    # -- migration and cancellation (reference engine.py:1912-2105) ---------

    def export_request(self, rid: int, release: bool = True
                       ) -> Optional[Dict[str, object]]:
        """Serialise a DECODING request for another engine (:1912): the
        slot state a swap resume restores (position, last token, decode
        budget, sampling, priority, SLO deadlines, uid) and its KV chain
        by value
        (``BlockManager.export_blocks`` through :meth:`_read_block`: an
        int8 block's scales travel with it).  None when ``rid`` is not in
        a decode slot.  ``release`` frees the slot and its blocks after
        the copy; the partial output stays readable (``result``)."""
        if not self.paged:
            raise RuntimeError(
                "export_request requires the paged cache "
                "(ServingEngine(..., paged=True))")
        for i, slot in enumerate(self._slots):
            if slot is None or slot.rid != rid:
                continue
            req = slot.req
            blocks = self.kv.export_blocks(i, self._read_block)
            nbytes = sum(self._payload_bytes(e["payload"])
                         for e in blocks["entries"])
            record = {
                "uid": int(req.uid),
                "prompt": [int(t) for t in req.prompt],
                "generated": list(self._results.get(rid, [])),
                "max_new_tokens": int(req.max_new_tokens),
                "remaining": int(slot.remaining),
                "position": int(self._positions[i]),
                "last_token": int(self._tokens[i]),
                "had_first": bool(slot.t_first > 0.0),
                "sampling": {"temperature": float(req.sampling.temperature),
                             "top_k": int(req.sampling.top_k),
                             "top_p": float(req.sampling.top_p)},
                "priority": int(req.priority),
                "ttft_slo_ms": float(req.ttft_slo_ms),
                "tpot_slo_ms": float(req.tpot_slo_ms),
                "blocks": blocks,
                "payload_bytes": int(nbytes)}
            self._m_mig_out.inc()
            self._m_mig_bytes_out.inc(nbytes)
            self._rlog.event(req.uid, "exported", engine=self._eid,
                             slot=int(i), blocks=len(blocks["entries"]),
                             bytes=int(nbytes))
            self._tracer.instant("migration.export", rid=rid,
                                 blocks=len(blocks["entries"]),
                                 bytes=int(nbytes))
            if release:
                self._release(i)
            return record
        return None

    def import_request(self, record: Dict[str, object]) -> Optional[int]:
        """Materialise an exported request into a free slot of THIS engine
        and continue its decode where the exporter stopped (:1979): the
        blocks through ``BlockManager.import_blocks`` and
        :meth:`_write_block`, the slot state as a swap resume restores it,
        the prompt registered again (dtype tags kept: a mixed pool does not
        demote it again).  Returns the local request id (the record's uid
        is adopted), or None when no slot or pool room is free now (the
        record is not consumed)."""
        if not self.paged:
            raise RuntimeError(
                "import_request requires the paged cache "
                "(ServingEngine(..., paged=True))")
        free = self._free_slots()
        if not free:
            return None
        si = free[0]
        got = self.kv.import_blocks(si, record["blocks"], self._write_block)
        if got is None:
            return None
        uid = int(record["uid"])
        prompt = np.asarray(record["prompt"], np.int32)
        sp = record["sampling"]
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, int(record["max_new_tokens"]),
                      SamplingParams(temperature=float(sp["temperature"]),
                                     top_k=int(sp["top_k"]),
                                     top_p=float(sp["top_p"])),
                      t_submit=self._clock(), uid=uid,
                      ttft_slo_ms=float(record.get("ttft_slo_ms", 0.0)),
                      tpot_slo_ms=float(record.get("tpot_slo_ms", 0.0)),
                      priority=int(record["priority"]))
        self._results[rid] = list(record["generated"])
        self._uids[rid] = uid
        # the TPOT clock restarts on this engine's clock
        self._seat(si, _Slot(rid, int(record["remaining"]),
                             t_first=(self._clock() if record["had_first"]
                                      else 0.0), prompt=prompt, req=req),
                   req, int(record["last_token"]), int(record["position"]))
        self.kv.register_prompt_upto(si, prompt, int(prompt.size))
        nbytes = int(record.get("payload_bytes", 0))
        self._m_mig_in.inc()
        self._m_mig_bytes_in.inc(nbytes)
        self._rlog.event(uid, "imported", engine=self._eid, slot=int(si),
                         blocks=int(got), bytes=nbytes)
        self._tracer.instant("migration.import", rid=rid, blocks=int(got),
                             bytes=nbytes)
        return rid

    def cancel(self, rid: int) -> bool:
        """Tear request ``rid`` down wherever it is (:2056) — queued,
        awaiting a recompute resume, swapped out, mid chunked prefill or
        decoding — freeing its blocks as a release does, with a
        ``retired(reason="cancelled")`` event and the ``cancelled`` SLO
        bucket.  Returns True if it was found, False if unknown or
        finished.  Partial output stays readable (``result``)."""
        for q in (self._queue, self._resume_q):
            for req in q:
                if req.request_id == rid:
                    q.remove(req)
                    self._finish_cancel(
                        req if req.resume is None else req.resume.orig)
                    return True
        for k, entry in enumerate(self._swap_resume):
            if entry.req.request_id == rid:
                self._swap_resume.pop(k)
                self.kv.drop_swap_record(entry.record)
                self._finish_cancel(entry.req)
                return True
        pf = self._cursor
        if pf is not None and pf.req.request_id == rid:
            # mid chunked prefill: the slot owns a chain but no _Slot yet
            self._cursor = None
            if self.paged:
                self.kv.release(pf.slot)
                self._tables[pf.slot] = 0
            self._finish_cancel(
                pf.req if pf.req.resume is None else pf.req.resume.orig)
            return True
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.rid == rid:
                req = slot.req
                self._release(i)
                self._finish_cancel(req)
                return True
        return False

    def _finish_cancel(self, req: Request) -> None:
        tokens = len(self._results.get(req.request_id, []))
        self._m_finished.inc()
        self._m_cancelled.inc()
        self._f_retired.labels(engine=self._eid, reason="cancelled").inc()
        self._f_slo_viol.labels(engine=self._eid, kind="cancelled").inc()
        self._rlog.event(req.uid, "retired", engine=self._eid,
                         reason="cancelled", tokens=int(tokens),
                         violation="cancelled")
        self._tracer.instant("serving.cancelled", rid=req.request_id)

    # -- device work -------------------------------------------------------------

    def _pick(self, logits: torch.Tensor, temps: np.ndarray,
              topk: np.ndarray, topp: np.ndarray,
              greedy: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Next tokens for a batch of rows, int32 on the device.
        All-greedy batches take the argmax alone (``greedy`` when the
        caller computed it) — exactly what :func:`sample_tokens` returns
        for rows with ``temperature <= 0`` — so the sampling pass runs
        only when some row samples."""
        if not (temps > 0).any():
            nxt = logits.argmax(dim=-1) if greedy is None else greedy
        else:
            dev = logits.device
            nxt = sample_tokens(logits, torch.from_numpy(temps).to(dev),
                                torch.from_numpy(topk).to(dev),
                                torch.from_numpy(topp).to(dev),
                                generator=self._gen)
        return nxt.to(torch.int32)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                topk: np.ndarray, topp: np.ndarray,
                greedy: Optional[torch.Tensor] = None) -> np.ndarray:
        """:meth:`_pick`, fetched to the host (the tick's one
        synchronisation)."""
        return self._pick(logits, temps, topk, topp, greedy).cpu().numpy()

    def _grow_decode_rows(self, ok: Optional[np.ndarray] = None) -> None:
        """Paged, before a step: grow every decoding slot's chain over the
        positions this tick writes — its position, and in a verify step
        its REAL drafts after it (``ok``, the real-draft mask): pad-column
        writes past the chain land in the null block, so no block is
        taken for a draft never proposed."""
        for i, slot in enumerate(self._slots):
            if slot is not None:
                last = int(self._positions[i])
                if ok is not None:
                    last += int(ok[i].sum())
                self._grow_row_for_writes(i, last)

    def _decode(self) -> np.ndarray:
        """One decode step for ALL slots: row i holds its request at
        position ``positions[i]``; inactive rows decode the pad token at
        position 0 and their token is discarded (paged: their table row
        is all null, so their write lands in the null block).  The step
        itself is the once-built :class:`DecodeStep` over the host
        mirrors; the paged bookkeeping runs before it."""
        if self.paged:
            self._grow_decode_rows()
            self._flush_fresh_scales()
        logits, greedy = self._step.run()
        nxt = self._sample(logits, self._temps, self._topk, self._topp,
                           greedy)
        nxt[~self._active] = self.pad_token_id
        return nxt

    def _prefill(self, ids: np.ndarray, plens: np.ndarray,
                 slot_ids: List[int], temps, topk, topp) -> np.ndarray:
        """Prefill one admission wave: run the (n, bucket) prompts through
        the ``pos=0`` path (flash attention) on a bucket-long scratch
        cache, write the real rows into their slots, and sample each row's
        first token from the logits at its LAST REAL position (logits are
        computed at those positions only).  The wave is its key's
        :class:`PrefillStep`; the int8 cache's granules and scale rows:
        see there (the reference's fresh max_length-long sub-cache, row
        for row)."""
        logits, greedy = self._run_wave(ids, plens - 1,
                                        slots=np.asarray(slot_ids))
        return self._sample(logits, temps, topk, topp, greedy)

    def _prefill_paged(self, ids: np.ndarray, prefix: np.ndarray,
                       slens: np.ndarray, tables: np.ndarray, temps, topk,
                       topp) -> np.ndarray:
        """Paged prefill of one admission wave: each row computes ONLY its
        prompt suffix — the tokens its prefix-cache match did not cover —
        as a decode-at-depth over the pool (per-row ``pos`` = adopted
        prefix length; K2-paged reads the adopted blocks, not recomputed).
        Writes land straight in the rows' own blocks (bucket padding in
        the null block), every layer's writes before its read, so a row
        sees blocks another row of the same wave writes.  The first token
        samples from each row's last REAL suffix position (logits there
        only).  Only the wave's real rows run: the reference pads the
        wave to ``prefill_batch`` rows with all-null dummy tables."""
        self._flush_fresh_scales()
        logits, greedy = self._run_wave(ids, slens - 1, prefix=prefix,
                                        tables=tables)
        return self._sample(logits, temps, topk, topp, greedy)

    def _run_wave(self, ids: np.ndarray, last: np.ndarray, **inputs):
        """Run one wave on its (bucket, rows) key's step — built here on
        the key's first use, with the wave staged (a contiguous build
        warms up on the wave's own slots) — and return (logits at each
        row's ``last`` position, their argmax), on the device."""
        rows, bucket = ids.shape
        step = self._prefill_steps.get((bucket, rows))
        new = step is None
        if new:
            if self.device.type == "cuda" and self._prefill_pool is None:
                self._prefill_pool = torch.cuda.graph_pool_handle()
            step = PrefillStep(self.model, self._cache, bucket, rows,
                               self.max_blocks if self.paged else None,
                               self.device, self._eid,
                               eager=not self._step.graphed,
                               pool=self._prefill_pool)
            self._prefill_steps[(bucket, rows)] = step
        step.stage(ids, last, **inputs)
        if new:
            step.build()
        return step.run()

    def _grow_row_for_writes(self, i: int, last_pos: int):
        """Paged pre-dispatch bookkeeping for slot ``i`` about to write
        K/V at ``positions[i]..last_pos``: grow the chain over every block
        boundary in the span and copy-on-write each shared block in it
        (never in this engine's flow: full prompt blocks are immutable and
        tail blocks private), refreshing the table row when anything
        changed."""
        pos = int(self._positions[i])
        changed = self.kv.ensure_capacity(i, last_pos)
        for lb in range(pos // self.block_len,
                        last_pos // self.block_len + 1):
            cow = self.kv.ensure_writable(i, lb)
            if cow is not None:
                # the int8 pool copies the block's scale row with it
                src, dst = cow
                for t in self._leaves():
                    t[:, :, dst] = t[:, :, src]
                changed = True
        if changed:
            self._tables[i] = self.kv.table_row(i, self.max_blocks)

    def _flush_fresh_scales(self):
        """int8 pool, before every paged dispatch: zero the device scale
        rows of blocks newly appended to chains (``drain_fresh``), so a
        reused block's stale scale never coarsens its new tenant's
        running-max quantization (the zero scale also makes the first
        write clear the block's stale payload)."""
        if not (self.paged and self.quantized):
            return
        fresh = self.kv.drain_fresh()
        if fresh:
            idx = torch.tensor(fresh, device=self.device)
            self._cache["scale"][:, :, idx] = 0.0

    # -- scheduler ------------------------------------------------------------------

    def _step_inner(self) -> List[int]:
        finished = self._admit()
        occ = int(self._active.sum())
        self._set_occupancy(occ)
        if not occ:
            return finished
        self._ticks += 1
        self._n_decode_ticks += 1
        t0 = self._clock()
        with self._tracer.span("serving.decode", slots=occ):
            nxt = self._decode()
        now = self._clock()
        self._m_step_ms.observe((now - t0) * 1e3)
        self._perf_tick((now - t0) * 1e3, occ)
        finished.extend(self._advance_decode(nxt, now))
        return finished

    def _advance_decode(self, nxt: np.ndarray, now: float) -> List[int]:
        """Per-slot bookkeeping after a decode step's token fetch."""
        finished: List[int] = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            tok = int(nxt[i])
            self._positions[i] += 1
            self._tokens[i] = tok
            self._results[slot.rid].append(tok)
            slot.remaining -= 1
            self._m_tokens.inc()
            reason = self._finish_reason(tok, slot, i)
            if reason is not None:
                finished.append(slot.rid)
                self._retire(slot, i, reason, now)
        return finished

    # -- speculative decode (verify steps) -----------------------------------------

    def _make_drafter(self, sel):
        """A drafter from a selector (the reference's ``_make_drafter``,
        ``paddle_tpu/serving/engine.py:895``): a ``Drafter`` passes
        through; ``"ngram"`` / ``"model"`` build the proposer (the model
        drafter drafts with ``draft_model``, or with the target itself,
        graphed as the engine's steps are)."""
        if not isinstance(sel, str):
            return sel
        if sel == "ngram":
            return NgramDrafter(
                self.spec_k, max_ngram=int(flags.flag("serving_spec_ngram")))
        if sel == "model":
            dm = (self._draft_model if self._draft_model is not None
                  else self.model)
            return DraftModelDrafter(
                self.spec_k, dm, self.num_slots, self.max_length,
                pad_token_id=self.pad_token_id, engine_id=self._eid,
                device=self.device, eager=not self._step.graphed)
        raise ValueError(
            f"drafter must be 'ngram', 'model' or a Drafter instance, "
            f"got {sel!r}")

    def _drafter_for(self, sel):
        """A request's drafter (None: the engine's); string kinds are
        built once and shared."""
        if sel is None:
            return self._drafter
        if isinstance(sel, str):
            d = self._drafters.get(sel)
            if d is None:
                d = self._drafters[sel] = self._make_drafter(sel)
            return d
        return sel

    def _drafter_reset(self, i: int) -> None:
        """Slot ``i`` (re)assigned or released: clear the drafters'
        per-slot state (the draft model's consumed history)."""
        if not self.spec:
            return
        drafters = {id(d): d for d in (self._drafter,
                                       *self._drafters.values())}
        for d in drafters.values():
            reset = getattr(d, "reset_slot", None)
            if reset is not None:
                reset(i)

    def _propose_drafts(self):
        """The draft phase (the reference's ``_propose_drafts``,
        ``paddle_tpu/serving/engine.py:2163``): each slot's drafter
        proposes up to ``spec_k`` tokens, capped at ``remaining - 1`` (an
        accepted window never passes the request's budget) and at
        ``max_length - 1 - pos`` (every real draft's write in bounds).
        Host drafters run a slot at a time; a device drafter runs once
        for all its slots and its drafts are fetched.  Writes the drafts
        into the verify window (pad where none) and the real-draft mask
        into its staging; returns (that mask (S, k), the device drafters'
        [(q (S, k, V) on the device, {slot: drafts proposed})])."""
        s, k = self.num_slots, self.spec_k
        drafts = np.full((s, k), self.pad_token_id, np.int32)
        ok = np.zeros((s, k), bool)
        kinds: List[Optional[str]] = [None] * s
        jobs: Dict[int, tuple] = {}
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            d = self._drafter_for(slot.drafter)
            if d is None:
                continue
            cap = min(k, slot.remaining - 1,
                      self.max_length - 1 - int(self._positions[i]))
            if cap < 1:
                continue
            kinds[i] = str(getattr(d, "kind", "custom"))
            hist = np.concatenate(
                [slot.prompt, np.asarray(self._results[slot.rid], np.int32)])
            if getattr(d, "uses_device", False):
                job = jobs.setdefault(id(d), (d, {}, {}))
                job[1][i], job[2][i] = hist, cap
                continue
            prop = np.asarray(d.propose(hist), np.int32)[:cap]
            if prop.size:
                drafts[i, :prop.size] = prop
                ok[i, :prop.size] = True
                self._count_drafted(kinds[i], int(prop.size))
        device_q = []
        for d, hists, caps in jobs.values():
            dd, dq = d.propose_batch(hists, self._temps, self._gen)
            dd = dd.cpu().numpy()
            for i, m in caps.items():
                drafts[i, :m] = dd[i, :m]
                ok[i, :m] = True
                self._count_drafted(kinds[i], m)
            device_q.append((dq, caps))
        self._tick_kinds = kinds
        self._window[:, 1:] = drafts
        self._ok[:] = ok
        return ok, device_q

    def _count_drafted(self, kind: str, m: int) -> None:
        self._m_drafted.inc(m)
        self._spec_m(kind)[0].inc(m)

    def _decode_part(self, logits: torch.Tensor, greedy: torch.Tensor,
                     device_q) -> torch.Tensor:
        """The decode rows' result of a step, on the device, int32 and
        flat: the next tokens (B,), or in the speculative engine the
        committed window (B * (k + 1)) then n_acc (B,)
        (:meth:`_accept_window`)."""
        if not self.spec:
            return self._pick(logits, self._temps, self._topk, self._topp,
                              greedy)
        toks, n = self._accept_window(logits, greedy, device_q)
        return torch.cat([toks.flatten(), n])

    def _accept_window(self, logits: torch.Tensor, greedy: torch.Tensor,
                       device_q):
        """The verify step's acceptance (the reference's
        ``_verify_window``, :1336), after the step: an all-greedy tick
        needs only the graph's argmax (the prefix-match rule); when a row
        samples, q is built on the device — one-hot at the host drafters'
        drafts, the device drafters' softmax on their rows — and the
        sampled rows run rejection sampling with the engine's
        generator."""
        st = self._step
        drafts = st.tokens[:, 1:]
        if not (self._temps > 0).any():
            return accept_draft_tokens(logits, drafts, st.ok,
                                       pad_token_id=self.pad_token_id,
                                       greedy=greedy)
        b, k = drafts.shape
        q = torch.zeros((b, k, logits.shape[-1]), dtype=torch.float32,
                        device=logits.device)
        q.scatter_(2, drafts.long()[..., None],
                   st.ok.to(torch.float32)[..., None])
        for dq, caps in device_q:
            for i, m in caps.items():
                q[i, :m] = dq[i, :m]
        return accept_draft_tokens(
            logits, drafts, st.ok, self._gen, self._temps, self._topk,
            self._topp, pad_token_id=self.pad_token_id, draft_probs=q,
            greedy=greedy)

    def _step_inner_spec(self) -> List[int]:
        """One speculative tick (the reference's ``_step_inner_spec``,
        :2233): wave admission as ever, then the draft phase, then ONE
        verify step over every slot's window and the acceptance; the
        tick's one host sync fetches the committed windows and n_acc (a
        draft model's drafts are fetched before the step, as the window's
        staging needs them)."""
        finished = self._admit()
        occ = int(self._active.sum())
        self._set_occupancy(occ)
        if not occ:
            return finished
        with self._tracer.span("serving.draft"):
            ok, device_q = self._propose_drafts()
        self._ticks += 1
        self._n_decode_ticks += 1
        t0 = self._clock()
        with self._tracer.span("serving.verify", slots=occ,
                               drafted=int(ok.sum())):
            if self.paged:
                self._grow_decode_rows(ok)
                self._flush_fresh_scales()
            logits, greedy = self._step.run()
            host = self._decode_part(logits, greedy,
                                     device_q).cpu().numpy()
        now = self._clock()
        self._m_step_ms.observe((now - t0) * 1e3)
        self._perf_tick((now - t0) * 1e3, occ)
        finished.extend(self._advance_decode_spec(host, ok, now))
        return finished

    def _advance_decode_spec(self, host: np.ndarray, draft_ok: np.ndarray,
                             now: float) -> List[int]:
        """Per-slot bookkeeping after a verify step (the reference's
        ``_advance_decode_spec``, :2287): commit each row's accepted
        prefix, stopping AT an EOS inside it, and roll the rest back — the
        position stays at the accept point; the paged engine returns the
        blocks past it (``truncate_to``) and refreshes the table row.  An
        N-token accept is N tokens in one step: ``tokens_generated`` += N,
        one ``accepted_per_step`` observation, one retirement.  ``host``:
        :meth:`_decode_part` fetched."""
        b, w = self.num_slots, self.spec_k + 1
        out = host[:b * w].reshape(b, w)
        n_acc = host[b * w:b * w + b]
        finished: List[int] = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            n = int(n_acc[i])
            drafted = int(draft_ok[i].sum())
            kind = self._tick_kinds[i]
            km = self._spec_m(kind) if (drafted and kind) else None
            take, reason = n, None
            if self.eos_token_id is not None:
                hits = np.flatnonzero(out[i, :n] == self.eos_token_id)
                if hits.size:
                    take, reason = int(hits[0]) + 1, "eos"
            toks = [int(t) for t in out[i, :take]]
            self._results[slot.rid].extend(toks)
            self._positions[i] += take
            self._tokens[i] = toks[-1]
            slot.remaining -= take
            self._m_tokens.inc(take)
            self._m_spec_accept.observe(take)
            if km is not None:
                km[4].observe(take)
            if drafted and slot.req is not None:
                self._rlog.event(slot.req.uid, "spec_accept",
                                 engine=self._eid, tokens=int(take),
                                 drafted=int(drafted),
                                 drafter_kind=kind or "custom")
            if drafted:
                # hits: committed drafts (the last token is free);
                # misses: drafts the verification rejected (an EOS cut
                # counts its verified drafts on neither side)
                self._m_draft_hits.inc(take - 1)
                self._m_draft_miss.inc(drafted - (n - 1))
                if km is not None:
                    km[1].inc(take - 1)
                    km[2].inc(drafted - (n - 1))
            if take <= drafted:
                self._m_rollbacks.inc()
                if km is not None:
                    km[3].inc()
            if take <= drafted and self.paged:
                self.kv.truncate_to(i, int(self._positions[i]))
                self._tables[i] = self.kv.table_row(i, self.max_blocks)
            if reason is None:
                reason = self._finish_reason(toks[-1], slot, i)
            if reason is not None:
                finished.append(slot.rid)
                self._retire(slot, i, reason, now)
        return finished

    # -- chunked-prefill scheduler (mixed steps) ----------------------------------

    def _step_inner_chunked(self) -> List[int]:
        """One token-budget tick (the reference's ``_step_inner_chunked``,
        ``paddle_tpu/serving/engine.py:2355``): admit the FIFO head into a
        free slot as a cursor, then replay the mixed step — every decode
        row plus at most one ``prefill_chunk``-token slice of the admitted
        prompt — or, on a tick without a chunk, the decode step."""
        finished = self._admit_chunked()
        occ = int(self._active.sum())
        self._set_occupancy(occ)
        pf = self._cursor
        self._m_chunk_queue.observe(self.pending_chunks)
        # decode-priority policy: while decodes are active, pending chunks
        # run on alternate ticks only (odd _ticks)
        do_chunk = pf is not None and (
            self._chunk_policy == "prefill" or occ == 0
            or self._ticks % 2 == 1)
        if not occ and not do_chunk:
            return finished
        self._ticks += 1
        ok = device_q = None
        if self.spec:
            # the decode half is the verify window; a row whose prompt is
            # still streaming is not in a slot yet, so it drafts nothing
            with self._tracer.span("serving.draft"):
                ok, device_q = self._propose_drafts()
        clen = (min(self.prefill_chunk, pf.req.prompt.size - pf.cursor)
                if do_chunk else 0)
        t0 = self._clock()
        with self._tracer.span(
                "serving.verify" if self.spec else "serving.decode",
                slots=occ), (
                self._tracer.span("serving.chunk", slot=pf.slot,
                                  start=pf.cursor, tokens=clen)
                if do_chunk else contextlib.nullcontext()):
            host, ctok = self._run_tick_chunked(pf, clen, do_chunk, ok,
                                                device_q)
        now = self._clock()
        self._m_step_ms.observe((now - t0) * 1e3)
        self._perf_tick((now - t0) * 1e3, occ, chunk_tokens=clen)
        if do_chunk:
            self._n_mixed_ticks += 1
            self._m_mixed_ms.observe((now - t0) * 1e3)
        else:
            self._n_decode_ticks += 1
        if self.spec:
            finished.extend(self._advance_decode_spec(host, ok, now))
        else:
            host[~self._active] = self.pad_token_id
            finished.extend(self._advance_decode(host, now))
        if do_chunk:
            finished.extend(self._advance_chunk(pf, clen, ctok, now))
        self._apply_demotions()
        return finished

    def _run_tick_chunked(self, pf: Optional[_Prefill], clen: int,
                          do_chunk: bool, ok, device_q):
        """The chunked tick's device work through its one host fetch: the
        mixed step with ``clen`` tokens of ``pf``'s prompt, or the decode
        step alone.  Returns (the decode rows' fetched result, the prompt's
        first token when this chunk completed it, else None)."""
        if self.paged:
            self._grow_decode_rows(ok)
        if do_chunk:
            mx = self._mixed
            mx.ids_host[:] = self.pad_token_id
            mx.ids_host[:clen] = pf.req.prompt[pf.cursor:pf.cursor + clen]
            mx.pos_host[0] = pf.cursor
            mx.len_host[0] = clen
            if self.paged:
                # grow the chain over this chunk's real tokens; pad-tail
                # positions past it land in the null block
                self.kv.ensure_capacity(pf.slot, pf.cursor + clen - 1)
                mx.table_host[:] = self.kv.table_row(pf.slot,
                                                     self.max_blocks)
            else:
                mx.row_host[0] = pf.slot
            self._flush_fresh_scales()
            logits, greedy, clogits, cgreedy = mx.run()
            parts = [self._decode_part(logits, greedy, device_q)]
            sp = pf.req.sampling
            done = pf.cursor + clen == pf.req.prompt.size
            if done:
                parts.append(self._pick(
                    clogits, np.array([sp.temperature], np.float32),
                    np.array([sp.top_k], np.int32),
                    np.array([sp.top_p], np.float32), cgreedy))
            host = torch.cat(parts).cpu().numpy()   # the tick's one sync
            ctok = int(host[-1]) if done else None
            if done:
                host = host[:-1]
            return host, ctok
        self._flush_fresh_scales()
        logits, greedy = self._step.run()
        return self._decode_part(logits, greedy,
                                 device_q).cpu().numpy(), None

    def _admit_chunked(self) -> List[int]:
        """Move the FIFO head into a free slot as a partially-prefilled
        request — a cursor, not a prefill dispatch (the reference's
        ``_admit_chunked``, :2484).  One prompt streams at a time, in FIFO
        order.  Queue-wait is observed once, here."""
        if self.paged:
            self._service_swap_resumes()
        if self._cursor is not None or not (self._resume_q or self._queue):
            return []
        free = self._free_slots()
        if not free:
            return []
        src, req = self._next_admit()
        occ = self.num_slots - len(free)
        live = int(self._positions[self._active].sum()) if occ else 0
        if self._admission_defer(req, occ + 1, live + int(req.prompt.size),
                                 chunk_tokens=self.prefill_chunk):
            self._defer(req)
            return []
        si = free[0]
        m = 0
        if self.paged:
            got = self.kv.admit(si, req.prompt, req.prompt.size,
                                req.max_new_tokens, chunked=True)
            while got is None and self._try_preempt(
                    priority=req.priority, rid=req.request_id,
                    blocked_ticks=req.blocked_ticks):
                got = self.kv.admit(si, req.prompt, req.prompt.size,
                                    req.max_new_tokens, chunked=True)
            if got is None:            # pool full: wait for retirements
                self._blocked(req)
                return []
            m = got                    # adopted prefix tokens skip compute
        src.remove(req)
        if self.quantized and not self.paged:
            # the prompt streams into a reused row: drop the previous
            # tenant's granule scales first (in place, outside the graph)
            self._cache["scale"][:, :, si] = 0.0
        now = self._clock()
        self._m_prefill_total.inc(int(req.prompt.size))
        if req.resume is None:
            self._admitted(req, si, now, int(m))
        self._cursor = _Prefill(req, si, int(m))
        return []

    def _blocked(self, req: Request) -> None:
        """A paged admission the pool refused (reference :2517-2526): the
        count, an instant, and the request's ``admission_wait`` event once
        a wait."""
        self._m_blocked.inc()
        self._tracer.instant("serving.admission_blocked",
                             rid=req.request_id)
        req.blocked_ticks += 1
        if req.blocked_ticks == 1:
            self._rlog.event(req.uid, "admission_wait", engine=self._eid,
                             reason="pool_full")

    def _admitted(self, req: Request, si: int, t_adm: float,
                  prefix: int) -> None:
        """A request (not a recompute resume) entered slot ``si``: its
        queue wait and ``admitted`` event."""
        req.t_admit = t_adm
        wait = (t_adm - req.t_submit) * 1e3
        self._m_queue_wait.observe(wait)
        self._rlog.event(req.uid, "admitted", engine=self._eid,
                         slot=int(si), queue_wait_ms=wait,
                         blocked_ticks=int(req.blocked_ticks),
                         prefix_hit_tokens=int(prefix))

    def _advance_chunk(self, pf: _Prefill, clen: int, ctok: Optional[int],
                       now: float) -> List[int]:
        """Account one ingested chunk (the reference's ``_advance_chunk``,
        :2548); when it completes the prompt, ``ctok`` is the request's
        first token and the slot turns from prefilling to decoding."""
        pf.cursor += clen
        self._m_chunks.inc()
        self._m_chunk_tokens.inc(clen)
        self._m_prefill_computed.inc(clen)
        self._rlog.event(pf.req.uid, "prefill_chunk", engine=self._eid,
                         tokens=int(clen), cursor=int(pf.cursor))
        if self.paged:
            # the now-written full blocks become shareable — never earlier
            self.kv.register_prompt_upto(pf.slot, pf.req.prompt, pf.cursor)
        plen = int(pf.req.prompt.size)
        if pf.cursor < plen:
            return []
        si, req = pf.slot, pf.req
        self._cursor = None
        ri = req.resume
        if ri is not None:
            # a recompute resume: as in _start_wave
            self._seat(si, _Slot(req.request_id, ri.remaining,
                                 t_first=ri.t_first, prompt=ri.orig.prompt,
                                 drafter=ri.orig.drafter, req=ri.orig),
                       req, ri.last_token, plen)
            self._resumed_recompute(req, si)
            return []
        slot = _Slot(req.request_id, req.max_new_tokens - 1, t_first=now,
                     prompt=req.prompt, drafter=req.drafter, req=req)
        self._seat(si, slot, req, ctok, plen)
        self._results[req.request_id].append(ctok)
        self._first_token(req, now)
        reason = self._finish_reason(ctok, slot, si)
        if reason is not None:
            self._retire(slot, si, reason, now)
            return [req.request_id]
        return []

    @staticmethod
    def _bucket(plen: int) -> int:
        """Padded prefill length: next power of two (floor 8), as in the
        reference — waves group requests of one bucket."""
        b = 8
        while b < plen:
            b *= 2
        return b

    def _admit(self) -> List[int]:
        """Move queued requests into free slots, one batched-prefill wave
        per contiguous FIFO run sharing a bucket (the predictive gate,
        when armed, may hold the head back: :meth:`_admission_defer`).
        Returns ids that finished AT admission (first token was EOS /
        max_new_tokens=1)."""
        if self.paged:
            return self._admit_paged()
        finished: List[int] = []
        deferred = False
        while self._queue and not deferred:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                break
            occ = self.num_slots - len(free)
            live = int(self._positions[self._active].sum()) if occ else 0
            bucket = min(self._bucket(len(self._queue[0].prompt)),
                         self.max_length)
            wave: List[Request] = []
            wave_tokens = 0
            while (self._queue
                   and len(wave) < min(self.prefill_batch, len(free))
                   and min(self._bucket(len(self._queue[0].prompt)),
                           self.max_length) == bucket):
                head = self._queue[0]
                if self._admission_defer(
                        head, occ + len(wave) + 1,
                        live + wave_tokens + int(head.prompt.size)):
                    self._defer(head)
                    deferred = True
                    break
                wave.append(self._queue.popleft())
                wave_tokens += int(head.prompt.size)
            if not wave:
                break
            finished.extend(self._prefill_wave(wave, free[:len(wave)],
                                               bucket))
        return finished

    def _admit_paged(self) -> List[int]:
        """Paged admission (the reference's ``_admit_paged``, :3271):
        requests enter free slots once the block pool covers their worst
        case (kv_cache.py reservations), adopting any cached prompt prefix
        on the way in.  A wave shares one padded SUFFIX bucket.  The head
        blocking on pool space blocks the queue (``admission_blocked``
        counts each refusal).  With preemption armed, swapped chains are
        restored first, the head is picked across the recompute-resume
        and submit queues by priority (:meth:`_next_admit`), and a blocked
        head may preempt a victim (:meth:`_try_preempt`) and retry."""
        self._service_swap_resumes()
        finished: List[int] = []
        deferred = False
        while (self._resume_q or self._queue) and not deferred:
            free = self._free_slots()
            if not free:
                break
            occ = self.num_slots - len(free)
            live = int(self._positions[self._active].sum()) if occ else 0
            wave: List[Tuple[Request, int, int]] = []
            wave_tokens = 0
            while ((self._resume_q or self._queue)
                   and len(wave) < min(self.prefill_batch, len(free))):
                src, req = self._next_admit()
                if self._admission_defer(
                        req, occ + len(wave) + 1,
                        live + wave_tokens + int(req.prompt.size)):
                    self._defer(req)
                    deferred = True
                    break
                si = free[len(wave)]
                m = self.kv.admit(si, req.prompt, req.prompt.size,
                                  req.max_new_tokens)
                while m is None and self._try_preempt(
                        priority=req.priority, rid=req.request_id,
                        blocked_ticks=req.blocked_ticks):
                    m = self.kv.admit(si, req.prompt, req.prompt.size,
                                      req.max_new_tokens)
                if m is None:          # pool full: wait for retirements
                    self._blocked(req)
                    break
                # by identity: a preemption in the retry loop may have
                # re-ordered the resume queue
                src.remove(req)
                self._tables[si] = self.kv.table_row(si, self.max_blocks)
                wave.append((req, si, m))
                wave_tokens += int(req.prompt.size)
            if not wave:
                break
            finished.extend(self._prefill_wave_paged(wave))
        return finished

    def _prefill_wave_paged(self, wave: List[Tuple[Request, int, int]]
                            ) -> List[int]:
        """One paged admission wave: the bucket is the power of two of the
        longest SUFFIX; each row starts at its adopted prefix length."""
        t_adm = self._clock()
        n = len(wave)
        bucket = min(max(self._bucket(req.prompt.size - m)
                         for req, _, m in wave), self.max_length)
        ids = np.full((n, bucket), self.pad_token_id, np.int32)
        prefix = np.zeros((n,), np.int32)
        slens = np.ones((n,), np.int32)
        tables = np.zeros((n, self.max_blocks), np.int32)
        for r, (req, si, m) in enumerate(wave):
            suffix = req.prompt[m:]
            ids[r, :suffix.size] = suffix
            prefix[r] = m
            slens[r] = suffix.size
            tables[r] = self._tables[si]
        reqs = [req for req, _, _ in wave]
        temps, topk, topp = self._wave_sampling(
            reqs, [si for _, si, _ in wave], [m for _, _, m in wave],
            [int(v) for v in slens], bucket, t_adm)
        with self._tracer.span("serving.prefill", bucket=bucket, rows=n):
            tok = self._prefill_paged(ids, prefix, slens, tables, temps,
                                      topk, topp)
        self._apply_demotions()
        return self._start_wave(reqs, [si for _, si, _ in wave],
                                [req.prompt.size for req in reqs], tok,
                                t_adm)

    def _wave_sampling(self, wave: List[Request], slots: List[int],
                       prefix: List[int], computed: List[int], bucket: int,
                       t_adm: float):
        """A wave's per-row sampling knobs; accounts the wave (reference
        :3348-3375): each row's prompt tokens computed (``computed``) and
        submitted, its queue wait and ``admitted`` event (not for a
        recompute resume, which waited before) and its ``prefill`` event,
        then the wave's counters and tick."""
        n = len(wave)
        temps = np.zeros((n,), np.float32)
        topk = np.zeros((n,), np.int32)
        topp = np.ones((n,), np.float32)
        for r, req in enumerate(wave):
            temps[r] = req.sampling.temperature
            topk[r] = req.sampling.top_k
            topp[r] = req.sampling.top_p
            self._m_prefill_computed.inc(int(computed[r]))
            self._m_prefill_total.inc(int(req.prompt.size))
            if req.resume is None:
                self._admitted(req, slots[r], t_adm, prefix[r])
            self._rlog.event(req.uid, "prefill", engine=self._eid,
                             bucket=int(bucket), tokens=int(computed[r]))
        self._m_waves.inc()
        self._f_bucket.labels(engine=self._eid, bucket=str(bucket)).inc()
        self._ticks += 1
        return temps, topk, topp

    def _prefill_wave(self, wave: List[Request], slots: List[int],
                      bucket: int) -> List[int]:
        t_adm = self._clock()
        n = len(wave)
        ids = np.full((n, bucket), self.pad_token_id, np.int32)
        plens = np.ones((n,), np.int32)
        for r, req in enumerate(wave):
            ids[r, :req.prompt.size] = req.prompt
            plens[r] = req.prompt.size
        temps, topk, topp = self._wave_sampling(
            wave, slots, [0] * n, [int(v) for v in plens], bucket, t_adm)
        with self._tracer.span("serving.prefill", bucket=bucket, rows=n):
            tok = self._prefill(ids, plens, slots, temps, topk, topp)
        return self._start_wave(wave, slots, list(plens), tok, t_adm)

    def _start_wave(self, wave: List[Request], slots: List[int],
                    plens: List[int], tok: np.ndarray,
                    t_adm: float) -> List[int]:
        """Seat a prefilled wave in its slots with its first tokens;
        returns ids that finished at admission.  A recompute resume
        (``req.resume``) discards its re-sampled token and takes back the
        last committed one, its decode budget and its TPOT clock: the
        decode replays no token and drops none."""
        t_tok = self._clock()
        self._m_prefill_ms.observe((t_tok - t_adm) * 1e3)
        finished: List[int] = []
        for r, (req, si) in enumerate(zip(wave, slots)):
            ri = req.resume
            if ri is not None:
                self._seat(si, _Slot(req.request_id, ri.remaining,
                                     t_first=ri.t_first,
                                     prompt=ri.orig.prompt,
                                     drafter=ri.orig.drafter, req=ri.orig),
                           req, ri.last_token, plens[r])
                self._resumed_recompute(req, si)
                continue
            slot = _Slot(req.request_id, req.max_new_tokens - 1,
                         t_first=t_tok, prompt=req.prompt,
                         drafter=req.drafter, req=req)
            self._seat(si, slot, req, int(tok[r]), plens[r])
            self._results[req.request_id].append(int(tok[r]))
            self._first_token(req, t_tok)
            reason = self._finish_reason(int(tok[r]), slot, si)
            if reason is not None:
                finished.append(req.request_id)
                self._retire(slot, si, reason, t_tok)
        return finished

    def _first_token(self, req: Request, now: float) -> None:
        """A request's first token is fetched: its count, TTFT and
        ``first_token`` event."""
        ttft = (now - req.t_submit) * 1e3
        self._m_tokens.inc()
        self._m_ttft.observe(ttft)
        if self._perf is not None:
            self._perf.on_ttft(ttft)
        self._rlog.event(req.uid, "first_token", engine=self._eid,
                         ttft_ms=ttft)

    def _resumed_recompute(self, req: Request, si: int) -> None:
        self._rlog.event(req.uid, "resumed", engine=self._eid,
                         mode="recompute", slot=int(si))
        self._f_resumed.labels(engine=self._eid, mode="recompute").inc()
        self._tracer.instant("serving.resumed", rid=req.request_id,
                             mode="recompute", slot=int(si))

    def _finish_reason(self, tok: int, slot: _Slot,
                       i: int) -> Optional[str]:
        """None while the request keeps going, else the retirement reason."""
        if self.eos_token_id is not None and tok == self.eos_token_id:
            return "eos"
        if slot.remaining <= 0:
            return "max_new_tokens"
        if int(self._positions[i]) >= self.max_length:
            return "max_length"
        return None

    def _retire(self, slot: _Slot, i: int, reason: str, now: float):
        """Per-request SLO readout at retirement (reference :3176), then
        release the slot.  TPOT = decode time a token after the first."""
        n = len(self._results[slot.rid])
        tpot = None
        if n > 1 and slot.t_first > 0.0:
            tpot = (now - slot.t_first) * 1e3 / (n - 1)
            self._m_tpot.observe(tpot)
            if self._perf is not None:
                self._perf.on_tpot(tpot)
        self._m_finished.inc()
        self._f_retired.labels(engine=self._eid, reason=reason).inc()
        req = slot.req
        if req is not None:
            ttft = ((slot.t_first - req.t_submit) * 1e3
                    if slot.t_first > 0.0 else None)
            kind = self._slo_violation(req, ttft, tpot)
            if kind is not None:
                self._f_slo_viol.labels(engine=self._eid, kind=kind).inc()
            self._rlog.event(
                req.uid, "retired", engine=self._eid, reason=reason,
                tokens=int(n),
                ttft_ms=(round(ttft, 6) if ttft is not None else None),
                tpot_ms=(round(tpot, 6) if tpot is not None else None),
                violation=kind or "none")
        self._release(i)

    @staticmethod
    def _slo_violation(req: Request, ttft: Optional[float],
                       tpot: Optional[float]) -> Optional[str]:
        """Attribute a retired request's SLO miss to ONE cause
        (reference :3205): a missed TTFT (measured from submit) splits by
        the larger segment, ``queue_wait`` (submit -> admission) or
        ``prefill`` (admission -> first token); else a missed TPOT is
        ``decode``.  A deadline of 0 never misses."""
        if req.ttft_slo_ms > 0 and ttft is not None \
                and ttft > req.ttft_slo_ms:
            qw = ((req.t_admit - req.t_submit) * 1e3
                  if req.t_admit > 0.0 else 0.0)
            return "queue_wait" if qw >= ttft - qw else "prefill"
        if req.tpot_slo_ms > 0 and tpot is not None \
                and tpot > req.tpot_slo_ms:
            return "decode"
        return None

    def _release(self, i: int):
        if self.paged:
            self.kv.release(i)
        self._clear_slot(i)

    def _clear_slot(self, i: int):
        """Reset slot ``i``'s host mirrors: the row decodes the pad token
        at its idle position (0; the contiguous chunked engine's
        ``max_length``, where writes drop) until a new request takes it
        (paged: through an all-null table row)."""
        if self.paged:
            self._tables[i] = 0
        self._drafter_reset(i)
        self._slots[i] = None
        self._active[i] = False
        self._tokens[i] = self.pad_token_id
        self._positions[i] = self._idle_pos
        self._temps[i] = 0.0
        self._topk[i] = 0
        self._topp[i] = 1.0
