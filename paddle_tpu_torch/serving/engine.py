"""Continuous-batching serving engine — core slice
(mirrors ``paddle_tpu/serving/engine.py``).

``submit()`` enqueues, ``step()`` runs one scheduler tick (admit queued
requests in batched prefill waves, then ONE decode step over every slot,
then retire), ``drain()`` runs ticks until every request is done.  This
slice serves the reference's default configuration: contiguous per-slot
bf16 (model-dtype) cache, wave prefill, no speculation, no int8, greedy
unless a request asks to sample.  Any other configuration raises
``NotImplementedError`` naming its ROADMAP item.

Where the reference jits a step program once and donates the cache, the
port runs eagerly and writes the one cache tensor in place.  Prefill
differs in one detail: the reference scatters whole fresh cache rows into
the slots (dummy rows dropped); the port writes only the real rows' first
``bucket`` positions.  A slot's stale tail past its prompt is never read:
flash-decode (K1) walks only ``[0, pos + s)``, and each decode tick writes
position ``pos`` before it attends over it.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import default_device, flags
from ..models.generation import init_kv_cache, sample_tokens


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.  ``temperature <= 0`` means greedy;
    ``top_k == 0`` means no top-k; ``top_p == 1.0`` means no top-p."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


@dataclasses.dataclass(eq=False)
class Request:
    """A queued generation request (created by ``submit``)."""

    request_id: int
    prompt: np.ndarray                 # (plen,) int32
    max_new_tokens: int
    sampling: SamplingParams
    t_submit: float = 0.0              # perf_counter at submit


@dataclasses.dataclass
class _Slot:
    rid: int
    remaining: int                     # new tokens still allowed
    t_first: float = 0.0               # perf_counter at first token (TPOT)


class _Hist:
    """A latency series: observations kept, percentiles exact."""

    def __init__(self):
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def summary(self) -> Dict[str, float]:
        d = {"count": len(self.values)}
        if self.values:
            a = np.asarray(self.values)
            d["mean"] = round(float(a.mean()), 3)
            for q, k in ((50, "p50"), (90, "p90"), (99, "p99")):
                d[k] = round(float(np.percentile(a, q)), 3)
        return d


# constructor arguments of the reference engine that this slice does not
# take: name -> (values that mean the default, ROADMAP item)
_UNSUPPORTED = {
    "paged": ((None, False), "A6.1 (paged KV cache + prefix cache)"),
    "block_len": ((None,), "A6.1 (paged KV cache)"),
    "num_blocks": ((None,), "A6.1 (paged KV cache)"),
    "prefix_cache": ((None, True), "A6.1 (prefix cache)"),
    "chunked": ((None, False), "A6.2 (chunked prefill)"),
    "prefill_chunk": ((None,), "A6.2 (chunked prefill)"),
    "chunk_policy": ((None, "prefill"), "A6.2 (chunked prefill)"),
    "spec_decode": ((None, False), "A6.3 (speculative decode)"),
    "spec_k": ((None,), "A6.3 (speculative decode)"),
    "drafter": ((None,), "A6.3 (speculative decode)"),
    "draft_model": ((None,), "A6.3 (speculative decode)"),
    "kv_cache_dtype": ((None, "bf16"), "A6.4 (int8 KV cache)"),
    "int8_weights": ((None, False), "A6.5 (int8 weights)"),
    "preempt": ((None, "off"), "A6.6 (preemption + host tier)"),
    "host_blocks": ((None, 0), "A6.6 (preemption + host tier)"),
    "mesh": ((None,), "A9 (multi-GPU serving)"),
}
# the serving flags whose non-default values select those modes
_FLAG_DEFAULTS = {
    "serving_paged_kv": (False, "A6.1"),
    "serving_chunked_prefill": (False, "A6.2"),
    "serving_spec_decode": (False, "A6.3"),
    "serving_kv_cache_dtype": ("bf16", "A6.4"),
    "serving_int8_weights": (False, "A6.5"),
}


class ServingEngine:
    """Continuous-batching serving over a causal LM with the stacked KV
    cache (``decode_step`` + ``init_kv_cache`` layout).

    ``device`` defaults to the card and must be where the model lives.
    Sampling draws from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, model, num_slots: int = 8, max_length: int = 1024,
                 eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                 prefill_batch: int = 4, seed: int = 0, *, device=None,
                 **unsupported):
        for name, value in unsupported.items():
            if name not in _UNSUPPORTED:
                raise TypeError(f"ServingEngine got an unexpected keyword "
                                f"argument {name!r}")
            defaults, item = _UNSUPPORTED[name]
            if value not in defaults:
                raise NotImplementedError(
                    f"ServingEngine({name}={value!r}) is ROADMAP {item}")
        for name, (default, item) in _FLAG_DEFAULTS.items():
            if flags.flag(name) != default:
                raise NotImplementedError(
                    f"FLAGS_{name}={flags.flag(name)!r} is ROADMAP {item}")
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
        self.num_slots = int(num_slots)
        self.max_length = int(max_length)
        self.eos_token_id = eos_token_id
        self.pad_token_id = int(pad_token_id)
        self.prefill_batch = int(prefill_batch)
        with torch.no_grad():
            self._cache = init_kv_cache(self.config, self.num_slots,
                                        self.max_length, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

        # host-side mirrors of the step inputs (uploaded per tick)
        s = self.num_slots
        self._tokens = np.zeros((s,), np.int32)
        self._positions = np.zeros((s,), np.int32)
        self._active = np.zeros((s,), bool)
        self._temps = np.zeros((s,), np.float32)
        self._topk = np.zeros((s,), np.int32)
        self._topp = np.ones((s,), np.float32)

        self._slots: List[Optional[_Slot]] = [None] * s
        self._queue: Deque[Request] = collections.deque()
        self._results: Dict[int, List[int]] = {}
        self._next_rid = 0
        self._ticks = 0
        self._clock = time.perf_counter
        self._init_metrics()

    # -- metrics -------------------------------------------------------------

    def _init_metrics(self):
        self._m_queue_wait = _Hist()
        self._m_ttft = _Hist()
        self._m_tpot = _Hist()
        self._m_step_ms = _Hist()
        self._m_prefill_ms = _Hist()
        self._n_submitted = 0
        self._n_finished = 0
        self._n_tokens = 0
        self._n_waves = 0
        self._n_decode_ticks = 0
        self._occupancy = 0.0
        self._retired: Dict[str, int] = collections.Counter()

    def metrics(self) -> Dict[str, object]:
        """The reference engine's key names for what this slice counts:
        latency percentiles (ms), occupancy, request/token/wave counters,
        plus ``ticks`` (scheduler ticks that dispatched work: waves and
        decode steps) and ``decode_ticks``."""
        return {"ttft_ms": self._m_ttft.summary(),
                "tpot_ms": self._m_tpot.summary(),
                "queue_wait_ms": self._m_queue_wait.summary(),
                "decode_step_ms": self._m_step_ms.summary(),
                "prefill_wave_ms": self._m_prefill_ms.summary(),
                "slot_occupancy": round(self._occupancy, 3),
                "requests_submitted": self._n_submitted,
                "requests_finished": self._n_finished,
                "tokens_generated": self._n_tokens,
                "prefill_waves": self._n_waves,
                "ticks": self._ticks,
                "decode_ticks": self._n_decode_ticks,
                "retired": dict(self._retired)}

    # -- public API ------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               sampling: Optional[SamplingParams] = None) -> int:
        """Enqueue a request; returns its id.  Admission happens inside
        ``step()`` as slots free up (FIFO).  Raises ``ValueError`` for an
        empty prompt (``bad_prompt``), ``max_new_tokens < 1``
        (``bad_max_new_tokens``) or a request longer than ``max_length``
        (``too_long``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.max_length:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the engine's max_length "
                f"({self.max_length})")
        rid = self._next_rid
        self._next_rid += 1
        self._results[rid] = []
        self._queue.append(Request(rid, prompt, int(max_new_tokens),
                                   sampling or SamplingParams(),
                                   t_submit=self._clock()))
        self._n_submitted += 1
        return rid

    def step(self) -> List[int]:
        """One scheduler tick: admit queued requests into free slots
        (batched prefill waves), then ONE decode step over the slot batch.
        Returns the request ids finished this tick.  Idle ticks return at
        once."""
        if not self._queue and not self._active.any():
            self._occupancy = 0.0
            return []
        with torch.no_grad():
            return self._step_inner()

    def drain(self) -> List[Tuple[int, List[int]]]:
        """Run ticks until every submitted request completes; returns
        ``[(request_id, generated_tokens)]`` in arrival order (outputs end
        at EOS inclusive)."""
        while self._queue or any(s is not None for s in self._slots):
            self.step()
        return [(rid, list(toks))
                for rid, toks in sorted(self._results.items())]

    def result(self, rid: int) -> List[int]:
        """Tokens generated so far for ``rid`` (complete once finished)."""
        return list(self._results[rid])

    @property
    def num_active(self) -> int:
        return self.num_slots - self._slots.count(None)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # -- device work -------------------------------------------------------------

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                topk: np.ndarray, topp: np.ndarray) -> np.ndarray:
        """Next tokens for a batch of rows, fetched to the host (the
        tick's one synchronisation).  All-greedy batches take the argmax
        alone — exactly what :func:`sample_tokens` returns for rows with
        ``temperature <= 0`` — so the sampling pass runs only when some
        row samples."""
        if not (temps > 0).any():
            nxt = logits.argmax(dim=-1)
        else:
            dev = logits.device
            nxt = sample_tokens(logits, torch.from_numpy(temps).to(dev),
                                torch.from_numpy(topk).to(dev),
                                torch.from_numpy(topp).to(dev),
                                generator=self._gen)
        return nxt.to(torch.int32).cpu().numpy()

    def _decode(self) -> np.ndarray:
        """One decode step for ALL slots: row i holds its request at
        position ``positions[i]``; inactive rows decode the pad token at
        position 0 and their token is discarded."""
        dev = self.device
        tokens = torch.from_numpy(self._tokens).to(dev)
        positions = torch.from_numpy(self._positions).to(dev)
        logits, self._cache = self.model.decode_step(
            tokens[:, None], self._cache, positions)
        nxt = self._sample(logits[:, -1], self._temps, self._topk,
                           self._topp)
        nxt[~self._active] = self.pad_token_id
        return nxt

    def _prefill(self, ids: np.ndarray, plens: np.ndarray,
                 slot_ids: List[int], temps, topk, topp) -> np.ndarray:
        """Prefill one admission wave: run the (n, bucket) prompts through
        the ``pos=0`` path (flash attention) on a bucket-long scratch
        cache, write the real rows into their slots, and sample each row's
        first token from the logits at its LAST REAL position (logits are
        computed at those positions only)."""
        dev = self.device
        n, bucket = ids.shape
        sub = init_kv_cache(self.config, n, bucket, device=dev)
        hidden, sub = self.model.model.decode(
            torch.from_numpy(ids).to(dev), sub, 0)
        last = hidden[torch.arange(n, device=dev),
                      torch.from_numpy(plens - 1).to(dev).long()]
        logits = self.model.logits(last)
        self._cache[:, :, torch.tensor(slot_ids, device=dev), :bucket] = sub
        return self._sample(logits, temps, topk, topp)

    # -- scheduler ------------------------------------------------------------------

    def _step_inner(self) -> List[int]:
        finished = self._admit()
        occ = int(self._active.sum())
        self._occupancy = occ / self.num_slots if self.num_slots else 0.0
        if not occ:
            return finished
        self._ticks += 1
        self._n_decode_ticks += 1
        t0 = self._clock()
        nxt = self._decode()
        now = self._clock()
        self._m_step_ms.observe((now - t0) * 1e3)
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
            self._n_tokens += 1
            reason = self._finish_reason(tok, slot, i)
            if reason is not None:
                finished.append(slot.rid)
                self._retire(slot, i, reason, now)
        return finished

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
        per contiguous FIFO run sharing a bucket.  Returns ids that
        finished AT admission (first token was EOS / max_new_tokens=1)."""
        finished: List[int] = []
        while self._queue:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                break
            bucket = min(self._bucket(len(self._queue[0].prompt)),
                         self.max_length)
            wave: List[Request] = []
            while (self._queue
                   and len(wave) < min(self.prefill_batch, len(free))
                   and min(self._bucket(len(self._queue[0].prompt)),
                           self.max_length) == bucket):
                wave.append(self._queue.popleft())
            finished.extend(self._prefill_wave(wave, free[:len(wave)],
                                               bucket))
        return finished

    def _prefill_wave(self, wave: List[Request], slots: List[int],
                      bucket: int) -> List[int]:
        t_adm = self._clock()
        n = len(wave)
        ids = np.full((n, bucket), self.pad_token_id, np.int32)
        plens = np.ones((n,), np.int32)
        temps = np.zeros((n,), np.float32)
        topk = np.zeros((n,), np.int32)
        topp = np.ones((n,), np.float32)
        for r, req in enumerate(wave):
            ids[r, :req.prompt.size] = req.prompt
            plens[r] = req.prompt.size
            temps[r] = req.sampling.temperature
            topk[r] = req.sampling.top_k
            topp[r] = req.sampling.top_p
            self._m_queue_wait.observe((t_adm - req.t_submit) * 1e3)
        self._n_waves += 1
        self._ticks += 1
        tok = self._prefill(ids, plens, slots, temps, topk, topp)
        t_tok = self._clock()
        self._m_prefill_ms.observe((t_tok - t_adm) * 1e3)
        finished: List[int] = []
        for r, (req, si) in enumerate(zip(wave, slots)):
            slot = _Slot(req.request_id, req.max_new_tokens - 1,
                         t_first=t_tok)
            self._slots[si] = slot
            self._active[si] = True
            self._tokens[si] = tok[r]
            self._positions[si] = plens[r]
            self._temps[si] = temps[r]
            self._topk[si] = topk[r]
            self._topp[si] = topp[r]
            self._results[req.request_id].append(int(tok[r]))
            self._n_tokens += 1
            self._m_ttft.observe((t_tok - req.t_submit) * 1e3)
            reason = self._finish_reason(int(tok[r]), slot, si)
            if reason is not None:
                finished.append(req.request_id)
                self._retire(slot, si, reason, t_tok)
        return finished

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
        """TPOT readout at retirement (decode time per token after the
        first), then release the slot."""
        n = len(self._results[slot.rid])
        if n > 1 and slot.t_first > 0.0:
            self._m_tpot.observe((now - slot.t_first) * 1e3 / (n - 1))
        self._n_finished += 1
        self._retired[reason] += 1
        self._release(i)

    def _release(self, i: int):
        self._clear_slot(i)

    def _clear_slot(self, i: int):
        """Reset slot ``i``'s host mirrors: the row decodes the pad token
        at position 0 until a new request takes it."""
        self._slots[i] = None
        self._active[i] = False
        self._tokens[i] = self.pad_token_id
        self._positions[i] = 0
        self._temps[i] = 0.0
        self._topk[i] = 0
        self._topp[i] = 1.0
