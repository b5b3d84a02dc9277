"""Drafters for speculative decoding (mirrors
``paddle_tpu/serving/drafter.py``), behind one :class:`Drafter` interface.

The speculative engine asks a drafter for up to k tokens a slot a tick
and scores them all in one verify step (``step_graph.VerifyStep``).  Two
proposers:

  * :class:`NgramDrafter` — prompt lookup / n-gram self-drafting: host
    numpy over each slot's history; it only restates spans already in the
    history.  Its proposal distribution is the one-hot at each draft (a
    deterministic proposer), which the engine builds on the device when a
    sampled row needs it;
  * :class:`DraftModelDrafter` — a small draft model (Leviathan et al.
    2023; :func:`paddle_tpu_torch.models.draft_model_from` truncates the
    target) with its own contiguous KV cache and two steps built once each
    (``step_graph.DraftStep``, ``step_graph.IngestStep``; CUDA graphs on
    the card), proposing k tokens for the whole slot batch in one call and
    returning the proposal distribution q on the device.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["Drafter", "NgramDrafter", "DraftModelDrafter"]

# labels of drafters built without an engine id: their build budgets are
# their own
_DRAFTER_IDS = itertools.count()
# history tokens a row the ingest step writes at least (the reference's
# default ``ingest_width``; at least k + 1)
INGEST_WIDTH = 16


class Drafter:
    """Interface both proposers implement.  ``kind`` labels the spec
    counters' ``by_drafter`` axis; host proposers implement
    :meth:`propose` (a slot at a time), device proposers
    :meth:`propose_batch` (the whole slot batch) — the engine dispatches
    on ``uses_device``."""

    kind: str = "custom"
    uses_device: bool = False

    def propose(self, history) -> np.ndarray:
        """Draft tokens following ``history``: int32 (m,), 0 <= m <= k;
        empty means "no proposal — the row decodes plain"."""
        raise NotImplementedError

    def reset_slot(self, i: int) -> None:
        """Forget any per-slot state (slot ``i`` was (re)assigned)."""


class NgramDrafter(Drafter):
    """Prompt-lookup proposer: match the history's tail n-gram against its
    own earlier occurrences and propose the tokens that followed.

    For ``n = max_ngram .. min_ngram`` (longest first), find the MOST
    RECENT earlier occurrence of the last ``n`` tokens; on a hit propose
    the (up to) ``k`` tokens that followed it.  No hit at any n: no
    proposal.  Every draft is lifted verbatim from the history."""

    kind = "ngram"

    def __init__(self, k: int, max_ngram: int = 3, min_ngram: int = 1):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]")
        self.k = int(k)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history) -> np.ndarray:
        """Draft tokens following ``history`` (prompt + generated so far,
        the last entry the token about to be fed).  Returns int32 (m,),
        ``0 <= m <= k``."""
        h = np.asarray(history, np.int64).ravel()
        n_hi = min(self.max_ngram, h.size - 1)
        for n in range(n_hi, self.min_ngram - 1, -1):
            tail = h[h.size - n:]
            # every length-n window; the last one is the tail itself
            win = np.lib.stride_tricks.sliding_window_view(h, n)
            hits = np.flatnonzero((win[:-1] == tail).all(axis=1))
            if hits.size:
                i = int(hits[-1])
                return h[i + n:i + n + self.k].astype(np.int32)
        return np.zeros((0,), np.int32)


class DraftModelDrafter(Drafter):
    """Draft-model proposer: ``model`` (a port causal LM; the target itself
    for self-drafting, or :func:`~paddle_tpu_torch.models.draft_model_from`)
    proposes k tokens a slot a tick with their proposal distribution q.

      * its KV cache is one contiguous ``(L_draft, 2, num_slots,
        max_length, Hkv, D)`` tensor in the model dtype, allocated on
        first use: a row holds the committed stream plus this tick's
        speculation, whose stale cells are rewritten before any later
        query reads them;
      * two steps, each built once on first use (budget 1 under
        ``serving.draft_step`` / ``serving.draft_prefill``; on the card a
        CUDA graph each, unless ``eager``): the draft step (a window of up
        to k + 1 caught-up tokens, then k - 1 one-token steps) and the
        ingest step, ``max(INGEST_WIDTH, k + 1)`` tokens a row, which
        drains a longer backlog first (a new prompt catches up through
        it);
      * rows with nothing to do sit at ``start = max_length``, whose
        writes drop;
      * ``consumed`` counts committed history only, so a rejected draft
        needs no undo: the next window starts at the committed frontier.

    Greedy rows (``temps <= 0``) take the argmax; a sampled row draws from
    the softmax of the UNTEMPERED draft logits, which is also its q (the
    reference's convention, ``drafter.py:199-207``).  The draws come from
    the caller's generator: Gumbel noise filled into the draft step's
    static buffer outside the graph, on ticks where some row samples."""

    kind = "model"
    uses_device = True

    def __init__(self, k: int, model, num_slots: int, max_length: int,
                 pad_token_id: int = 0, engine_id=None, device=None,
                 eager: Optional[bool] = None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self.model = model
        self.num_slots = int(num_slots)
        self.max_length = int(max_length)
        self.pad_token_id = int(pad_token_id)
        self.ingest_width = max(INGEST_WIDTH, self.k + 1)
        self.device = (torch.device(device) if device is not None
                       else next(model.parameters()).device)
        # the steps' build counters are labelled with the engine's id
        self._eid = (engine_id if engine_id is not None
                     else f"drafter{next(_DRAFTER_IDS)}")
        self._eager = eager
        self._consumed = np.zeros((self.num_slots,), np.int64)
        self._cache = None
        self._draft = None
        self._ingest = None
        self._noisy = False            # the noise buffer holds draws
        # runs of each step (replays, or eager runs), for launch accounting
        self.draft_runs = 0
        self.ingest_runs = 0

    def reset_slot(self, i: int) -> None:
        self._consumed[i] = 0

    @property
    def draft_traces(self) -> int:
        """Builds of the draft step (budget 1; 0 before first use)."""
        return self._draft.traces if self._draft is not None else 0

    @property
    def ingest_traces(self) -> int:
        """Builds of the ingest step (budget 1; 0 before first use)."""
        return self._ingest.traces if self._ingest is not None else 0

    @property
    def graphed(self) -> bool:
        return self._draft is not None and self._draft.graphed \
            and self._ingest.graphed

    def _build(self) -> None:
        """First use: allocate the draft cache and build both steps on
        all-idle inputs (every row at ``max_length``: nothing written)."""
        from ..models.generation import init_kv_cache
        from .step_graph import DraftStep, IngestStep

        with torch.no_grad():
            self._cache = init_kv_cache(self.model.config, self.num_slots,
                                        self.max_length, device=self.device)
        self._draft = DraftStep(self.model, self._cache, self.num_slots,
                                self.k, self.device, self._eid,
                                eager=self._eager)
        self._ingest = IngestStep(self.model, self._cache, self.num_slots,
                                  self.ingest_width, self.device, self._eid,
                                  eager=self._eager)
        for st in (self._draft, self._ingest):
            st.window_host[:] = self.pad_token_id
            st.start_host[:] = self.max_length
            st.build()

    def propose_batch(self, histories: Dict[int, np.ndarray], temps,
                      generator: Optional[torch.Generator] = None):
        """One tick's proposals for the slots in ``histories`` (slot ->
        int32 committed stream, the last entry the token about to be fed).
        ``temps``: the engine's (S,) temperatures.  Returns ``(drafts
        (S, k) int32, q (S, k, V) float32)`` on the device, over the whole
        slot batch (rows absent from ``histories`` are junk) — the draft
        step's static outputs, overwritten by its next run."""
        if self._draft is None:
            self._build()
        s, k = self.num_slots, self.k
        ing = self._ingest
        while True:
            over = {i: h for i, h in histories.items()
                    if h.size - self._consumed[i] > k + 1}
            if not over:
                break
            ing.window_host[:] = self.pad_token_id
            ing.start_host[:] = self.max_length
            for i, h in over.items():
                c = int(self._consumed[i])
                n = min(self.ingest_width, h.size - c - (k + 1))
                ing.window_host[i, :n] = h[c:c + n]
                ing.start_host[i] = c
                self._consumed[i] = c + n
            # the next iteration rewrites the staging at once
            ing.run(non_blocking=False)
            self.ingest_runs += 1
        dr = self._draft
        dr.window_host[:] = self.pad_token_id
        dr.start_host[:] = self.max_length
        dr.nvalid_host[:] = 0
        for i, h in histories.items():
            c = int(self._consumed[i])
            n = h.size - c                        # 1 .. k + 1 by the drain
            dr.window_host[i, :n] = h[c:]
            dr.start_host[i] = c
            dr.nvalid_host[i] = n
            self._consumed[i] = h.size
        temps = np.asarray(temps, np.float32)
        sampled = np.zeros((s,), bool)
        for i in histories:
            sampled[i] = temps[i] > 0
        if sampled.any():
            # Gumbel noise -log(-log(u)) for the sampled rows (u clamped
            # off 0, so every draw is finite), zero for the rest
            noise = dr.noise
            noise.uniform_(generator=generator).clamp_(
                min=torch.finfo(torch.float32).tiny)
            noise.log_().neg_().log_().neg_()
            keep = torch.from_numpy(sampled).to(self.device)
            noise.masked_fill_(~keep[:, None, None], 0.0)
            self._noisy = True
        elif self._noisy:
            dr.noise.zero_()
            self._noisy = False
        self.draft_runs += 1
        return dr.run()
