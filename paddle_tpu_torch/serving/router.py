"""Data-parallel replica router: N ServingEngines behind one ``submit()``
(mirrors ``paddle_tpu/serving/router.py``).

Each replica is an independent engine with its own KV cache, block pool,
scheduler and, on the card, its own CUDA graphs; replicas built from one
model share its weights on the device (an engine reads the model's
tensors where they live and neither moves nor casts them).  Aggregate
tok/s is the sum of the replicas' committed tokens, and the placement
policy is what keeps that sum high:

  * **prefix affinity** (the default, ``FLAGS_serving_router_policy``):
    paged replicas expose a READ-ONLY trie probe
    (:meth:`~paddle_tpu_torch.serving.kv_cache.BlockManager.prefix_probe`)
    and the router sends a prompt to the replica holding its longest
    cached full-block prefix, so a shared system prompt is computed once
    on one replica and a tenant's later requests land on the warm trie.
    With no full-block match anywhere (cold start, empty tries,
    contiguous engines) placement falls back to **least-loaded**: queued
    requests plus pending prefill chunks plus pending prefills first,
    busy slots as the tiebreak;
  * **session affinity** overrides every policy: a session's first
    request pins it to its replica and every later request lands there
    (decode never migrates, even while an earlier turn is still
    chunk-prefilling);
  * **failover**: ``submit()`` walks the replicas in placement order; a
    replica whose admission rejects the request outright (``ValueError``:
    too long, or a pool too small for the worst case) is skipped and the
    next candidate takes it (``router.submit_failovers``).  Only when
    every replica rejects does the error propagate.  The request log's
    uid is minted here, once, and threaded through every attempt.

**Predictive admission** (``FLAGS_serving_admission="predictive"``):
each candidate is priced first against its cost model
(:func:`~paddle_tpu_torch.serving.admission.place_verdict`); the first
that fits takes the request.  When none fits, the request is parked in
the priced :class:`~paddle_tpu_torch.serving.admission.HoldQueue` and
``step()`` retries its placement each tick (entries older than
``FLAGS_serving_admission_max_defer_ticks`` are placed whatever the
prediction says).  The gate disarms when ``FLAGS_perf_model`` is off or
any live replica's model carries a drift finding.  Decisions count in
``router.admission_decision{verdict=admit|defer|reject}``, predictions
in the ``router.predicted_tpot_ms`` gauges.

**Elasticity** (the autoscaler's surface): :meth:`add_replica` grows the
fleet mid-flight, :meth:`drain_replica` takes a replica out of new
placements (pinned sessions still land there) and :meth:`retire_replica`
removes an EMPTY drained replica from the tick loop (its index stays
allocated, so router rids stay valid).

Scheduling is a round-robin tick loop on one host thread: ``step()``
services the hold queue, then ticks every live replica once (an idle
replica's tick returns at once and launches nothing).  On one card the
replicas' ticks run one after another (each ends in its one token fetch);
the loop form keeps tests and traces deterministic.  Every series is
labelled ``router=<id>`` (and ``replica=``, ``route=``) in the shared
registry; :meth:`metrics` returns the replicas' snapshots and the pooled
aggregates (summed tokens, the pooled prefix hit rate).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import flags as _flags
from .. import observability as _obs
from .admission import HoldQueue, place_verdict
from .engine import SamplingParams, ServingEngine

__all__ = ["ReplicaRouter"]

_ROUTER_IDS = itertools.count()


class ReplicaRouter:
    """N data-parallel ServingEngine replicas behind one ``submit()``.

    ``ReplicaRouter(model, num_replicas=2, **engine_kwargs)`` builds the
    replicas (``num_replicas`` defaults to ``FLAGS_serving_dp_replicas``;
    ``engine_kwargs``, ``device`` included, go to every engine).  Pass
    ``engines=[...]`` instead to route over pre-built, possibly
    heterogeneous engines."""

    def __init__(self, model=None, num_replicas: Optional[int] = None,
                 *, engines: Optional[List[ServingEngine]] = None,
                 policy: Optional[str] = None, **engine_kwargs):
        self.policy = str(policy or _flags.flag("serving_router_policy"))
        if self.policy not in ("prefix", "least_loaded", "round_robin"):
            raise ValueError(
                f"policy must be 'prefix', 'least_loaded' or "
                f"'round_robin', got {self.policy!r}")
        self._factory: Optional[Callable[[], ServingEngine]] = None
        if engines is not None:
            if model is not None or engine_kwargs:
                raise ValueError(
                    "pass either engines=[...] or a model (+kwargs), "
                    "not both")
            self.engines = list(engines)
        else:
            if model is None:
                raise ValueError("a model (or engines=[...]) is required")
            n = int(num_replicas or _flags.flag("serving_dp_replicas"))
            if n < 1:
                raise ValueError(f"num_replicas must be >= 1, got {n}")
            self._factory = lambda: ServingEngine(model, **engine_kwargs)
            self.engines = [self._factory() for _ in range(n)]
        if not self.engines:
            raise ValueError("at least one replica is required")
        self._rid = itertools.count()
        # router rid -> (replica, engine rid); _order is arrival order
        # (drain() returns it; a held request keeps its arrival place)
        self._placed: Dict[int, Tuple[int, int]] = {}
        self._order: List[int] = []
        # replica -> {engine rid -> router rid}: step() resolves finished
        # ids through it in O(1)
        self._by_engine: Dict[int, Dict[int, int]] = {
            i: {} for i in range(len(self.engines))}
        self._affinity: Dict[object, int] = {}      # session -> replica
        self._rr = 0                                # round-robin cursor
        self._hold = HoldQueue()
        self._draining: Set[int] = set()
        self._retired: Set[int] = set()
        reg = _obs.default_registry()
        self._router_id = str(next(_ROUTER_IDS))
        self._rlog = _obs.get_request_log()
        self._uids: Dict[int, int] = {}     # router rid -> lifecycle uid
        lbl = {"router": self._router_id}
        self._m_requests = reg.counter(
            "router.requests",
            "requests placed, by replica and route (prefix = warm-trie "
            "match, affinity = session pin, least_loaded / round_robin "
            "= the fallbacks)")
        self._m_failovers = reg.counter(
            "router.submit_failovers",
            "submissions retried on another replica after the chosen "
            "one rejected admission outright").labels(**lbl)
        self._m_prefix_tokens = reg.counter(
            "router.prefix_routed_tokens",
            "prompt tokens the placement probe found already cached on "
            "the chosen replica at submit time").labels(**lbl)
        self._f_admission = reg.counter(
            "router.admission_decision",
            "control-plane placement decisions by verdict: admit (a "
            "replica took the request), defer (every candidate priced "
            "over the SLO — parked in the hold queue), reject (a "
            "replica's admission refused outright)")
        self._f_pred_tpot = reg.gauge(
            "router.predicted_tpot_ms",
            "last cost-model predicted post-admission TPOT per replica "
            "(calibrated wall ms), refreshed at every predictive "
            "placement probe")
        self._g_held = reg.gauge(
            "router.held_requests",
            "requests currently parked in the predictive hold "
            "queue").labels(**lbl)

    # -- placement -----------------------------------------------------------

    @property
    def num_replicas(self) -> int:
        return len(self.engines)

    @property
    def live_replicas(self) -> List[int]:
        """Indices still in the tick loop (not retired)."""
        return [i for i in range(len(self.engines))
                if i not in self._retired]

    @property
    def pending_held(self) -> int:
        """Requests parked in the hold queue (``loadgen.replay``'s
        ``busy()`` counts them, or a replay would stop early)."""
        return len(self._hold)

    @staticmethod
    def _load(eng: ServingEngine) -> Tuple[int, int]:
        """A replica's load for the least-loaded fallback: queued requests
        plus pending prefills plus pending prefill chunks first, busy
        slots as the tiebreak."""
        return (eng.queue_depth + eng.num_pending + eng.pending_chunks,
                eng.num_active)

    def _probe(self, eng: ServingEngine, prompt: np.ndarray) -> int:
        """Cached prefix tokens ``eng`` holds for ``prompt`` (0 for a
        contiguous replica or one without a prefix cache)."""
        if not eng.paged:
            return 0
        return int(eng.kv.prefix_probe(prompt))

    def _placement_order(self, prompt: np.ndarray,
                         session) -> List[Tuple[int, str, int]]:
        """Candidate replicas, best first, as ``(index, route, warm)``;
        failover walks the list in order.  Retired replicas never appear;
        draining replicas only for their pinned sessions."""
        idx = [i for i in range(len(self.engines))
               if i not in self._retired and i not in self._draining]
        if session is not None and session in self._affinity:
            pin = self._affinity[session]
            if pin in self._retired:
                # the pinned replica is gone: the session re-pins cold
                del self._affinity[session]
            else:
                rest = sorted((i for i in idx if i != pin),
                              key=lambda i: self._load(self.engines[i]))
                return ([(pin, "affinity",
                          self._probe(self.engines[pin], prompt))]
                        + [(i, "least_loaded", 0) for i in rest])
        if not idx:
            # every live replica drains: placement still makes progress
            idx = self.live_replicas
        if self.policy == "round_robin":
            r = self._rr % len(idx)
            order = idx[r:] + idx[:r]
            self._rr = (self._rr + 1) % len(idx)
            return [(i, "round_robin", 0) for i in order]
        loads = {i: self._load(self.engines[i]) for i in idx}
        by_load = sorted(idx, key=lambda i: loads[i])
        if self.policy == "least_loaded":
            return [(i, "least_loaded", 0) for i in by_load]
        # prefix: the longest warm match wins (load breaks ties); replicas
        # without a full-block match rank by load behind every warm one
        warm = {i: self._probe(self.engines[i], prompt) for i in idx}
        order = sorted(idx, key=lambda i: (-warm[i], loads[i]))
        return [(i, "prefix" if warm[i] else "least_loaded", warm[i])
                for i in order]

    def _predictive_armed(self) -> bool:
        """The gate arms only when every live replica's model is
        trustworthy: one drifting replica cannot rank candidates."""
        if str(_flags.flag("serving_admission")) != "predictive":
            return False
        live = [self.engines[i] for i in self.live_replicas]
        return bool(live) and all(e.admission_armed() for e in live)

    def _register(self, i: int, route: str, warm: int, session,
                  uid: int, erid: int, rid: Optional[int] = None) -> int:
        """Book one placement (fresh or from the hold queue): the rid
        maps, the lifecycle event, the series."""
        if rid is None:
            rid = next(self._rid)
            self._order.append(rid)
        self._placed[rid] = (i, erid)
        self._by_engine[i][erid] = rid
        self._uids[rid] = uid
        self._rlog.event(uid, "placed", router=self._router_id,
                         replica=str(i), route=route,
                         warm_tokens=int(warm))
        if session is not None:
            self._affinity.setdefault(session, i)
        self._m_requests.labels(router=self._router_id,
                                replica=str(i), route=route).inc()
        if warm:
            self._m_prefix_tokens.inc(int(warm))
        self._f_admission.labels(router=self._router_id,
                                 verdict="admit").inc()
        return rid

    def _try_place(self, prompt: np.ndarray, max_new_tokens: int,
                   sampling: Optional[SamplingParams], session,
                   priority: int, uid: int, *,
                   slo_ttft: float, slo_tpot: float,
                   rid: Optional[int] = None,
                   gate: bool = True) -> Tuple[Optional[int],
                                               Optional[Exception],
                                               float, int]:
        """One walk of the placement order.  With ``gate`` (and the gate
        armed) each candidate is priced first and over-SLO candidates are
        skipped.  ``slo_ttft`` / ``slo_tpot`` are the deadlines taken at
        the router's submit: they price the placement and stamp the
        engine's request, so a retry from the hold queue carries the
        deadlines it arrived with.  Returns ``(rid, last_err, price,
        deferrals)``; rid None means nothing was placed."""
        armed = gate and self._predictive_armed()
        last_err: Optional[Exception] = None
        price = 0.0
        deferrals = 0
        for i, route, warm in self._placement_order(prompt, session):
            if armed:
                v = place_verdict(self.engines[i], int(prompt.size),
                                  ttft_slo_ms=slo_ttft,
                                  tpot_slo_ms=slo_tpot)
                self._f_pred_tpot.labels(
                    router=self._router_id,
                    replica=str(i)).set(v.predicted_tpot_ms)
                if v.verdict != "admit":
                    deferrals += 1
                    price = min(price, v.price) if deferrals > 1 \
                        else v.price
                    continue
            try:
                erid = self.engines[i].submit(
                    prompt, max_new_tokens=max_new_tokens,
                    sampling=sampling, request_uid=uid,
                    priority=priority, ttft_slo_ms=slo_ttft,
                    tpot_slo_ms=slo_tpot)
            except ValueError as e:
                # the replica's admission refused the request outright:
                # fail over to the next candidate
                last_err = e
                self._m_failovers.inc()
                self._f_admission.labels(router=self._router_id,
                                         verdict="reject").inc()
                continue
            return (self._register(i, route, warm, session, uid, erid,
                                   rid=rid), None, 0.0, deferrals)
        return (None, last_err, price, deferrals)

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               sampling: Optional[SamplingParams] = None,
               session=None, priority: int = 0) -> int:
        """Place and enqueue a request; returns the ROUTER request id.
        ``session`` (any hashable) pins this and every later request of
        the session to one replica.  ``priority`` goes to the replica's
        preemptive scheduler and orders the hold queue.  Under predictive
        admission a request every candidate prices over the SLO is parked,
        not rejected: its rid is valid at once and a later ``step()``
        places it.  Raises the last ``ValueError`` when every replica
        rejects the request outright."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        # one uid across every replica attempt: a rejecting replica's
        # "rejected" and the accepting one's "admitted" share a timeline
        uid = self._rlog.new_uid()
        slo_ttft = float(_flags.flag("serving_slo_ttft_ms"))
        slo_tpot = float(_flags.flag("serving_slo_tpot_ms"))
        self._rlog.event(
            uid, "submitted", router=self._router_id,
            prompt_len=int(prompt.size),
            max_new_tokens=int(max_new_tokens),
            ttft_slo_ms=slo_ttft, tpot_slo_ms=slo_tpot)
        rid, last_err, price, deferrals = self._try_place(
            prompt, max_new_tokens, sampling, session, priority, uid,
            slo_ttft=slo_ttft, slo_tpot=slo_tpot)
        if rid is not None:
            return rid
        if deferrals == 0:
            # every candidate rejected: nothing to hold
            raise last_err if last_err is not None else RuntimeError(
                "no replica accepted the request")
        rid = next(self._rid)
        self._order.append(rid)
        self._uids[rid] = uid
        self._hold.push(
            {"rid": rid, "uid": uid, "prompt": prompt,
             "max_new_tokens": int(max_new_tokens), "sampling": sampling,
             "session": session, "priority": int(priority),
             "slo_ttft": slo_ttft, "slo_tpot": slo_tpot},
            priority=priority, price=price)
        self._g_held.set(len(self._hold))
        self._f_admission.labels(router=self._router_id,
                                 verdict="defer").inc()
        self._rlog.event(uid, "held", router=self._router_id,
                         price_ms=round(price, 6),
                         priority=int(priority))
        return rid

    def _service_hold(self) -> None:
        """Retry placement of every held request, best first (aged,
        priority, price, arrival).  Aged entries bypass the gate; entries
        that still do not fit are re-priced in place; an entry every live
        replica rejects outright leaves the queue as ``rejected``
        (rejection is static infeasibility: a retry would wedge
        ``drain()``)."""
        if not len(self._hold):
            return
        for e in self._hold.ordered():
            p = e.payload
            rid, _, price, deferrals = self._try_place(
                p["prompt"], p["max_new_tokens"], p["sampling"],
                p["session"], p["priority"], p["uid"], rid=p["rid"],
                slo_ttft=p["slo_ttft"], slo_tpot=p["slo_tpot"],
                gate=not self._hold.aged(e))
            if rid is not None:
                self._hold.remove(e)
            elif deferrals:
                e.price = price
            else:
                self._hold.remove(e)
                self._order.remove(p["rid"])
                self._rlog.event(p["uid"], "rejected",
                                 router=self._router_id, stage="held")
                self._f_admission.labels(router=self._router_id,
                                         verdict="reject").inc()
        self._g_held.set(len(self._hold))

    def request_uid(self, rid: int) -> int:
        """The lifecycle uid behind router request ``rid``: one key into
        the request log across every replica the request touched."""
        return self._uids[rid]

    def cancel(self, rid: int) -> bool:
        """Cancel router request ``rid`` wherever it is (held before
        placement, queued, prefilling, decoding, awaiting a resume)
        through its replica's :meth:`ServingEngine.cancel`; ``False`` once
        it finished (its tokens stay in :meth:`result`).  ``KeyError`` for
        an unknown rid."""
        if rid not in self._placed:
            for e in self._hold:
                if e.payload["rid"] == rid:
                    self._hold.remove(e)
                    self._order.remove(rid)
                    self._rlog.event(self._uids[rid], "cancelled",
                                     router=self._router_id,
                                     stage="held")
                    self._g_held.set(len(self._hold))
                    return True
            raise KeyError(f"unknown router request id {rid}")
        i, erid = self._placed[rid]
        return self.engines[i].cancel(erid)

    # -- elasticity (the autoscaler's surface) -------------------------------

    def add_replica(self,
                    engine: Optional[ServingEngine] = None) -> int:
        """Grow the fleet by one replica mid-flight; returns its index.
        A router built from a model builds the engine itself; one built
        over pre-built engines must be handed one."""
        if engine is None:
            if self._factory is None:
                raise ValueError(
                    "router was built over pre-built engines — pass "
                    "engine= to add_replica")
            engine = self._factory()
        i = len(self.engines)
        self.engines.append(engine)
        self._by_engine[i] = {}
        self._rlog.event(self._rlog.new_uid(), "replica_added",
                         router=self._router_id, replica=str(i))
        return i

    def drain_replica(self, i: int) -> None:
        """Take replica ``i`` out of NEW placements; its queue keeps
        draining and pinned sessions keep landing."""
        if i in self._retired or not 0 <= i < len(self.engines):
            raise ValueError(f"replica {i} is not live")
        self._draining.add(i)

    def undrain_replica(self, i: int) -> None:
        """Return a draining (not yet retired) replica to service."""
        if i in self._retired:
            raise ValueError(f"replica {i} is already retired")
        self._draining.discard(i)

    def replica_empty(self, i: int) -> bool:
        eng = self.engines[i]
        return not (eng.queue_depth or eng.num_active or eng.num_pending
                    or eng.num_preempted)

    def retire_replica(self, i: int) -> None:
        """Remove an EMPTY replica from the tick loop.  Its index stays
        allocated; session pins to it are dropped.  Raises while it holds
        work (drain first) or when it is the last live replica."""
        if i in self._retired:
            return
        if not 0 <= i < len(self.engines):
            raise ValueError(f"replica {i} does not exist")
        if not self.replica_empty(i):
            raise RuntimeError(
                f"replica {i} still holds work — drain_replica() and "
                f"tick until empty before retiring")
        if len(self.live_replicas) <= 1:
            raise RuntimeError("cannot retire the last live replica")
        self._retired.add(i)
        self._draining.discard(i)
        for s in [s for s, ri in self._affinity.items() if ri == i]:
            del self._affinity[s]
        self._rlog.event(self._rlog.new_uid(), "replica_retired",
                         router=self._router_id, replica=str(i))

    # -- scheduling ----------------------------------------------------------

    def step(self) -> List[int]:
        """One round-robin tick: service the hold queue, then tick every
        live replica.  Returns the router rids finished this tick."""
        self._service_hold()
        finished: List[int] = []
        for i, eng in enumerate(self.engines):
            if i in self._retired:
                continue
            done = eng.step()
            if done:
                emap = self._by_engine[i]
                finished.extend(sorted(
                    emap.pop(erid) for erid in done if erid in emap))
        if len(self._hold):
            self._hold.tick()
        return finished

    def drain(self) -> List[Tuple[int, List[int]]]:
        """Tick until every live replica is empty and the hold queue is
        drained; returns ``[(router_rid, tokens)]`` in arrival order."""
        while (len(self._hold)
               or any(not self.replica_empty(i)
                      for i in self.live_replicas)):
            self.step()
        return [(rid, self.result(rid)) for rid in self._order]

    def result(self, rid: int) -> List[int]:
        i, erid = self._placed[rid]
        return self.engines[i].result(erid)

    def replica_of(self, rid: int) -> int:
        """The replica serving router request ``rid``."""
        return self._placed[rid][0]

    # -- telemetry -----------------------------------------------------------

    def metrics(self) -> Dict[str, object]:
        """The replicas' ``metrics()`` and the pooled aggregates: summed
        tokens and requests, failovers, prefix-routed tokens, the control
        plane's state and decisions, and (all replicas paged) the pooled
        prefix hit rate, summed hit tokens over summed admitted prompt
        tokens (not the mean of the replicas' rates)."""
        per = [eng.metrics() for eng in self.engines]
        agg: Dict[str, object] = {
            "replicas": len(self.engines),
            "policy": self.policy,
            "tokens_generated": sum(m["tokens_generated"] for m in per),
            "requests_submitted": sum(m["requests_submitted"]
                                      for m in per),
            "requests_finished": sum(m["requests_finished"] for m in per),
            "submit_failovers": int(self._m_failovers.value()),
            "prefix_routed_tokens": int(self._m_prefix_tokens.value())}
        agg["control_plane"] = {
            "admission": str(_flags.flag("serving_admission")),
            "predictive_armed": self._predictive_armed(),
            "held_requests": len(self._hold),
            "draining": sorted(self._draining),
            "retired": sorted(self._retired),
            "live_replicas": len(self.live_replicas),
            "decisions": {
                str(c.labels["verdict"]): int(c.value())
                for c in self._f_admission.children()
                if c.labels.get("router") == self._router_id}}
        if all(eng.paged for eng in self.engines):
            hits = sum(eng.kv.stats["prefix_hit_tokens"]
                       for eng in self.engines)
            total = sum(eng.prefill_tokens_total for eng in self.engines)
            agg["prefix_hit_rate_pooled"] = (round(hits / total, 3)
                                             if total else 0.0)
            agg["prefix_hit_rate_per_replica"] = [
                m["kv_cache"]["prefix_hit_rate"] for m in per]
        return {"aggregate": agg, "per_replica": per}
