"""The process-separated serving plane (mirrors
``paddle_tpu/serving/multihost/plane.py``): a router that talks to
:class:`~.worker.EngineWorker` s over :class:`~.transport.Transport`
handles instead of holding engines in its own process.

What carries over from the in-process :class:`~..router.ReplicaRouter`:

  * ONE lifecycle uid a request, minted plane-side at submit and threaded
    through every worker (``request_uid``): placement, admission
    failover, migration and worker-loss failover all append to the same
    timeline;
  * prefix-affinity placement through the read-only ``prefix_probe``
    RPC, session affinity (a session never moves while its worker
    lives), and admission failover: a worker whose engine rejects (the
    RPC surfaces the engine's ValueError as
    ``RpcError(kind='ValueError')``) moves placement to the next
    candidate.

What is new:

  * **worker loss is survivable**: a heartbeat ping every
    ``FLAGS_multihost_heartbeat_every`` plane ticks (counted in ticks,
    so loopback replays stay deterministic), and a transport error on any
    call, mark a worker lost; its requests in flight are admitted again
    on the survivors by resubmitting ``prompt + generated`` with the
    budget left: recompute from the prefix, at plane scope.  Greedy
    decode conditioned on the committed tokens continues the sequence,
    so at float32 the failover does not show in the output;
  * **disaggregated prefill / decode** (``policy='disagg'``): a new
    request lands on the prefill pool; once its first token surfaces its
    KV chain migrates by value (``export_request`` / ``import_request``
    over the transport) to the least-loaded decode worker, which finishes
    the request without running a prefill.  The migrated bytes are
    counted (``multihost.migration_bytes``): transport traffic, not KV
    the attention streams;
  * **per-tick token streaming**: ``step`` replies carry token deltas,
    which :meth:`MultiHostRouter.attach_stream` sinks receive the tick
    they surface (the front end's ``POST /v1/generate``).
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ... import flags as _flags
from ... import observability as _obs
from ...observability import federation as _fed
from ..engine import SamplingParams
from .transport import RpcError, Transport, TransportError

__all__ = ["MultiHostRouter"]

_PLANE_IDS = itertools.count()


class _Req:
    __slots__ = ("rid", "uid", "prompt", "max_new", "sampling", "priority",
                 "ttft_slo_ms", "tpot_slo_ms", "session", "worker", "wrid",
                 "generated", "done", "phase", "stream")

    def __init__(self, rid: int, uid: int, prompt: List[int], max_new: int,
                 sampling: Optional[SamplingParams], priority: int,
                 ttft_slo_ms: Optional[float], tpot_slo_ms: Optional[float],
                 session: Any):
        self.rid = rid
        self.uid = uid
        self.prompt = prompt
        self.max_new = max_new
        self.sampling = sampling
        self.priority = priority
        self.ttft_slo_ms = ttft_slo_ms
        self.tpot_slo_ms = tpot_slo_ms
        self.session = session
        self.worker: Optional[str] = None
        self.wrid: Optional[int] = None
        self.generated: List[int] = []
        self.done = False
        self.phase = "prefill"            # disagg: prefill -> decode
        self.stream: Optional[Callable[[Dict[str, Any]], None]] = None


class MultiHostRouter:
    """Router over named worker transports.

    ``policy``: ``'prefix'`` (warm-token affinity, then least loaded,
    then name order), ``'round_robin'``, or ``'disagg'`` (``prefill``
    names the prefill pool; every other worker is a decode worker).
    The surface matches what ``loadgen.replay`` drives: submit / step /
    result / cancel / drain plus the busy properties."""

    def __init__(self, transports: "OrderedDict[str, Transport]",
                 policy: str = "prefix",
                 prefill: Optional[Sequence[str]] = None,
                 heartbeat_every: Optional[int] = None):
        if policy not in ("prefix", "round_robin", "disagg"):
            raise ValueError(
                f"policy must be prefix|round_robin|disagg, got {policy!r}")
        self._workers: "OrderedDict[str, Transport]" = OrderedDict(
            transports)
        if not self._workers:
            raise ValueError("need at least one worker transport")
        self.policy = policy
        self._prefill_pool = list(prefill or [])
        if policy == "disagg":
            missing = [n for n in self._prefill_pool
                       if n not in self._workers]
            if missing or not self._prefill_pool:
                raise ValueError(
                    f"disagg policy needs a prefill pool drawn from the "
                    f"workers (missing: {missing})")
            if not [n for n in self._workers
                    if n not in self._prefill_pool]:
                raise ValueError("disagg policy needs >= 1 decode worker")
        self._hb_every = int(
            heartbeat_every if heartbeat_every is not None
            else _flags.flag("multihost_heartbeat_every"))
        self._dead: Dict[str, str] = {}         # name -> loss reason
        self._reqs: Dict[int, _Req] = {}
        self._by_worker: Dict[Tuple[str, int], int] = {}
        self._affinity: Dict[Any, str] = {}     # session -> worker name
        self._pending_imports: List[Tuple[int, Dict[str, Any]]] = []
        self._status: Dict[str, Dict[str, int]] = {}
        self._next_rid = 0
        self._rr = 0
        self._ticks = 0
        self._rlog = _obs.get_request_log()
        self._tracer = _obs.get_tracer()
        self._pid = str(next(_PLANE_IDS))
        reg = _obs.default_registry()
        lbl = {"plane": self._pid}
        self._m_migrations = reg.counter(
            "multihost.migrations",
            "requests migrated prefill -> decode worker").labels(**lbl)
        self._m_mig_bytes = reg.counter(
            "multihost.migration_bytes",
            "KV payload bytes moved across workers by migration "
            "(transport traffic, never streamed-KV bytes)").labels(**lbl)
        self._m_failovers = reg.counter(
            "multihost.failovers",
            "in-flight requests re-admitted after worker loss").labels(
                **lbl)
        self._m_lost = reg.counter(
            "multihost.workers_lost",
            "workers marked lost (heartbeat or call failure)").labels(
                **lbl)
        self._m_heartbeats = reg.counter(
            "multihost.heartbeats", "heartbeat pings issued").labels(**lbl)
        # fleet-health observability: per-worker heartbeat
        # age in plane ticks and loss classification by reason
        self._f_hb_age = reg.gauge(
            "plane.heartbeat_age_ticks",
            "plane ticks since the worker's last successful heartbeat")
        self._f_worker_lost = reg.counter(
            "plane.worker_lost",
            "workers marked lost, by reason "
            "(missed_heartbeat|transport_error)")
        self._last_hb_tick: Dict[str, int] = {n: 0 for n in self._workers}

    # -- roster --------------------------------------------------------

    @property
    def live_workers(self) -> List[str]:
        return [n for n in self._workers if n not in self._dead]

    @property
    def lost_workers(self) -> Dict[str, str]:
        return dict(self._dead)

    def _decode_pool(self) -> List[str]:
        return [n for n in self.live_workers
                if n not in self._prefill_pool]

    def _mark_lost(self, name: str, reason: str) -> None:
        if name in self._dead:
            return
        self._dead[name] = reason
        self._m_lost.inc()
        # one reason label per loss class: a missed heartbeat is the
        # silent kind, every other loss surfaced as a TransportError
        self._f_worker_lost.labels(
            plane=self._pid, worker=name,
            reason=("missed_heartbeat" if reason == "heartbeat_failed"
                    else "transport_error")).inc()
        self._status.pop(name, None)
        self._tracer.instant("multihost.worker_lost", worker=name,
                             reason=reason)
        for s in [s for s, w in self._affinity.items() if w == name]:
            del self._affinity[s]          # sessions re-pin cold
        self._failover_worker(name, reason)

    # -- placement -----------------------------------------------------

    def _load(self, name: str) -> int:
        st = self._status.get(name, {})
        return (int(st.get("queue_depth", 0)) + int(st.get("num_active", 0))
                + int(st.get("num_pending", 0))
                + int(st.get("num_preempted", 0)))

    def _candidates(self, prompt: List[int], session: Any) -> List[str]:
        if self.policy == "disagg":
            pool = [n for n in self._prefill_pool if n not in self._dead]
            # degrade gracefully: with the whole prefill pool gone the
            # decode workers take whole requests (colocated fallback)
            pool = pool or self.live_workers
        else:
            pool = self.live_workers
        if session is not None and session in self._affinity:
            pin = self._affinity[session]
            if pin in pool:
                return [pin] + [n for n in pool if n != pin]
            del self._affinity[session]
        if self.policy == "round_robin":
            k = self._rr % max(1, len(pool))
            self._rr += 1
            return pool[k:] + pool[:k]
        if self.policy == "prefix":
            warm: Dict[str, int] = {}
            for n in pool:
                try:
                    warm[n] = int(self._workers[n].call(
                        "prefix_probe",
                        {"prompt": prompt})["warm_tokens"])
                except (TransportError, RpcError):
                    warm[n] = -1
            return sorted(pool, key=lambda n: (-warm[n], self._load(n), n))
        return sorted(pool, key=lambda n: (self._load(n), n))

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               sampling: Optional[SamplingParams] = None,
               session: Any = None, priority: int = 0,
               ttft_slo_ms: Optional[float] = None,
               tpot_slo_ms: Optional[float] = None) -> int:
        """Mint ONE lifecycle uid, then walk the placement order with
        admission failover: a rejecting worker logs ``rejected`` under
        the same uid and the walk moves on; only when EVERY candidate
        rejects does the ValueError reach the caller (the last
        rejection's message, as the ReplicaRouter raises)."""
        prompt_l = [int(t) for t in np.asarray(prompt).reshape(-1)]
        uid = self._rlog.new_uid()
        self._rlog.event(uid, "submitted", router=self._pid,
                         prompt_len=len(prompt_l),
                         max_new_tokens=int(max_new_tokens))
        rid = self._next_rid
        self._next_rid += 1
        req = _Req(rid, uid, prompt_l, int(max_new_tokens), sampling,
                   int(priority), ttft_slo_ms, tpot_slo_ms, session)
        self._reqs[rid] = req
        err: Optional[str] = None
        for name in self._candidates(prompt_l, session):
            got = self._place(req, name)
            if got is True:
                if session is not None:
                    self._affinity.setdefault(session, name)
                return rid
            if got is not False:
                err = got                   # rejection message, walk on
        del self._reqs[rid]
        raise ValueError(err or "no live workers available")

    def _place(self, req: _Req, name: str):
        """True = placed, False = transport loss, str = rejected."""
        t = self._workers[name]
        payload = {"prompt": req.prompt, "max_new_tokens": req.max_new,
                   "request_uid": req.uid, "priority": req.priority,
                   "ttft_slo_ms": req.ttft_slo_ms,
                   "tpot_slo_ms": req.tpot_slo_ms}
        if req.sampling is not None:
            payload["sampling"] = {
                "temperature": req.sampling.temperature,
                "top_k": req.sampling.top_k,
                "top_p": req.sampling.top_p}
        try:
            wrid = int(t.call("submit", payload)["rid"])
        except RpcError as e:
            if e.kind == "ValueError":
                return e.message            # engine rejection: walk on
            raise
        except TransportError:
            self._mark_lost(name, "submit_failed")
            return False
        req.worker, req.wrid = name, wrid
        self._by_worker[(name, wrid)] = req.rid
        self._rlog.event(req.uid, "placed", router=self._pid, worker=name,
                         route=self.policy)
        return True

    # -- the tick ------------------------------------------------------

    def step(self) -> List[int]:
        """One plane tick: heartbeat the roster, retry parked imports,
        step every live worker (collect deltas / finishes), then run
        the disagg migrations that became ready.  Returns plane rids
        finished this tick."""
        if self._hb_every > 0 and self._ticks % self._hb_every == 0:
            for name in list(self.live_workers):
                self._m_heartbeats.inc()
                try:
                    self._workers[name].call("ping", {})
                    self._last_hb_tick[name] = self._ticks
                except (TransportError, RpcError):
                    self._mark_lost(name, "heartbeat_failed")
        self._retry_pending_imports()
        finished: List[int] = []
        for name in list(self.live_workers):
            try:
                out = self._workers[name].call("step", {})
            except TransportError:
                self._mark_lost(name, "step_failed")
                continue
            except RpcError:
                continue
            self._status[name] = dict(out.get("status", {}))
            if not self._workers[name].shares_process:
                # process-separated worker: merge its shipped request-
                # log events so each uid keeps ONE lifecycle timeline
                # in THIS process (loopback shares the log already).
                # Worker timestamps map onto the plane clock through
                # the transport's stitched offset estimate; without an
                # estimate yet they fall back to the arrival stamp.
                st = getattr(self._workers[name], "stitch", None)
                for ev in out.get("events", []):
                    t_ms = ev.get("t_ms")
                    if t_ms is not None and st is not None and st.ready:
                        t_ms = st.to_plane_ms(float(t_ms))
                    else:
                        t_ms = None
                    self._rlog.event(int(ev["uid"]), str(ev["name"]),
                                     t_ms=t_ms,
                                     **dict(ev.get("attrs") or {}))
            for wr, toks in out.get("deltas", {}).items():
                rid = self._by_worker.get((name, int(wr)))
                if rid is None:
                    continue
                req = self._reqs[rid]
                req.generated.extend(int(t) for t in toks)
                if req.stream is not None:
                    req.stream({"tokens": [int(t) for t in toks],
                                "done": False})
            for wr in out.get("finished", []):
                rid = self._by_worker.get((name, int(wr)))
                if rid is None:
                    continue
                req = self._reqs[rid]
                req.done = True
                finished.append(rid)
                if req.stream is not None:
                    req.stream({"tokens": [], "done": True})
        if self.policy == "disagg":
            self._run_migrations()
        self._ticks += 1
        # gauge AFTER the tick count advances: the exported age matches
        # what fleet_report computes between ticks, so a scrape and the
        # /fleet endpoint never disagree by the in-tick off-by-one
        for name in self.live_workers:
            self._f_hb_age.labels(plane=self._pid, worker=name).set(
                self._ticks - self._last_hb_tick.get(name, 0))
        return finished

    def _run_migrations(self) -> None:
        """Move every prefill-phase request whose first token has
        surfaced to a decode worker.  Export releases the source slot;
        if the destination cannot take the record right now it parks
        plane-side and retries next tick — nothing is lost either way."""
        decode = self._decode_pool()
        if not decode:
            return                          # degrade: finish colocated
        for req in list(self._reqs.values()):
            if (req.done or req.phase != "prefill" or not req.generated
                    or req.worker not in self._prefill_pool
                    or req.worker in self._dead):
                continue
            src = self._workers[req.worker]
            try:
                record = src.call("export_request",
                                  {"rid": req.wrid})["record"]
            except TransportError:
                self._mark_lost(req.worker, "export_failed")
                continue
            except RpcError:
                continue
            if record is None:
                continue                    # not in a decode slot yet
            self._by_worker.pop((req.worker, req.wrid), None)
            req.worker, req.wrid = None, None
            req.phase = "migrating"
            if not self._import_record(req, record):
                self._pending_imports.append((req.rid, record))

    def _import_record(self, req: _Req, record: Dict[str, Any]) -> bool:
        nbytes = int(record.get("payload_bytes", 0))
        for name in sorted(self._decode_pool(),
                           key=lambda n: (self._load(n), n)):
            try:
                wrid = self._workers[name].call(
                    "import_request", {"record": record})["rid"]
            except TransportError:
                self._mark_lost(name, "import_failed")
                continue
            except RpcError:
                continue
            if wrid is None:
                continue                    # that pool is full; next
            req.worker, req.wrid = name, int(wrid)
            req.phase = "decode"
            self._by_worker[(name, int(wrid))] = req.rid
            self._m_migrations.inc()
            self._m_mig_bytes.inc(nbytes)
            self._rlog.event(req.uid, "migrated", router=self._pid,
                             worker=name,
                             blocks=len(record["blocks"]["entries"]),
                             bytes=nbytes)
            return True
        return False

    def _retry_pending_imports(self) -> None:
        still: List[Tuple[int, Dict[str, Any]]] = []
        for rid, record in self._pending_imports:
            req = self._reqs[rid]
            if req.done or not self._import_record(req, record):
                if not req.done:
                    still.append((rid, record))
        self._pending_imports = still

    # -- worker-loss failover ------------------------------------------

    def _failover_worker(self, name: str, reason: str) -> None:
        """Re-admit every in-flight request of a lost worker on the
        survivors: resubmit ``prompt + generated`` with the REMAINING
        budget under the SAME uid — the recompute-from-prefix path at
        plane scope.  Greedy decode continues the stream identically;
        the one timeline records loss, failover, and the new placement
        in order."""
        victims = [r for r in self._reqs.values()
                   if r.worker == name and not r.done]
        for req in victims:
            self._by_worker.pop((name, req.wrid), None)
            req.worker, req.wrid = None, None
            self._rlog.event(req.uid, "worker_lost", router=self._pid,
                             worker=name, reason=reason,
                             tokens_committed=len(req.generated))
            left = req.max_new - len(req.generated)
            if left <= 0:
                # everything it owed was already streamed: finish it
                req.done = True
                if req.stream is not None:
                    req.stream({"tokens": [], "done": True})
                continue
            self._m_failovers.inc()
            self._rlog.event(req.uid, "failover", router=self._pid,
                             tokens_committed=len(req.generated))
            carry = req.prompt + req.generated
            placed = False
            if self.policy == "disagg":
                pool = [n for n in self._prefill_pool
                        if n not in self._dead] or self.live_workers
            else:
                pool = self.live_workers
            req2 = _Req(req.rid, req.uid, carry, left, req.sampling,
                        req.priority, req.ttft_slo_ms, req.tpot_slo_ms,
                        req.session)
            for cand in sorted(pool, key=lambda n: (self._load(n), n)):
                got = self._place(req2, cand)
                if got is True:
                    req.worker, req.wrid = req2.worker, req2.wrid
                    req.phase = "prefill"
                    placed = True
                    break
            if not placed:
                req.done = True
                self._rlog.event(req.uid, "retired", router=self._pid,
                                 reason="failover_exhausted",
                                 violation="failover_exhausted")
                if req.stream is not None:
                    req.stream({"tokens": [], "done": True})

    # -- results / readout ---------------------------------------------

    def result(self, rid: int) -> List[int]:
        return list(self._reqs[rid].generated)

    def request_uid(self, rid: int) -> int:
        return self._reqs[rid].uid

    def worker_of(self, rid: int) -> Optional[str]:
        return self._reqs[rid].worker

    def attach_stream(self, rid: int,
                      put: Callable[[Dict[str, Any]], None]) -> None:
        """Register a per-tick token sink for ``rid`` (the streaming
        front end): called with ``{"tokens": [...], "done": bool}``
        every tick that surfaces tokens, then once with ``done=True``.
        Tokens already committed are replayed into the sink first, so
        attaching after submit never loses the head of the stream."""
        req = self._reqs[rid]
        if req.generated:
            put({"tokens": list(req.generated), "done": False})
        if req.done:
            put({"tokens": [], "done": True})
            return
        req.stream = put

    def cancel(self, rid: int) -> bool:
        req = self._reqs.get(rid)
        if req is None or req.done:
            return False
        req.done = True
        if req.worker is not None and req.worker not in self._dead:
            try:
                self._workers[req.worker].call("cancel",
                                               {"rid": req.wrid})
            except (TransportError, RpcError):
                pass
        self._pending_imports = [(r, rec) for r, rec in
                                 self._pending_imports if r != rid]
        if req.stream is not None:
            req.stream({"tokens": [], "done": True})
        return True

    def drain(self) -> List[Tuple[int, List[int]]]:
        """Step until every submitted request is done (worker loss
        included — failover keeps the plane making progress as long as
        one worker survives)."""
        while any(not r.done for r in self._reqs.values()):
            self.step()
        return [(r.rid, list(r.generated))
                for r in self._reqs.values()]

    def shutdown(self) -> None:
        for name in self.live_workers:
            try:
                self._workers[name].call("shutdown", {})
            except (TransportError, RpcError):
                pass
        for t in self._workers.values():
            t.close()

    # -- busy surface (loadgen.replay polls these) ---------------------

    @property
    def queue_depth(self) -> int:
        return (sum(int(s.get("queue_depth", 0))
                    for s in self._status.values())
                + len(self._pending_imports))

    @property
    def num_active(self) -> int:
        return sum(int(s.get("num_active", 0))
                   for s in self._status.values())

    @property
    def num_pending(self) -> int:
        n = sum(int(s.get("num_pending", 0))
                for s in self._status.values())
        # requests between workers (just failed over / migrating) are
        # invisible to every engine but still owed tokens
        n += sum(1 for r in self._reqs.values()
                 if not r.done and r.worker is None)
        return n

    @property
    def num_preempted(self) -> int:
        return sum(int(s.get("num_preempted", 0))
                   for s in self._status.values())

    @property
    def pending_chunks(self) -> int:
        return sum(int(s.get("pending_chunks", 0))
                   for s in self._status.values())

    @property
    def step_traces(self) -> int:
        return max([int(s.get("step_traces", 0))
                    for s in self._status.values()] or [0])

    # -- federated observability ---------------------------------------

    def federation(self, full: bool = False) -> "_fed.FederatedRegistry":
        """Pull every live worker's ``metrics_snapshot`` into one
        :class:`FederatedRegistry` (engine-scoped snapshots, so the
        federated totals equal the per-worker sums even when loopback
        workers share a process registry)."""
        fed = _fed.FederatedRegistry()
        for name in self.live_workers:
            try:
                out = self._workers[name].call(
                    "metrics_snapshot", {"full": bool(full)})
            except TransportError:
                self._mark_lost(name, "metrics_snapshot_failed")
                continue
            except RpcError:
                continue
            fed.add_snapshot(name, out["snapshot"])
        return fed

    def federated_metrics_text(self) -> str:
        """The fleet half of the /metrics page: the merged worker
        registries under the ``paddle_tpu_fleet_`` prefix (the serving
        process's own ``paddle_tpu_`` exposition rides alongside)."""
        return self.federation().prometheus_text()

    def fleet_report(self) -> Dict[str, Any]:
        """The /fleet endpoint payload: per-worker health (heartbeat
        age in plane ticks, in-flight slots, utilization, last-step
        cost-model ratio, transport error count) plus pooled figures
        computed sum over sum, never as a mean of per-worker ratios)."""
        workers: Dict[str, Any] = {}
        tot_active = tot_slots = 0
        for name in self._workers:
            st = self._status.get(name, {})
            alive = name not in self._dead
            slots = int(st.get("num_slots", 0) or 0)
            active = int(st.get("num_active", 0))
            if alive:
                tot_active += active
                tot_slots += slots
            workers[name] = {
                "alive": alive,
                "reason": self._dead.get(name),
                "heartbeat_age_ticks": (
                    self._ticks - self._last_hb_tick.get(name, 0)
                    if alive else None),
                "in_flight": active,
                "num_slots": slots,
                "utilization": (round(active / slots, 4)
                                if slots else 0.0),
                "last_step_ratio": st.get("last_step_ratio"),
                "queue_depth": int(st.get("queue_depth", 0)),
                "transport_errors": int(
                    getattr(self._workers[name], "errors", 0))}
        return {
            "plane": {"ticks": int(self._ticks), "policy": self.policy,
                      "workers_lost": len(self._dead),
                      "heartbeat_every": self._hb_every},
            "workers": workers,
            "pooled": {"in_flight": tot_active, "num_slots": tot_slots,
                       "utilization": (round(tot_active / tot_slots, 4)
                                       if tot_slots else 0.0)}}

    def slo_report(self, since_uid: int = 0,
                   until_uid: Optional[int] = None,
                   **kw: Any) -> Dict[str, Any]:
        """Federated SLO report: all workers' timelines are already
        joined in the plane log on the plane clock (loopback shares it;
        socket events arrive clock-stitched), so this is the request
        log's report — including ``by_worker`` violation attribution —
        scoped to the plane's requests."""
        return self._rlog.slo_report(since_uid, until_uid, **kw)

    def export_merged_perfetto(self, path: Optional[str] = None,
                               since_uid: int = 0,
                               until_uid: Optional[int] = None
                               ) -> Dict[str, Any]:
        """ONE merged Perfetto timeline for the fleet — see
        :func:`~paddle_tpu_torch.observability.federation.merge_perfetto`."""
        stitches = OrderedDict(
            (n, t.stitch) for n, t in self._workers.items()
            if getattr(t, "stitch", None) is not None)
        return _fed.merge_perfetto(
            stitches, self._rlog.records(since_uid, until_uid),
            path=path)

    def fleet_obs_signature(self, since_uid: int = 0,
                            until_uid: Optional[int] = None) -> str:
        """Byte-stability probe over the fleet observability state
        (merged timeline + wall-free federated metrics + health) — see
        :func:`~paddle_tpu_torch.observability.federation.
        fleet_obs_signature`."""
        return _fed.fleet_obs_signature(
            self.export_merged_perfetto(since_uid=since_uid,
                                        until_uid=until_uid),
            self.federation().merged(), self.fleet_report())

    def metrics(self) -> Dict[str, Any]:
        agg = {
            "workers": {n: dict(self._status.get(n, {}))
                        for n in self._workers},
            "lost_workers": dict(self._dead),
            "requests": len(self._reqs),
            "migrations": int(self._m_migrations.value()),
            "migration_bytes": int(self._m_mig_bytes.value()),
            "failovers": int(self._m_failovers.value()),
            "heartbeats": int(self._m_heartbeats.value()),
            "pending_imports": len(self._pending_imports),
            "policy": self.policy,
        }
        return {"aggregate": agg}
