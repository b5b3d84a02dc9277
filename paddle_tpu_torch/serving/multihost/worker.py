"""Engine worker of the multihost serving plane (mirrors
``paddle_tpu/serving/multihost/worker.py``).

:class:`EngineWorker` puts one
:class:`~paddle_tpu_torch.serving.engine.ServingEngine` behind the RPC
verbs the plane speaks: submit / step / result / cancel / status /
metrics / drain, the migration verbs (export_request / import_request)
and the placement probe (prefix_probe).  One handler serves both
carriers: a :class:`~.transport.LoopbackTransport` wraps it in-process,
and ``python -m paddle_tpu_torch.serving.multihost --worker ...`` serves
it over a socket from a process of its own.

Streaming: ``step`` returns each request's token deltas (every token
sampled this tick, keyed by ``str(rid)``), so the front end can put
tokens on the wire the tick they surface.  The worker keeps a read cursor
a rid; each token is reported once.

Migration: ``export_request`` hands back the engine's record, whose KV
blocks are CPU tensors (pinned on the card); the codec carries them bit
for bit (bfloat16 as raw bytes, see ``transport``).  ``import_request``
turns the decoded blocks back into tensors before the engine writes them
into its pool in place.

The reference's ``lint`` verb runs ``ServingEngine.lint_step``, the
static analysis of ROADMAP A11, which the port lacks: the verb raises
``NotImplementedError``, which reaches the plane as
``RpcError(kind="NotImplementedError")``.  It never answers with an empty
list of findings.
"""

from __future__ import annotations

from typing import Any, Dict, List, Set

import numpy as np
import torch

from ... import observability as _obs
from ...observability.federation import scope_snapshot
from ...observability.metrics import SNAPSHOT_SCHEMA_VERSION
from ..engine import SamplingParams, ServingEngine

__all__ = ["EngineWorker"]


class EngineWorker:
    """The RPC surface over one engine.  Pure dispatcher: all
    scheduling policy lives plane-side, all engine mechanics engine-
    side; this class only translates wire payloads."""

    def __init__(self, engine: ServingEngine, name: str = "w0"):
        self.engine = engine
        self.name = name
        self._cursor: Dict[int, int] = {}       # rid -> tokens reported
        self._live: List[int] = []              # rids not yet finished
        self._rlog = _obs.get_request_log()
        self._shipped: Dict[int, int] = {}      # uid -> events shipped
        self._closed: Set[int] = set()          # uid left us (exported)
        self.stop_requested = False

    def clock_ms(self) -> float:
        """The worker clock the RPC server stamps t1/t2 with — the
        request log's relative clock, so shipped event timestamps and
        stitch samples share one base (the plane's offset estimate
        maps both onto the plane clock at once)."""
        return self._rlog.now_ms()

    # -- dispatch ------------------------------------------------------

    def handle(self, method: str, payload: Dict[str, Any]) -> Any:
        fn = getattr(self, "_rpc_" + method, None)
        if fn is None:
            raise ValueError(f"unknown worker method {method!r}")
        return fn(payload)

    # -- methods -------------------------------------------------------

    def _rpc_ping(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return {"ok": 1, "name": self.name}

    def _rpc_submit(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        sp = payload.get("sampling") or {}
        sampling = SamplingParams(
            temperature=float(sp.get("temperature", 0.0)),
            top_k=int(sp.get("top_k", 0)),
            top_p=float(sp.get("top_p", 1.0)))
        uid = payload.get("request_uid")
        rid = self.engine.submit(
            np.asarray(payload["prompt"], np.int32),
            max_new_tokens=int(payload.get("max_new_tokens", 32)),
            sampling=sampling,
            request_uid=None if uid is None else int(uid),
            priority=int(payload.get("priority", 0)),
            ttft_slo_ms=payload.get("ttft_slo_ms"),
            tpot_slo_ms=payload.get("tpot_slo_ms"))
        self._cursor[rid] = 0
        self._live.append(rid)
        self._shipped.setdefault(int(self.engine.request_uid(rid)), 0)
        return {"rid": int(rid)}

    def _rpc_step(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        finished = self.engine.step()
        deltas: Dict[str, List[int]] = {}
        for rid in list(self._live):
            toks = self.engine.result(rid)
            cur = self._cursor.get(rid, 0)
            if len(toks) > cur:
                deltas[str(rid)] = [int(t) for t in toks[cur:]]
                self._cursor[rid] = len(toks)
        for rid in finished:
            if rid in self._live:
                self._live.remove(rid)
        return {"finished": [int(r) for r in finished],
                "deltas": deltas,
                "status": self._status(),
                "events": self._collect_events()}

    def _collect_events(self) -> List[Dict[str, Any]]:
        """New request-log events since the last ship, for every uid
        this worker has hosted.  A socket plane merges these into ITS
        log so the lifecycle timeline stays ONE record per uid even
        when the engine lives in another OS process; a loopback plane
        discards them (shared log, already written)."""
        out: List[Dict[str, Any]] = []
        for uid in list(self._shipped):
            tl = self._rlog.timeline(uid)
            cur = self._shipped[uid]
            for ev in tl[cur:]:
                out.append({"uid": int(uid), "name": ev["name"],
                            "t_ms": float(ev["t_ms"]),
                            "attrs": _jsonable(ev["attrs"])})
            self._shipped[uid] = len(tl)
            if uid in self._closed or any(
                    ev["name"] == "retired" for ev in tl):
                self._shipped.pop(uid, None)
                self._closed.discard(uid)
        return out

    def _rpc_result(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return {"tokens": [int(t)
                           for t in self.engine.result(
                               int(payload["rid"]))]}

    def _rpc_cancel(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        rid = int(payload["rid"])
        ok = self.engine.cancel(rid)
        if rid in self._live:
            self._live.remove(rid)
        return {"ok": bool(ok)}

    def _rpc_request_uid(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return {"uid": int(self.engine.request_uid(int(payload["rid"])))}

    def _status(self) -> Dict[str, Any]:
        e = self.engine
        perf = getattr(e, "_perf", None)
        ratio = getattr(perf, "last_ratio", None) if perf else None
        return {"queue_depth": int(e.queue_depth),
                "num_active": int(e.num_active),
                "num_pending": int(e.num_pending),
                "num_preempted": int(e.num_preempted),
                "pending_chunks": int(e.pending_chunks),
                "step_traces": int(e.step_traces),
                "num_slots": int(getattr(e, "num_slots", 0) or 0),
                "engine": str(getattr(e, "_eid", "")),
                "last_step_ratio": (None if ratio is None
                                    else round(float(ratio), 6))}

    def _rpc_status(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return self._status()

    def _rpc_metrics(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return _jsonable(self.engine.metrics())

    def _rpc_metrics_snapshot(self, payload: Dict[str, Any]
                              ) -> Dict[str, Any]:
        """The registry's snapshot, scoped to THIS worker's engine
        series by default (federation correctness: on a loopback plane
        every worker shares one process registry, so the unscoped
        snapshot would double-count; ``full=True`` returns it anyway
        for process-separated debugging)."""
        snap = _obs.default_registry().snapshot()
        eid = str(getattr(self.engine, "_eid", ""))
        if not payload.get("full"):
            snap = scope_snapshot(snap, eid)
        return {"schema_version": SNAPSHOT_SCHEMA_VERSION,
                "worker": self.name, "engine": eid,
                "clock_ms": float(self.clock_ms()),
                "snapshot": snap}

    def _rpc_prefix_probe(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        warm = 0
        if self.engine.paged:
            warm = int(self.engine.kv.prefix_probe(
                [int(t) for t in payload["prompt"]]))
        return {"warm_tokens": warm}

    def _rpc_lint(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError(
            "lint waits for ROADMAP A11: the port has no static analysis "
            "(ServingEngine.lint_step)")

    def _rpc_export_request(self, payload: Dict[str, Any]
                            ) -> Dict[str, Any]:
        rid = int(payload["rid"])
        record = self.engine.export_request(
            rid, release=bool(payload.get("release", True)))
        if record is not None:
            if rid in self._live:
                # the request now lives wherever the record lands;
                # tokens already reported stay reported (the record's
                # "generated" carries them for the importer's cursor)
                self._live.remove(rid)
            # ship the trailing "exported" event next step, then stop
            # tracking the uid — it retires on another worker
            self._closed.add(int(record["uid"]))
        return {"record": record}

    def _rpc_import_request(self, payload: Dict[str, Any]
                            ) -> Dict[str, Any]:
        record = _as_tensors(payload["record"])
        uid = int(record["uid"])
        # events before this point belong to the exporter (or, on a
        # loopback plane, are already in the shared log): ship only
        # what the import itself logs onward
        base = len(self._rlog.timeline(uid))
        rid = self.engine.import_request(record)
        if rid is not None:
            # start the delta cursor past the tokens the EXPORTER
            # already surfaced — exactly-once across the migration
            self._cursor[rid] = len(record.get("generated", []))
            self._live.append(rid)
            self._shipped.setdefault(uid, base)
        return {"rid": None if rid is None else int(rid)}

    def _rpc_drain(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        done = self.engine.drain()
        for rid, _ in done:
            if rid in self._live:
                self._live.remove(rid)
        return {"finished": [[int(r), [int(t) for t in toks]]
                             for r, toks in done]}

    def _rpc_shutdown(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        self.stop_requested = True
        return {"ok": 1}


def _as_tensors(record: Dict[str, Any]) -> Dict[str, Any]:
    """A decoded export record with every block payload as a tuple of
    CPU tensors, the form the engine's block writer copies from (the
    codec decodes an array numpy holds to numpy, a bfloat16 one to a
    tensor already)."""
    blocks = dict(record["blocks"])
    blocks["entries"] = [
        dict(e, payload=tuple(
            p if isinstance(p, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(p)) for p in e["payload"]))
        for e in blocks["entries"]]
    return dict(record, blocks=blocks)


def _jsonable(obj: Any) -> Any:
    """Engine metrics carry numpy scalars and tuple keys; flatten to
    wire-safe JSON types (tuple keys -> '/'-joined strings)."""
    if isinstance(obj, dict):
        return {("/".join(str(p) for p in k)
                 if isinstance(k, tuple) else str(k)): _jsonable(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
