"""Per-request lifecycle log (mirrors
``paddle_tpu/observability/request_log.py``).

The metrics registry answers "how is the engine doing" in aggregates; a
capacity decision ("which requests missed their deadline, and where did
the time go?") needs per-request timelines.  Every serving request carries
one process-wide **uid** minted at ``submit()`` (or threaded through by a
caller that minted it), and every lifecycle transition appends a
structured event here:

  ``submitted`` -> (``rejected`` | ``admitted``) ->
  ``prefill`` | ``prefill_chunk``* -> ``first_token`` ->
  ``spec_accept``* -> ``retired``

plus ``admission_wait`` when a paged pool holds admission back,
``admission_deferred`` when the predictive gate does, and under
preemption ``preempted`` -> (``swapped_out`` -> ``swapped_in``)? ->
``resumed`` cycles, ``exported`` / ``imported`` around a migration and a
terminal ``retired`` with ``violation="cancelled"`` when ``cancel(rid)``
pulls the request.  Each event is mirrored into the span tracer as a
``request.<name>`` instant with the uid as its correlation arg.

Three read surfaces:

  * :meth:`RequestLog.export_perfetto`: Trace Event JSON with one named
    track per request (tid = uid) and queued / prefill / decode phase
    slices derived from the events;
  * :meth:`RequestLog.timeline_signature`: the structural timeline with
    uids, timings and per-process ids stripped.  Two replays of one
    schedule give equal signatures, and so do the JAX package's engine
    and the port's over the same schedule;
  * :meth:`RequestLog.slo_report`: the timelines joined against TTFT /
    TPOT deadlines (recorded at submit from ``FLAGS_serving_slo_ttft_ms``
    / ``FLAGS_serving_slo_tpot_ms``, or explicit overrides): goodput and a
    violation breakdown by cause (rejected / cancelled / queue_wait /
    prefill / decode).

Cost: one lock and one list append an event, no device work; events fire
at scheduling transitions only, never per decoded token.  The store is
bounded (``FLAGS_request_log_max_requests``): the oldest whole requests
drop first and are counted, like the span tracer's ring.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["RequestLog", "get_request_log"]

# attrs stripped from timeline_signature(): per-process ids (engine /
# router ids are global counters, different on every run) and wall-clock
# measurements; everything else — slots, chunk sizes, token counts,
# reasons — must replay bit-identically under the same seed
_SIGNATURE_SKIP = ("engine", "replica", "router", "violation")


def _pct(vals: List[float], q: float) -> float:
    """numpy.percentile(..., interpolation='linear') on a sorted copy —
    local so the observability layer stays dependency-free."""
    s = sorted(vals)
    if not s:
        return 0.0
    k = (len(s) - 1) * q
    lo, hi = int(k), min(int(k) + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


class RequestLog:
    """Bounded, thread-safe store of per-request event timelines."""

    def __init__(self, max_requests: Optional[int] = None):
        from .. import flags as _flags
        if max_requests is None:
            max_requests = int(_flags.flag("request_log_max_requests"))
        self.max_requests = max(1, int(max_requests))
        self.dropped = 0                     # whole requests evicted
        self._uids = itertools.count(1)
        self._last_uid = 0
        self._records: "OrderedDict[int, List[Dict[str, Any]]]" = \
            OrderedDict()
        self._lock = threading.Lock()
        self._pid = os.getpid()
        # the clock seam: event timestamps read (self._clock() - _t0); a
        # caller may swap both for a virtual clock to replay timelines
        # deterministically
        self._clock = time.perf_counter
        self._t0 = time.perf_counter()

    # -- recording ---------------------------------------------------------

    def new_uid(self) -> int:
        """Mint the next request uid (process-wide, monotonic).  Uids
        are correlation keys, not identities: signatures and SLO joins
        never depend on their absolute values."""
        with self._lock:
            self._last_uid = next(self._uids)
            return self._last_uid

    def mark(self) -> int:
        """High-water uid: pass to ``timeline_signature`` /
        ``slo_report`` / ``export_perfetto`` as ``since_uid`` to scope a
        readout to requests submitted after this point (one run out of
        a shared log)."""
        with self._lock:
            return self._last_uid

    def now_ms(self) -> float:
        """This log's relative clock reading (ms): the base every event
        timestamp shares."""
        return (self._clock() - self._t0) * 1e3

    def event(self, uid: int, name: str, t_ms: Optional[float] = None,
              **attrs: Any) -> None:
        """Append one lifecycle event and mirror it into the span
        tracer as a ``request.<name>`` instant with ``uid`` as the
        correlation arg.  ``t_ms`` overrides the stamp (events merged
        from another clock at their stitched time)."""
        if t_ms is None:
            t_ms = self.now_ms()
        ev = {"name": name, "t_ms": float(t_ms), "attrs": dict(attrs)}
        with self._lock:
            rec = self._records.get(uid)
            if rec is None:
                while len(self._records) >= self.max_requests:
                    self._records.popitem(last=False)
                    self.dropped += 1
                rec = self._records[uid] = []
            rec.append(ev)
        from .tracing import get_tracer
        get_tracer().instant(f"request.{name}", cat="request", uid=uid,
                             **attrs)

    # -- readout -----------------------------------------------------------

    def timeline(self, uid: int) -> List[Dict[str, Any]]:
        """One request's events, in emission order (copies)."""
        with self._lock:
            return [dict(ev, attrs=dict(ev["attrs"]))
                    for ev in self._records.get(uid, [])]

    def records(self, since_uid: int = 0, until_uid: Optional[int] = None
                ) -> "OrderedDict[int, List[Dict[str, Any]]]":
        """All timelines with ``since_uid < uid <= until_uid`` (None =
        no upper bound), keyed by uid in submission order (copies).
        Bracketing a run with two ``mark()`` calls and passing both
        bounds scopes a readout to exactly that run, however many runs
        share the log."""
        with self._lock:
            return OrderedDict(
                (uid, [dict(ev, attrs=dict(ev["attrs"])) for ev in rec])
                for uid, rec in self._records.items()
                if uid > since_uid
                and (until_uid is None or uid <= until_uid))

    def event_names(self, uid: int) -> List[str]:
        with self._lock:
            return [ev["name"] for ev in self._records.get(uid, [])]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0

    def timeline_signature(self, since_uid: int = 0,
                           until_uid: Optional[int] = None) -> List[Tuple]:
        """The structural timeline, one tuple per request in submission
        order: event names plus their DETERMINISTIC attrs (uids,
        ``*_ms`` timings and per-process engine/router ids stripped).
        Two replays of the same schedule must compare equal."""
        out: List[Tuple] = []
        for rec in self.records(since_uid, until_uid).values():
            sig = []
            for ev in rec:
                attrs = tuple(sorted(
                    (k, v) for k, v in ev["attrs"].items()
                    if k not in _SIGNATURE_SKIP
                    and not k.endswith("_ms")))
                sig.append((ev["name"], attrs))
            out.append(tuple(sig))
        return out

    # -- Perfetto export ---------------------------------------------------

    def export_perfetto(self, path: Optional[str] = None,
                        since_uid: int = 0,
                        until_uid: Optional[int] = None) -> Dict[str, Any]:
        """Trace Event JSON with one named track per request: tid =
        uid under a dedicated "paddle_tpu_torch requests" process, every
        lifecycle event as an instant, and queued / prefill / decode
        phase slices reconstructed from the submitted → admitted →
        first_token → retired timestamps.  Loads in ui.perfetto.dev /
        chrome://tracing as-is; ``path`` additionally writes the file."""
        recs = self.records(since_uid, until_uid)
        meta: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": self._pid,
             "tid": 0, "args": {"name": "paddle_tpu_torch requests"}}]
        events: List[Dict[str, Any]] = []
        for uid, rec in recs.items():
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": self._pid, "tid": uid,
                         "args": {"name": f"request {uid}"}})
            t_of: Dict[str, float] = {}
            for ev in rec:
                t_of.setdefault(ev["name"], ev["t_ms"])
                events.append({"name": ev["name"], "cat": "request",
                               "ph": "i", "s": "t",
                               "ts": ev["t_ms"] * 1e3,
                               "pid": self._pid, "tid": uid,
                               "args": dict(ev["attrs"], uid=uid)})
            # phase slices: submit→admit (queued), admit→first token
            # (prefill incl. any admission wait), first→retired (decode)
            for phase, a, b in (
                    ("queued", "submitted", "admitted"),
                    ("queued", "submitted", "rejected"),
                    ("prefill", "admitted", "first_token"),
                    ("decode", "first_token", "retired"),
                    # gap the preemptive scheduler evicted this request
                    # for (first preemption to first resume; nested
                    # cycles merge into one slice)
                    ("preempted", "preempted", "resumed")):
                if a in t_of and b in t_of and t_of[b] >= t_of[a]:
                    events.append({
                        "name": phase, "cat": "request", "ph": "X",
                        "ts": t_of[a] * 1e3,
                        "dur": (t_of[b] - t_of[a]) * 1e3,
                        "pid": self._pid, "tid": uid,
                        "args": {"uid": uid}})
        trace = {"traceEvents": meta + events,
                 "displayTimeUnit": "ms",
                 "otherData": {"producer":
                               "paddle_tpu_torch.observability."
                               "request_log",
                               "dropped_requests": self.dropped}}
        if path is not None:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace

    # -- SLO goodput -------------------------------------------------------

    def slo_report(self, since_uid: int = 0,
                   until_uid: Optional[int] = None,
                   ttft_ms: Optional[float] = None,
                   tpot_ms: Optional[float] = None,
                   wall_s: Optional[float] = None) -> Dict[str, Any]:
        """Join the recorded timelines against TTFT/TPOT deadlines.

        Targets default to the per-request values recorded at submit
        (FLAGS_serving_slo_ttft_ms / FLAGS_serving_slo_tpot_ms at the
        time; 0 = that deadline disabled); explicit ``ttft_ms`` /
        ``tpot_ms`` override them (a post-hoc join).  Conventions: the
        goodput denominator counts EVERY submitted request, rejected
        ones included; TTFT is measured from submit, not admit; a
        violating request is attributed to exactly one cause —
        ``rejected``, else ``cancelled`` (retired via ``cancel(rid)``
        — rejected-style: in the denominator, never attaining), else a
        missed TTFT to its larger segment (``queue_wait`` vs
        ``prefill``), else a missed TPOT to ``decode``; a request still
        in flight counts as ``incomplete`` (never SLO-attaining).

        Fleet attribution: when timelines carry placement
        (``placed``/``migrated`` with a ``worker`` attr, or engine
        events), the report gains a ``by_worker`` section attributing
        every request's outcome to its LAST hosting worker (the one a
        migrated/failed-over request retired on) — the same join works
        for a multihost plane on the plane clock and for ``FleetSim``'s
        per-replica simulated clocks (keyed ``engine:<id>`` there)."""
        recs = self.records(since_uid, until_uid)
        total = len(recs)
        attained = 0
        attained_tokens = 0
        ttfts: List[float] = []
        tpots: List[float] = []
        viol = {"rejected": 0, "cancelled": 0, "queue_wait": 0,
                "prefill": 0, "decode": 0, "incomplete": 0}
        by_worker: Dict[str, Dict[str, Any]] = {}

        def tally(wkey: Optional[str], outcome: str) -> None:
            if wkey is None:
                return
            w = by_worker.setdefault(
                wkey, {"requests": 0, "attained": 0, "violations": {}})
            w["requests"] += 1
            if outcome == "attained":
                w["attained"] += 1
            else:
                w["violations"][outcome] = \
                    w["violations"].get(outcome, 0) + 1

        recorded_targets = set()
        for rec in recs.values():
            by = {}
            wkey: Optional[str] = None
            for ev in rec:
                by.setdefault(ev["name"], ev["attrs"])
                if ev["name"] in ("placed", "migrated") \
                        and ev["attrs"].get("worker") is not None:
                    wkey = str(ev["attrs"]["worker"])
                elif wkey is None \
                        and ev["attrs"].get("engine") is not None:
                    wkey = f"engine:{ev['attrs']['engine']}"
            sub = by.get("submitted", {})
            t_ttft = (float(sub.get("ttft_slo_ms", 0.0))
                      if ttft_ms is None else float(ttft_ms))
            t_tpot = (float(sub.get("tpot_slo_ms", 0.0))
                      if tpot_ms is None else float(tpot_ms))
            recorded_targets.add((t_ttft, t_tpot))
            if "rejected" in by and "admitted" not in by:
                viol["rejected"] += 1
                tally(wkey, "rejected")
                continue
            ret = by.get("retired")
            if ret is None:
                viol["incomplete"] += 1
                tally(wkey, "incomplete")
                continue
            if ret.get("reason") == "cancelled":
                viol["cancelled"] += 1
                tally(wkey, "cancelled")
                continue
            ttft = ret.get("ttft_ms")
            tpot = ret.get("tpot_ms")
            if ttft is not None:
                ttfts.append(float(ttft))
            if tpot is not None:
                tpots.append(float(tpot))
            kind = None
            if t_ttft > 0 and ttft is not None and ttft > t_ttft:
                qw = float(by.get("admitted", {}).get("queue_wait_ms",
                                                      0.0))
                kind = ("queue_wait" if qw >= float(ttft) - qw
                        else "prefill")
            elif t_tpot > 0 and tpot is not None and tpot > t_tpot:
                kind = "decode"
            if kind is None:
                attained += 1
                attained_tokens += int(ret.get("tokens", 0))
                tally(wkey, "attained")
            else:
                viol[kind] += 1
                tally(wkey, kind)

        def dist(vals):
            return {"count": len(vals),
                    "p50": round(_pct(vals, 0.50), 3),
                    "p99": round(_pct(vals, 0.99), 3)}

        if ttft_ms is not None or tpot_ms is not None:
            targets = {"ttft": float(ttft_ms or 0.0),
                       "tpot": float(tpot_ms or 0.0)}
        elif len(recorded_targets) == 1:
            t = recorded_targets.pop()
            targets = {"ttft": t[0], "tpot": t[1]}
        else:
            targets = {"ttft": "per_request", "tpot": "per_request"}
        out: Dict[str, Any] = {
            "requests": total,
            "attained": attained,
            "goodput": round(attained / total, 4) if total else 0.0,
            "attained_tokens": attained_tokens,
            "targets_ms": targets,
            "violations": viol,
            "ttft_ms": dist(ttfts),
            "tpot_ms": dist(tpots)}
        if by_worker:
            out["by_worker"] = {k: by_worker[k]
                                for k in sorted(by_worker)}
        if wall_s:
            out["goodput_tok_s"] = round(attained_tokens / wall_s, 1)
        return out


# -- module-level default log ------------------------------------------------

_log: Optional[RequestLog] = None
_log_lock = threading.Lock()


def get_request_log() -> RequestLog:
    """The process-wide request log every engine/router records into
    (created lazily so FLAGS_* read their environment overrides
    first)."""
    global _log
    if _log is None:
        with _log_lock:
            if _log is None:
                _log = RequestLog()
    return _log
