"""Federated observability over the multihost plane (mirrors
``paddle_tpu/observability/federation.py``).

Three pieces, all plane-side and free of any framework:

  * :class:`FederatedRegistry` merges the schema-versioned
    :meth:`~.metrics.MetricsRegistry.snapshot` dicts that workers return
    from the ``metrics_snapshot`` RPC into one fleet view: every series
    gains a ``worker=<name>`` label, and each histogram family carries a
    **pooled** row whose percentiles are recomputed from the summed fixed
    buckets with the same linear interpolation
    :meth:`Histogram.percentile` uses.  Pooled ratios sum numerators and
    denominators across workers and divide once, never averaging
    per-worker ratios.  The label-cardinality guard applies **after the
    merge**: ``FLAGS_metrics_max_children`` bounds the federated children
    of a family (N workers x M label sets), and the overflow coalesces,
    with a warning, into one ``{overflow="true"}`` child, as the
    per-process guard does.

  * :class:`ClockOffsetEstimator` / :class:`TransportStitch`: the
    NTP-style clock alignment behind cross-process trace stitching.  An
    RPC round trip gives four timestamps (client send ``t0``, server
    receive ``t1``, server send ``t2``, client receive ``t3``, each in
    milliseconds on its own clock); the estimator keeps the sample of
    least round-trip time and recovers ``offset = ((t1 - t0) + (t2 -
    t3)) / 2``, the worker clock's lead over the plane's, right to within
    +-RTT/2.  Ties keep the first minimal sample, so replayed clocks give
    the same estimate.

  * :func:`merge_perfetto`: one merged Trace Event timeline: a plane
    process whose per-worker RPC tracks carry every ``rpc.call`` slice
    split into wire and in-worker time, one process track a worker
    (handler slices mapped onto the plane clock through the estimated
    offset), and one track a request uid across its router -> worker ->
    (disaggregated) migration hops.  It is built from stitch records and
    the request log (already on the plane clock) alone, so under
    simulated clocks the export is byte-stable across replays;
    :func:`fleet_obs_signature` hashes it with the wall-free slice of the
    federated snapshot (counter totals, histogram counts) and the fleet's
    health roster.
"""

from __future__ import annotations

import hashlib
import json
import warnings
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from . import metrics as _metrics
from .metrics import SNAPSHOT_SCHEMA_VERSION, _expo_labels, _expo_name, \
    _fmt_float, _label_key

__all__ = [
    "ClockOffsetEstimator", "TransportStitch", "FederatedRegistry",
    "scope_snapshot", "percentile_from_buckets", "merge_perfetto",
    "fleet_obs_signature",
]


# -- clock alignment ---------------------------------------------------------

class ClockOffsetEstimator:
    """NTP-style offset recovery from (t0, t1, t2, t3) samples.

    ``offset`` is how far the REMOTE clock runs ahead of the local one
    (remote_ms - offset == local_ms); the estimate from any single
    sample is wrong by at most half that sample's round-trip time, so
    the minimum-RTT sample is kept (strictly-smaller wins, first wins
    ties — deterministic under replayed clocks)."""

    __slots__ = ("samples", "_best_rtt", "_best_offset")

    def __init__(self) -> None:
        self.samples = 0
        self._best_rtt: Optional[float] = None
        self._best_offset = 0.0

    def add_sample(self, t0: float, t1: float, t2: float,
                   t3: float) -> None:
        rtt = max(0.0, (t3 - t0) - (t2 - t1))
        offset = ((t1 - t0) + (t2 - t3)) / 2.0
        self.samples += 1
        if self._best_rtt is None or rtt < self._best_rtt:
            self._best_rtt = rtt
            self._best_offset = offset

    @property
    def ready(self) -> bool:
        return self.samples > 0

    @property
    def offset_ms(self) -> float:
        """Best estimate of remote - local clock skew (ms)."""
        return self._best_offset

    @property
    def min_rtt_ms(self) -> float:
        return self._best_rtt or 0.0

    @property
    def error_bound_ms(self) -> float:
        """The estimate is within ±RTT/2 of the true offset."""
        return self.min_rtt_ms / 2.0

    def to_local_ms(self, remote_ms: float) -> float:
        return float(remote_ms) - self._best_offset


class TransportStitch:
    """Per-transport stitching state: the offset estimator plus a
    bounded record of (method, t0..t3) per completed round trip — the
    raw material :func:`merge_perfetto` turns into wire/in-worker
    slices.  Bounded like every other observability store; overflow is
    counted, never silent."""

    MAX_RECORDS = 8192

    __slots__ = ("name", "estimator", "records", "dropped")

    def __init__(self, name: str):
        self.name = name
        self.estimator = ClockOffsetEstimator()
        self.records: List[Dict[str, float]] = []
        self.dropped = 0

    def record(self, method: str, t0: float, t1: float, t2: float,
               t3: float) -> None:
        self.estimator.add_sample(t0, t1, t2, t3)
        if len(self.records) >= self.MAX_RECORDS:
            self.dropped += 1
            return
        self.records.append({"method": str(method), "t0": float(t0),
                             "t1": float(t1), "t2": float(t2),
                             "t3": float(t3)})

    @property
    def ready(self) -> bool:
        return self.estimator.ready

    def to_plane_ms(self, worker_ms: float) -> float:
        return self.estimator.to_local_ms(worker_ms)


# -- snapshot scoping --------------------------------------------------------

def scope_snapshot(snap: Dict[str, Any], engine_id: str) -> Dict[str, Any]:
    """The slice of a process registry snapshot that belongs to ONE
    engine: families filtered to series labelled ``engine=<id>``.

    This is what makes federation double-count-proof on a loopback
    plane, where every worker shares one process registry: each
    worker's ``metrics_snapshot`` returns only ITS engine's series, so
    summing across workers equals the process totals instead of
    N-times them.  Process-wide families without an ``engine`` label
    (rpc transports, trace ring) stay plane-side."""
    eid = str(engine_id)
    out: Dict[str, Any] = {"schema_version": snap["schema_version"]}
    for name, fam in snap.items():
        if name == "schema_version":
            continue
        series = [row for row in fam["series"]
                  if str(row["labels"].get("engine", "")) == eid]
        if series:
            out[name] = {"type": fam["type"], "help": fam["help"],
                         "series": series}
    return out


# -- pooled-percentile math --------------------------------------------------

def _parse_buckets(buckets: Dict[str, int]
                   ) -> Tuple[List[Tuple[float, int]], int]:
    """Cumulative ``{le: count}`` -> (sorted finite (bound, cum) pairs,
    total including +Inf)."""
    finite = sorted((float(k), int(v)) for k, v in buckets.items()
                    if k != "+Inf")
    total = int(buckets.get("+Inf", finite[-1][1] if finite else 0))
    return finite, total


def percentile_from_buckets(buckets: Dict[str, int],
                            q: float) -> Optional[float]:
    """:meth:`Histogram.percentile` re-run over exported cumulative
    buckets — linear interpolation inside the owning bucket, +Inf
    clamped to the largest finite bound.  This is how pooled fleet
    percentiles are recomputed from merged per-worker buckets (the
    only statistically sound way to pool: merge counts, then read the
    quantile — never average per-worker quantiles)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    finite, total = _parse_buckets(buckets)
    if total == 0:
        return None
    # de-cumulate into per-bucket counts (+Inf last)
    counts: List[int] = []
    prev = 0
    for _, cum in finite:
        counts.append(cum - prev)
        prev = cum
    counts.append(total - prev)
    bounds = [b for b, _ in finite]
    rank = min(max(q * total, 1e-9), float(total))
    cum = 0
    lower = 0.0
    for i, c in enumerate(counts):
        before = cum
        cum += c
        if before < rank <= cum:
            if i >= len(bounds):            # +Inf bucket: clamp
                return float(lower)
            upper = bounds[i]
            return lower + (upper - lower) * (rank - before) / c
        if i < len(bounds):
            lower = bounds[i]
    return float(lower)


def _sum_buckets(rows: List[Dict[str, Any]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for row in rows:
        for le, c in row["buckets"].items():
            out[le] = out.get(le, 0) + int(c)
    # keep the bound order of the first row (registry order), +Inf last
    if rows:
        ordered = OrderedDict()
        for le in rows[0]["buckets"]:
            ordered[le] = out.pop(le)
        for le in sorted(out):
            ordered[le] = out[le]
        return dict(ordered)
    return out


# -- the federated registry --------------------------------------------------

class FederatedRegistry:
    """Merge worker registry snapshots into one fleet-level snapshot.

    ``add_snapshot(worker, snap)`` ingests one worker's (schema-
    checked) snapshot; ``merged()`` returns the federated view:

      * every series re-labelled with ``worker=<name>``;
      * one ``pooled`` row per family — counters/gauges sum their
        values, histograms sum count/sum/buckets and recompute
        p50/p90/p99 from the merged buckets;
      * the cardinality cap applied per family POST-merge: past
        ``FLAGS_metrics_max_children`` federated children, the rest
        coalesce into ``{overflow="true"}`` with a loud warning and a
        per-family ``coalesced`` count in the output.
    """

    def __init__(self, max_children: Optional[int] = None):
        self._snaps: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._cap = max_children
        self._warned: set = set()

    @property
    def workers(self) -> List[str]:
        return list(self._snaps)

    def add_snapshot(self, worker: str, snap: Dict[str, Any]) -> None:
        ver = snap.get("schema_version")
        if ver != SNAPSHOT_SCHEMA_VERSION:
            raise ValueError(
                f"worker {worker!r} snapshot schema_version {ver!r} != "
                f"{SNAPSHOT_SCHEMA_VERSION} (mixed-version fleet; "
                f"upgrade the worker before federating it)")
        self._snaps[str(worker)] = snap

    def _max_children(self) -> int:
        if self._cap is not None:
            return int(self._cap)
        from .. import flags as _flags
        return int(_flags.flag("metrics_max_children"))

    # -- merge ---------------------------------------------------------

    def merged(self) -> Dict[str, Any]:
        cap = self._max_children()
        out: Dict[str, Any] = {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "workers": list(self._snaps)}
        fam_names: List[str] = sorted({
            name for snap in self._snaps.values() for name in snap
            if name != "schema_version"})
        for name in fam_names:
            kind = help_ = None
            rows: List[Dict[str, Any]] = []
            for worker, snap in self._snaps.items():
                fam = snap.get(name)
                if fam is None:
                    continue
                kind, help_ = fam["type"], fam["help"]
                for row in fam["series"]:
                    merged_row = dict(row)
                    merged_row["labels"] = dict(row["labels"],
                                                worker=worker)
                    rows.append(merged_row)
            rows.sort(key=lambda r: sorted(r["labels"].items()))
            coalesced = 0
            if cap > 0 and len(rows) > cap:
                keep, spill = rows[:cap], rows[cap:]
                coalesced = len(spill)
                if name not in self._warned:
                    self._warned.add(name)
                    warnings.warn(
                        f"federated metric family {name!r} has "
                        f"{len(rows)} children across "
                        f"{len(self._snaps)} workers — past the "
                        f"post-merge cardinality cap ({cap}); "
                        f"coalescing {coalesced} into "
                        f"{{overflow='true'}} "
                        f"(FLAGS_metrics_max_children)",
                        RuntimeWarning, stacklevel=2)
                keep.append(self._coalesce(kind, spill))
                rows = keep
            fam_out: Dict[str, Any] = {"type": kind, "help": help_,
                                       "series": rows,
                                       "coalesced": coalesced}
            fam_out["pooled"] = self._pool(kind, rows)
            out[name] = fam_out
        json.dumps(out)          # same contract as snapshot(): JSON-able
        return out

    @staticmethod
    def _coalesce(kind: str, rows: List[Dict[str, Any]]
                  ) -> Dict[str, Any]:
        labels = dict(_label_key({"overflow": "true"}))
        if kind == "histogram":
            merged = FederatedRegistry._pool("histogram", rows)
            return dict(merged, labels=labels)
        return {"labels": labels,
                "value": sum(float(r["value"]) for r in rows)}

    @staticmethod
    def _pool(kind: str, rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        """The family-level pooled row: merged denominators first, one
        division or quantile at the end (per-worker ratios are never
        averaged)."""
        if kind != "histogram":
            return {"value": sum(float(r["value"]) for r in rows)}
        buckets = _sum_buckets(rows)
        pooled: Dict[str, Any] = {
            "count": sum(int(r["count"]) for r in rows),
            "sum": round(sum(float(r["sum"]) for r in rows), 6)}
        for q in _metrics._PERCENTILES:
            p = percentile_from_buckets(buckets, q)
            if p is not None:
                pooled[f"p{int(q * 100)}"] = round(p, 6)
        pooled["buckets"] = buckets
        return pooled

    # -- readout -------------------------------------------------------

    def family_total(self, name: str) -> Optional[float]:
        """Pooled counter/gauge value (sum across workers and labels)."""
        fam = self.merged().get(name)
        if fam is None or fam["type"] == "histogram":
            return None
        return float(fam["pooled"]["value"])

    def pooled_percentile(self, name: str, q: float) -> Optional[float]:
        fam = self.merged().get(name)
        if fam is None or fam["type"] != "histogram":
            return None
        return percentile_from_buckets(fam["pooled"]["buckets"], q)

    def pooled_ratio(self, numerator: str,
                     denominator: str) -> Optional[float]:
        """sum(numerators) / sum(denominators) across the fleet — the
        only pooling that survives the hit-rate cross-check."""
        num, den = self.family_total(numerator), \
            self.family_total(denominator)
        if num is None or den is None or den == 0:
            return None
        return num / den

    def prometheus_text(self, prefix: str = "paddle_tpu_fleet") -> str:
        """Text exposition of the merged view.  A distinct prefix
        (default ``paddle_tpu_fleet``) keeps federated series from
        colliding with the serving process's own ``paddle_tpu_*``
        exposition when both are served from one /metrics page."""
        merged = self.merged()
        lines: List[str] = []
        for name in sorted(k for k in merged
                           if k not in ("schema_version", "workers")):
            fam = merged[name]
            base = _expo_name(name, prefix)
            if fam["type"] == "counter":
                base += "_total"
            if fam["help"]:
                lines.append(f"# HELP {base} "
                             f"{_metrics._expo_help(fam['help'])}")
            lines.append(f"# TYPE {base} {fam['type']}")
            for row in fam["series"]:
                if fam["type"] == "histogram":
                    for le, c in row["buckets"].items():
                        lines.append(
                            f"{base}_bucket"
                            f"{_expo_labels(row['labels'], le=le)} {c}")
                    lab = _expo_labels(row["labels"])
                    lines.append(f"{base}_sum{lab} "
                                 f"{_fmt_float(row['sum'])}")
                    lines.append(f"{base}_count{lab} {row['count']}")
                else:
                    lines.append(f"{base}{_expo_labels(row['labels'])} "
                                 f"{_fmt_float(row['value'])}")
        return "\n".join(lines) + "\n"


# -- merged Perfetto timeline ------------------------------------------------

_PLANE_PID = 1
_REQUESTS_PID = 2
_WORKER_PID0 = 10


def merge_perfetto(stitches: "OrderedDict[str, TransportStitch]",
                   records: "OrderedDict[int, List[Dict[str, Any]]]",
                   path: Optional[str] = None) -> Dict[str, Any]:
    """ONE Trace Event JSON timeline for the whole fleet, on the plane
    clock (ts in µs = plane ms × 1e3):

      * pid 1 "paddle_tpu plane" — one thread per worker transport;
        every completed RPC is an ``rpc.call`` slice [t0, t3] with two
        nested children: ``in_worker`` [t1', t2'] (server timestamps
        mapped through the worker's estimated offset, clamped into the
        parent) and ``wire`` covering the remainder of the round trip;
      * pid 10+k "paddle_tpu worker <name>" — the same handler
        execution from the worker's point of view (``worker.handle``
        slices on the plane clock), one process track per worker;
      * pid 2 "paddle_tpu requests" — tid = uid: every lifecycle event
        as an instant plus ``on <worker>`` slices from placement to
        migration/loss/retirement, so one track shows the request's
        router → worker → migration-hop journey.

    Everything here derives from stitch records and request-log
    timestamps — no wall-clock reads — so under simulated clocks two
    replays of the same trace serialize byte-identically."""
    meta: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": _PLANE_PID, "tid": 0,
         "args": {"name": "paddle_tpu plane"}},
        {"name": "process_name", "ph": "M", "pid": _REQUESTS_PID,
         "tid": 0, "args": {"name": "paddle_tpu requests"}}]
    events: List[Dict[str, Any]] = []
    dropped = 0
    for k, (wname, st) in enumerate(stitches.items()):
        wpid = _WORKER_PID0 + k
        meta.append({"name": "process_name", "ph": "M", "pid": wpid,
                     "tid": 0,
                     "args": {"name": f"paddle_tpu worker {wname}"}})
        meta.append({"name": "thread_name", "ph": "M", "pid": _PLANE_PID,
                     "tid": k + 1, "args": {"name": f"rpc:{wname}"}})
        meta.append({"name": "thread_name", "ph": "M", "pid": wpid,
                     "tid": 1, "args": {"name": "handler"}})
        off = st.estimator.offset_ms
        dropped += st.dropped
        for rec in st.records:
            t0, t3 = rec["t0"], rec["t3"]
            # server timestamps onto the plane clock, clamped into the
            # client's observed window (the offset is only ±RTT/2 true)
            t1p = min(max(rec["t1"] - off, t0), t3)
            t2p = min(max(rec["t2"] - off, t1p), t3)
            base = {"cat": "rpc", "ph": "X", "pid": _PLANE_PID,
                    "tid": k + 1}
            events.append(dict(
                base, name=f"rpc.call:{rec['method']}", ts=t0 * 1e3,
                dur=(t3 - t0) * 1e3,
                args={"method": rec["method"], "worker": wname,
                      "wire_ms": round((t3 - t0) - (t2p - t1p), 6),
                      "in_worker_ms": round(t2p - t1p, 6)}))
            events.append(dict(base, name="wire", ts=t0 * 1e3,
                               dur=(t1p - t0) * 1e3, args={}))
            events.append(dict(base, name="in_worker", ts=t1p * 1e3,
                               dur=(t2p - t1p) * 1e3, args={}))
            events.append(dict(base, name="wire", ts=t2p * 1e3,
                               dur=(t3 - t2p) * 1e3, args={}))
            events.append({
                "name": f"worker.handle:{rec['method']}", "cat": "rpc",
                "ph": "X", "pid": wpid, "tid": 1, "ts": t1p * 1e3,
                "dur": (t2p - t1p) * 1e3,
                "args": {"worker": wname, "method": rec["method"]}})
    for uid, rec in records.items():
        meta.append({"name": "thread_name", "ph": "M",
                     "pid": _REQUESTS_PID, "tid": uid,
                     "args": {"name": f"request {uid}"}})
        cur_worker: Optional[str] = None
        seg_start = 0.0
        for ev in rec:
            events.append({"name": ev["name"], "cat": "request",
                           "ph": "i", "s": "t", "ts": ev["t_ms"] * 1e3,
                           "pid": _REQUESTS_PID, "tid": uid,
                           "args": dict(ev["attrs"], uid=uid)})
            nm = ev["name"]
            hop = nm in ("placed", "migrated")
            if (hop or nm in ("worker_lost", "retired", "rejected")) \
                    and cur_worker is not None \
                    and ev["t_ms"] >= seg_start:
                events.append({
                    "name": f"on {cur_worker}", "cat": "request",
                    "ph": "X", "ts": seg_start * 1e3,
                    "dur": (ev["t_ms"] - seg_start) * 1e3,
                    "pid": _REQUESTS_PID, "tid": uid,
                    "args": {"uid": uid, "worker": cur_worker}})
                cur_worker = None
            if hop and ev["attrs"].get("worker") is not None:
                cur_worker = str(ev["attrs"]["worker"])
                seg_start = ev["t_ms"]
    trace = {"traceEvents": meta + events,
             "displayTimeUnit": "ms",
             "otherData": {"producer":
                           "paddle_tpu_torch.observability.federation",
                           "dropped_rpc_records": dropped}}
    if path is not None:
        import os
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


# -- fleet-obs signature -----------------------------------------------------

# per-process id attrs stripped from the canonical trace, mirroring
# request_log._SIGNATURE_SKIP: engine / router / replica ids are global
# counters, different on every run of the same seeded trace
_TRACE_ID_ATTRS = ("engine", "router", "replica")


def _canonical_trace(trace: Dict[str, Any]) -> Dict[str, Any]:
    """A uid- and process-id-free copy of a merged trace: request tids
    renumber in first-appearance order and per-process id attrs drop
    from event args.  Uids are correlation keys, not identities (the
    request-log contract), so two replays that mint different absolute
    uids must still hash equal."""
    remap: Dict[int, int] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("pid") == _REQUESTS_PID and ev.get("tid", 0) != 0:
            remap.setdefault(int(ev["tid"]), len(remap) + 1)
    out: List[Dict[str, Any]] = []
    for ev in trace.get("traceEvents", []):
        args = ev.get("args") or {}
        if any(k in args for k in _TRACE_ID_ATTRS) \
                or (ev.get("pid") == _REQUESTS_PID
                    and ev.get("tid") in remap):
            ev = dict(ev)
            args = {k: v for k, v in args.items()
                    if k not in _TRACE_ID_ATTRS}
            if ev.get("pid") == _REQUESTS_PID and ev.get("tid") in remap:
                n = remap[int(ev["tid"])]
                ev["tid"] = n
                if "uid" in args:
                    args["uid"] = n
                if str(args.get("name", "")).startswith("request "):
                    args["name"] = f"request {n}"
            ev["args"] = args
        out.append(ev)
    return dict(trace, traceEvents=out)


def _sig_labels(labels: Dict[str, str]) -> List[Tuple[str, str]]:
    # engine ids are per-process counters (different on every run, like
    # timeline_signature's _SIGNATURE_SKIP); worker names carry the
    # stable identity
    return sorted((k, v) for k, v in labels.items() if k != "engine")


def fleet_obs_signature(merged_trace: Dict[str, Any],
                        federated: Dict[str, Any],
                        fleet: Dict[str, Any]) -> str:
    """sha256 over the wall-free fleet observability state: the merged
    timeline (uid-normalised; deterministic under sim clocks), counter/
    gauge totals and histogram COUNTS from the federated snapshot
    (sums/percentiles are wall time), and the tick-counted health
    roster.  Two replays of the same seeded trace must produce equal
    signatures — the loadgen determinism contract extended to the
    fleet."""
    metrics_part: Dict[str, Any] = {}
    for name, fam in federated.items():
        if name in ("schema_version", "workers"):
            continue
        if fam["type"] == "histogram":
            metrics_part[name] = {
                "count": fam["pooled"]["count"],
                "series": [[_sig_labels(r["labels"]), r["count"]]
                           for r in fam["series"]]}
        else:
            metrics_part[name] = {
                "total": fam["pooled"]["value"],
                "series": [[_sig_labels(r["labels"]), r["value"]]
                           for r in fam["series"]]}
    health = {
        name: {"alive": w["alive"],
               "heartbeat_age_ticks": w["heartbeat_age_ticks"],
               "in_flight": w["in_flight"]}
        for name, w in fleet.get("workers", {}).items()}
    blob = json.dumps({"trace": _canonical_trace(merged_trace),
                       "metrics": metrics_part, "health": health},
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()
