"""Metrics registry: counters, gauges, histograms
(mirrors ``paddle_tpu/observability/metrics.py``).

The Prometheus data model, host-side and dependency-free: a registry holds
metric *families* (one per dotted name, e.g. ``serving.ttft_ms``), each
family holds labelled *children* (``engine="0"``), and every child is O(1)
to update under one registry lock: one lock and one float add an event, no
device work, cheap enough for the serving engine's tick.

Two export surfaces:

  * :meth:`MetricsRegistry.snapshot`: a JSON-able dict (what tests and
    ``chip_smoke.py`` read);
  * :meth:`MetricsRegistry.prometheus_text`: the text exposition format
    (``paddle_tpu_serving_ttft_ms_bucket{engine="0",le="5"} 3``).

Both are byte-identical to the JAX package's over the same sequence of
operations: the series names, the exposition prefix ``paddle_tpu_`` and
the row layout are the reference's, so a dashboard reads either package.

Histograms are fixed-bucket (Prometheus-style cumulative ``le`` bounds)
with percentile readout by linear interpolation inside the bucket, the
estimate ``histogram_quantile`` computes server-side.

Naming: dotted lowercase names, ``_ms`` suffix for millisecond
histograms; exposition mangles dots to underscores and prefixes
``paddle_tpu_``; counters gain the ``_total`` suffix Prometheus expects.
"""

from __future__ import annotations

import json
import math
import re
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "LATENCY_BUCKETS_MS", "SNAPSHOT_SCHEMA_VERSION",
           "default_registry", "snapshot", "prometheus_text", "reset"]

# bump when the snapshot() row shape changes; consumers key on it, so
# diffs of two snapshots are attributable
SNAPSHOT_SCHEMA_VERSION = 1

# decade-ish spread covering sub-ms kernel dispatch through multi-second
# CPU-interpret prefills; +Inf is implicit
LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)

_PERCENTILES = (0.5, 0.9, 0.99)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Child:
    """One labelled time series.  Shares its family's registry lock."""

    __slots__ = ("_family", "labels")

    def __init__(self, family: "_Family", labels: Dict[str, str]):
        self._family = family
        self.labels = labels

    @property
    def _lock(self):
        return self._family._lock


class Counter(_Child):
    __slots__ = ("_value",)

    def __init__(self, family, labels):
        super().__init__(family, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> float:
        """Add ``n`` (must be >= 0); returns the new value."""
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        with self._lock:
            self._value += n
            return self._value

    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Child):
    __slots__ = ("_value",)

    def __init__(self, family, labels):
        super().__init__(family, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Child):
    __slots__ = ("_counts", "_sum", "_count")

    def __init__(self, family, labels):
        super().__init__(family, labels)
        # one slot per finite bound + the +Inf overflow slot
        self._counts = [0] * (len(family.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        bounds = self._family.buckets
        i = 0
        while i < len(bounds) and v > bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """Quantile estimate (``q`` in [0, 1]) by linear interpolation
        inside the owning bucket — ``histogram_quantile`` semantics.
        ``None`` on an empty histogram; values in the +Inf bucket clamp
        to the largest finite bound."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        bounds = self._family.buckets
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return None
        rank = min(max(q * total, 1e-9), float(total))
        cum = 0
        lower = 0.0
        for i, c in enumerate(counts):
            prev = cum
            cum += c
            if prev < rank <= cum:
                if i >= len(bounds):          # +Inf bucket: clamp
                    return float(lower)
                upper = bounds[i]
                return lower + (upper - lower) * (rank - prev) / c
            if i < len(bounds):
                lower = bounds[i]
        return float(lower)

    def bucket_counts(self) -> Dict[str, int]:
        """CUMULATIVE counts keyed by the bucket's ``le`` bound."""
        bounds = self._family.buckets
        with self._lock:
            counts = list(self._counts)
        out: Dict[str, int] = {}
        cum = 0
        for b, c in zip(bounds, counts):
            cum += c
            out[_fmt_float(b)] = cum
        out["+Inf"] = cum + counts[-1]
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """All children of one metric name (shared kind/help/buckets)."""

    __slots__ = ("name", "kind", "help", "buckets", "_children", "_lock",
                 "coalesced", "_overflow_warned")

    def __init__(self, name: str, kind: str, help: str,
                 buckets: Optional[Sequence[float]], lock):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = tuple(buckets) if buckets is not None else None
        self._children: Dict[Tuple, _Child] = {}
        self._lock = lock
        self.coalesced = 0             # label sets routed to overflow
        self._overflow_warned = False

    def labels(self, **labels: Any) -> _Child:
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                # label-cardinality guard: a family past
                # FLAGS_metrics_max_children distinct label sets warns
                # once and coalesces every further NEW label set into a
                # single {overflow="true"} child, so per-uid/per-shape
                # labels can never grow the registry unboundedly.
                # Existing children keep resolving normally.
                from .. import flags as _flags
                cap = int(_flags.flag("metrics_max_children"))
                if cap > 0 and len(self._children) >= cap \
                        and labels.get("overflow") != "true":
                    self.coalesced += 1
                    if not self._overflow_warned:
                        self._overflow_warned = True
                        warnings.warn(
                            f"metric family {self.name!r} hit the "
                            f"label-cardinality cap ({cap} children); "
                            f"coalescing new label sets into "
                            f"{{overflow='true'}} "
                            f"(FLAGS_metrics_max_children)",
                            RuntimeWarning, stacklevel=3)
                    okey = _label_key({"overflow": "true"})
                    child = self._children.get(okey)
                    if child is None:
                        child = _KINDS[self.kind](self, dict(okey))
                        self._children[okey] = child
                    return child
                child = _KINDS[self.kind](self, dict(key))
                self._children[key] = child
            return child

    # the family itself proxies to its unlabelled child, so call sites
    # without label needs stay one-liners
    def inc(self, n: float = 1.0):
        return self.labels().inc(n)

    def set(self, v: float):
        return self.labels().set(v)

    def dec(self, n: float = 1.0):
        return self.labels().dec(n)

    def observe(self, v: float):
        return self.labels().observe(v)

    def value(self, **labels: Any) -> float:
        return self.labels(**labels).value()

    def children(self) -> List[_Child]:
        with self._lock:
            return list(self._children.values())


class MetricsRegistry:
    """Thread-safe registry of metric families.

    ``counter``/``gauge``/``histogram`` are idempotent declarations: the
    first call creates the family, later calls return it (and re-declare
    with a conflicting kind or bucket layout raise, so two subsystems
    cannot silently share a name with different meanings).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help: str,
                buckets: Optional[Sequence[float]] = None) -> _Family:
        if not name or not re.match(r"^[a-zA-Z_][a-zA-Z0-9_.]*$", name):
            raise ValueError(f"bad metric name {name!r} (use dotted "
                             f"lowercase identifiers)")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, buckets, self._lock)
                self._families[name] = fam
            else:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {kind}")
                if (kind == "histogram" and buckets is not None
                        and fam.buckets != tuple(buckets)):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"different buckets")
            return fam

    def counter(self, name: str, help: str = "") -> _Family:
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> _Family:
        return self._family(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS) -> _Family:
        return self._family(name, "histogram", help, buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def reset(self) -> None:
        """Drop every family (test isolation; children held by live
        objects keep working but stop being exported)."""
        with self._lock:
            self._families.clear()

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump of every series: counters/gauges as values,
        histograms with count/sum/percentiles/cumulative buckets.

        Deterministically ordered (families sorted by name, series by
        label items, ``schema_version`` first) so two snapshots of the
        same state serialize byte-identically."""
        with self._lock:
            families = list(self._families.values())
        out: Dict[str, Any] = {"schema_version": SNAPSHOT_SCHEMA_VERSION}
        for fam in sorted(families, key=lambda f: f.name):
            series = []
            for child in fam.children():
                row: Dict[str, Any] = {"labels": dict(child.labels)}
                if fam.kind == "histogram":
                    row["count"] = child.count
                    row["sum"] = round(child.sum, 6)
                    for q in _PERCENTILES:
                        p = child.percentile(q)
                        if p is not None:
                            row[f"p{int(q * 100)}"] = round(p, 6)
                    row["buckets"] = child.bucket_counts()
                else:
                    row["value"] = child.value()
                series.append(row)
            series.sort(key=lambda r: sorted(r["labels"].items()))
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        json.dumps(out)  # guarantee the contract (catches NaN/Inf early)
        return out

    def prometheus_text(self, prefix: str = "paddle_tpu") -> str:
        """Prometheus/OpenMetrics text exposition of every series."""
        with self._lock:
            families = list(self._families.values())
        lines: List[str] = []
        for fam in sorted(families, key=lambda f: f.name):
            base = _expo_name(fam.name, prefix)
            if fam.kind == "counter":
                base += "_total"
            if fam.help:
                lines.append(f"# HELP {base} {_expo_help(fam.help)}")
            lines.append(f"# TYPE {base} {fam.kind}")
            for child in fam.children():
                if fam.kind == "histogram":
                    for le, c in child.bucket_counts().items():
                        lines.append(f"{base}_bucket"
                                     f"{_expo_labels(child.labels, le=le)}"
                                     f" {c}")
                    lab = _expo_labels(child.labels)
                    lines.append(f"{base}_sum{lab} {_fmt_float(child.sum)}")
                    lines.append(f"{base}_count{lab} {child.count}")
                else:
                    lines.append(f"{base}{_expo_labels(child.labels)} "
                                 f"{_fmt_float(child.value())}")
        return "\n".join(lines) + "\n"


def _expo_name(name: str, prefix: str) -> str:
    return f"{prefix}_" + re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _expo_help(text: str) -> str:
    # exposition format: HELP text escapes backslash and newline (a raw
    # newline would terminate the comment mid-text and corrupt the scrape)
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _expo_value(v: str) -> str:
    # label values escape backslash, newline AND double-quote
    return (v.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _expo_labels(labels: Dict[str, str], le: Optional[str] = None) -> str:
    items = sorted(labels.items())
    if le is not None:
        items.append(("le", le))
    if not items:
        return ""
    body = ",".join('{}="{}"'.format(k, _expo_value(v))
                    for k, v in items)
    return "{" + body + "}"


def _fmt_float(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


# -- module-level default registry ------------------------------------------

_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem reports into."""
    return _default


def snapshot() -> Dict[str, Any]:
    return _default.snapshot()


def prometheus_text() -> str:
    return _default.prometheus_text()


def reset() -> None:
    _default.reset()
