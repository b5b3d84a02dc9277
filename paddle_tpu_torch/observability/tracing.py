"""Host-side span tracer with Chrome-trace / Perfetto JSON export
(mirrors ``paddle_tpu/observability/tracing.py``).

Nestable spans opened on the host (the scheduler tick, an admission wave,
the decode step's dispatch and its one host fetch) are recorded as
complete events (``{"ph": "X", "ts", "dur", "pid", "tid", ...}``,
microseconds) in the Trace Event format that chrome://tracing and
https://ui.perfetto.dev load directly.  Nesting needs no parent pointers:
Perfetto stacks events on one tid by ts/dur containment, which the
context-manager discipline guarantees.

The tracer is host-only.  On the card a span around a graph replay ends
after the tick's one host fetch, so it covers the device work of that
tick; no span reads a CUDA tensor or synchronises the device.  (The
reference's ``profiler.RecordEvent``, which pairs a host span with a
device annotation, is ROADMAP A10.)

Cost: recording one span is two ``perf_counter_ns`` calls and one deque
append under a lock.  The buffer is a ring (``FLAGS_trace_buffer_events``):
a long-running server keeps the most recent window and counts what it
dropped (the ``obs.trace_dropped_events`` gauge).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from collections import deque

__all__ = ["SpanTracer", "get_tracer", "span", "instant", "counter",
           "export_chrome_trace"]


class _OpenSpan:
    __slots__ = ("name", "cat", "args", "ts", "tid")

    def __init__(self, name: str, cat: str, args: Dict[str, Any],
                 ts: float, tid: int):
        self.name = name
        self.cat = cat
        self.args = args
        self.ts = ts
        self.tid = tid


class SpanTracer:
    """Collects host spans into a bounded ring buffer.

    ``span(name, **args)`` is the context-manager form; ``start`` /
    ``finish`` are the split form for callers with begin/end APIs.
    ``enabled=False`` turns both into no-ops.
    """

    def __init__(self, max_events: Optional[int] = None,
                 enabled: Optional[bool] = None):
        from .. import flags as _flags
        if max_events is None:
            max_events = int(_flags.flag("trace_buffer_events"))
        if enabled is None:
            enabled = bool(_flags.flag("observability_spans"))
        self.enabled = enabled
        self.max_events = max(1, int(max_events))
        self.dropped = 0
        self._events: "deque[Dict[str, Any]]" = deque()
        self._lock = threading.Lock()
        self._pid = os.getpid()
        # one wall-clock origin per tracer so every span shares a timebase
        self._t0 = time.perf_counter_ns()

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    # -- recording ---------------------------------------------------------

    def start(self, name: str, cat: str = "host",
              **args: Any) -> Optional[_OpenSpan]:
        if not self.enabled:
            return None
        return _OpenSpan(name, cat, args, self._now_us(),
                         threading.get_ident())

    def finish(self, span: Optional[_OpenSpan]) -> None:
        if span is None or not self.enabled:
            return
        ev = {"name": span.name, "cat": span.cat, "ph": "X",
              "ts": span.ts, "dur": self._now_us() - span.ts,
              "pid": self._pid, "tid": span.tid}
        if span.args:
            ev["args"] = span.args
        self._append(ev)

    @contextmanager
    def span(self, name: str, cat: str = "host", **args: Any):
        s = self.start(name, cat, **args)
        try:
            yield s
        finally:
            self.finish(s)

    def instant(self, name: str, cat: str = "host", **args: Any) -> None:
        """Zero-duration marker (eviction, admission rejection, ...)."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._now_us(), "pid": self._pid,
              "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._append(ev)

    def counter(self, name: str, cat: str = "host",
                **values: Any) -> None:
        """Chrome-trace counter sample (ph "C"): one numeric series per
        kwarg, rendered as stacked counter tracks in Perfetto.  The
        cost model emits ``serving.tick_model`` predicted/measured
        samples here every tick, riding next to the ``serving.step``
        spans."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "C",
              "ts": self._now_us(), "pid": self._pid,
              "tid": threading.get_ident(),
              "args": {k: float(v) for k, v in values.items()}}
        self._append(ev)

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self._events.popleft()
                self.dropped += 1
                overflowed = True
            else:
                overflowed = False
            self._events.append(ev)
        if overflowed:
            self._mirror_dropped()

    def _mirror_dropped(self) -> None:
        """Publish ``dropped`` as the ``obs.trace_dropped_events``
        gauge so a wrapped ring can't masquerade as a complete timeline
        in ``snapshot()`` — previously it was counted in the
        ``export_chrome_trace`` metadata only.  Only the process-default
        tracer publishes: private tracers in tests must not clobber the
        fleet count.  Called outside the ring lock (the registry has its
        own)."""
        if _tracer is not self:
            return
        from .metrics import default_registry
        default_registry().gauge(
            "obs.trace_dropped_events",
            "span-tracer ring evictions since start/reset; nonzero "
            "means exported timelines are a recent-window suffix, not "
            "the whole story").set(float(self.dropped))

    # -- readout -----------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
        # re-register the gauge at 0 so every snapshot() taken after a
        # reset still carries the (zero) drop count
        self._mirror_dropped()

    def export_chrome_trace(self, path: Optional[str] = None
                            ) -> Dict[str, Any]:
        """Trace Event JSON (object form).  Loads in Perfetto /
        chrome://tracing as-is; ``path`` additionally writes the file."""
        events = self.events()
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": "paddle_tpu_torch host"}}]
        for tid in sorted({e["tid"] for e in events}):
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": self._pid, "tid": tid,
                         "args": {"name": f"host-thread-{tid}"}})
        trace = {"traceEvents": meta + events,
                 "displayTimeUnit": "ms",
                 "otherData": {"producer": "paddle_tpu_torch.observability",
                               "dropped_events": self.dropped}}
        if path is not None:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace


# -- module-level default tracer --------------------------------------------

_tracer: Optional[SpanTracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> SpanTracer:
    """The process-wide tracer every subsystem records into (created
    lazily so FLAGS_* read their environment overrides first)."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = SpanTracer()
                _tracer._mirror_dropped()
    return _tracer


def span(name: str, cat: str = "host", **args: Any):
    return get_tracer().span(name, cat, **args)


def instant(name: str, cat: str = "host", **args: Any) -> None:
    get_tracer().instant(name, cat, **args)


def counter(name: str, cat: str = "host", **values: Any) -> None:
    get_tracer().counter(name, cat, **values)


def export_chrome_trace(path: Optional[str] = None) -> Dict[str, Any]:
    return get_tracer().export_chrome_trace(path)
