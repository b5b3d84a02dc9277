"""Observability of the port (mirrors ``paddle_tpu/observability``): the
serving engine's telemetry as a layer, not as per-module counters.

  * :mod:`.metrics`: a thread-safe registry of counters, gauges and
    fixed-bucket histograms with percentile readout, exported as a JSON
    snapshot or Prometheus text.  The ServingEngine (TTFT, TPOT, queue
    wait, occupancy, lifecycle counts), the BlockManager (pool occupancy,
    prefix hits, evictions, copy-on-write, the host tier) and the ops
    dispatch (kernel routes) all report here, so ``snapshot()`` after a
    serving run is the whole story in one dict;
  * :mod:`.tracing`: a host-side span tracer with Chrome-trace / Perfetto
    export (``serving.step``, ``serving.decode``, ``serving.prefill``,
    ...);
  * :mod:`.request_log`: per-request lifecycle timelines keyed by a uid
    minted at ``submit()``, with Perfetto export (one track a request) and
    ``slo_report()``;
  * :mod:`.costmodel`: the per-tick roofline (``cpu_smoke`` and ``h100``
    profiles) behind ``ServingEngine.perf_report()``, with the EWMA drift
    detectors of :mod:`.regression`;
  * :mod:`.watchdog`: ``track_retraces``, per-site build counting with a
    budget.

Conventions: metric names are dotted lowercase (``serving.ttft_ms``);
millisecond histograms carry the ``_ms`` suffix; per-instance series are
told apart by labels (``engine="0"``, ``pool="1"``), never by name.
:mod:`.http_exposition` serves the registry, the engines' liveness, the
request log and a multihost plane's fleet over HTTP
(``FLAGS_metrics_port``); :mod:`.federation` merges the plane's worker
registries and clocks into one fleet view.  The reference's
``check_history`` gate waits for the port's first benchmark (its
committed ``BENCH_*.json`` files hold the JAX package's TPU numbers);
``profiler.RecordEvent`` is A10.
"""

from .costmodel import (CostModel, Finding, HardwareProfile, PROFILES,
                        TickAttribution, kv_bytes_per_token, perf_signature,
                        resolve_profile)
from .costmodel import reset as _reset_costmodel
from . import metrics as _metrics_mod
from .metrics import (Counter, Gauge, Histogram, LATENCY_BUCKETS_MS,
                      MetricsRegistry, SNAPSHOT_SCHEMA_VERSION,
                      prometheus_text, snapshot)
from .metrics import reset as _reset_metrics
from .regression import EwmaDetector
from .regression import reset as _reset_regression
from .request_log import RequestLog, get_request_log
from .tracing import (SpanTracer, counter, export_chrome_trace, get_tracer,
                      instant, span)
from .watchdog import (RetraceError, RetraceWarning, TrackedFunction,
                       track_retraces)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "LATENCY_BUCKETS_MS", "SNAPSHOT_SCHEMA_VERSION", "default_registry",
    "snapshot", "prometheus_text", "reset",
    "SpanTracer", "get_tracer", "span", "instant", "counter",
    "export_chrome_trace",
    "RequestLog", "get_request_log",
    "RetraceError", "RetraceWarning", "TrackedFunction", "track_retraces",
    "HardwareProfile", "PROFILES", "resolve_profile", "CostModel",
    "TickAttribution", "kv_bytes_per_token", "perf_signature", "Finding",
    "EwmaDetector",
]


def default_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem reports into.

    Delegates through the :mod:`.metrics` module attribute (rather than
    binding the function at import), so a test that monkeypatches
    ``metrics.default_registry`` redirects every
    ``observability.default_registry()`` call site too."""
    return _metrics_mod.default_registry()


def reset() -> None:
    """Clear the default registry, the default tracer's buffer, the
    default request log and every live cost-model / detector state (test
    and phase isolation; live metric handles keep working but stop being
    exported until re-registered)."""
    _reset_metrics()
    get_tracer().clear()
    get_request_log().clear()
    _reset_costmodel()
    _reset_regression()
