"""Per-tick analytical roofline cost model (mirrors
``paddle_tpu/observability/costmodel.py``).

A serving tick must stream the model's weights once, fetch the KV cache
at the tick's live depths, do ``2 * n_params`` FLOPs a token position it
computes, and move whatever host <-> device block traffic preemption or
the host tier queued before it.  :class:`CostModel` composes those into
``predicted_tick_ms`` against a :class:`HardwareProfile` roofline and
attributes every measured tick to the bound it should sit on:

  * ``weight-stream``: the weight pass dominates the memory time,
  * ``kv-stream``: the KV fetch dominates the memory time,
  * ``compute``: FLOPs / peak exceed the memory time (large chunks,
    speculative verify windows),
  * ``comm``: per-step collective bytes dominate (0 without a mesh),
  * ``swap``: host <-> device block copies dominate.

:class:`TickAttribution` is the engine-facing half: it memoizes
predictions per (occupancy, depth bucket, chunk, window, swap) key (the
prediction is pure host math, so a steady-state server pays a dict lookup
a tick), records measured / predicted into ``perf.tick_model_ratio``
histograms labelled by bound, feeds the EWMA detectors
(:mod:`.regression`) and renders ``perf_report()`` with drift findings in
the reference's ``Finding`` shape (:class:`Finding`).

The measured side is the engine's tick wall time, stamped after the
tick's one host fetch; the prediction reads only host mirrors, so the
layer adds no device synchronisation.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import flags as _flags
from . import metrics as _metrics
from . import tracing as _tracing
from .regression import EwmaDetector

__all__ = [
    "HardwareProfile", "PROFILES", "resolve_profile",
    "CostModel", "TickAttribution", "kv_bytes_per_token",
    "perf_signature", "RATIO_BUCKETS", "Finding", "reset",
]

# measured/predicted ratio buckets: log-spaced and wide on purpose — the
# cpu_smoke profile's absolute predictions are not calibrated to host
# wall clock, so ratios land decades away from 1.0 and only their
# *stability* is meaningful.
RATIO_BUCKETS = (0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.5, 5.0, 10.0,
                 25.0, 50.0, 100.0, 250.0, 1000.0, 10000.0)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured finding, the shape of the reference's
    ``static_analysis.Finding``: ``rule``, ``severity`` (``error`` or
    ``warning``), ``path`` (where), ``message`` and ``bytes`` (at stake,
    where sized)."""

    rule: str
    severity: str
    path: str
    message: str
    bytes: Optional[int] = None

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"rule": self.rule, "severity": self.severity,
                             "path": self.path, "message": self.message}
        if self.bytes is not None:
            d["bytes"] = int(self.bytes)
        return d

    def __str__(self) -> str:
        b = f" [{self.bytes} bytes]" if self.bytes is not None else ""
        return (f"{self.rule}({self.severity}) "
                f"{self.path or '<signature>'}: {self.message}{b}")


_SEVERITY_ORDER = {"error": 0, "warning": 1}


def _sort_findings(findings: List[Finding]) -> List[Finding]:
    findings.sort(key=lambda f: (
        _SEVERITY_ORDER.get(f.severity, 2), f.rule, f.path,
        -1 if f.bytes is None else -int(f.bytes), f.message))
    return findings


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Roofline peaks for one accelerator generation.

    ``peak_bf16_flops``: dense bf16 FLOP/s; ``hbm_gbps``: HBM stream
    bandwidth in GB/s (decimal GB); ``ici_gbps``: per-device interconnect bandwidth in GB/s;
    ``host_gbps``: host <-> device memory bandwidth in GB/s, the KV
    swap / tiering link; 0 falls back to ``hbm_gbps``."""

    name: str
    peak_bf16_flops: float
    hbm_gbps: float
    ici_gbps: float
    host_gbps: float = 0.0

    @property
    def hbm_bps(self) -> float:
        return self.hbm_gbps * 1e9

    @property
    def ici_bps(self) -> float:
        return self.ici_gbps * 1e9

    @property
    def host_bps(self) -> float:
        return (self.host_gbps or self.hbm_gbps) * 1e9

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name,
                "peak_bf16_flops": self.peak_bf16_flops,
                "hbm_gbps": self.hbm_gbps,
                "ici_gbps": self.ici_gbps,
                "host_gbps": self.host_gbps}


# h100: NVIDIA H100 80GB HBM3 at a 700.00 W power limit (as nvidia-smi
# reports the card the port is measured on).  Dense bf16 tensor-core peak
# 989e12 FLOP/s and HBM3 3350 GB/s are the datasheet's; the host link
# 42 GB/s was measured over pinned memory (a 16.8 MB KV block in 0.3987 /
# 0.4046 ms each way, chip_smoke.py phase 4m, PERF.md).  The interconnect
# figure is the datasheet's nominal NVLink 900 GB/s, unmeasured: the port
# has no mesh yet (ROADMAP A8), so the comm term stays 0.
# cpu_smoke is deliberately tiny and round: the CPU tests exercise the
# model's arithmetic and determinism, where absolute milliseconds are
# meaningless and only ratios and bounds are gated (the reference's
# profile, unchanged, so both packages price a tick alike).
PROFILES: Dict[str, HardwareProfile] = {
    "h100": HardwareProfile("h100", peak_bf16_flops=989e12,
                            hbm_gbps=3350.0, ici_gbps=900.0,
                            host_gbps=42.0),
    "cpu_smoke": HardwareProfile("cpu_smoke", peak_bf16_flops=5e10,
                                 hbm_gbps=20.0, ici_gbps=2.0,
                                 host_gbps=4.0),
}


def resolve_profile(name: Optional[str] = None,
                    device: Any = None) -> HardwareProfile:
    """Resolve a profile name (default FLAGS_perf_model_profile):
    ``auto`` picks ``h100`` when ``device`` (default: the default
    device) is a CUDA device, ``cpu_smoke`` elsewhere."""
    name = str(name or _flags.flag("perf_model_profile"))
    if name == "auto":
        import torch
        if device is None:
            cuda = torch.cuda.is_available()
        else:
            cuda = torch.device(device).type == "cuda"
        name = "h100" if cuda else "cpu_smoke"
    try:
        return PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown hardware profile {name!r}; known: "
            f"{sorted(PROFILES)}") from None


def kv_bytes_per_token(config: Any, kv_dtype: str, *,
                       block_len: int = 0) -> float:
    """Device-memory bytes one live context token costs the decode KV
    fetch.

    Matches the engine's pool accounting (its block byte costs): per
    token ``L * 2 * Hkv * D`` elements; full precision pays
    the model's native itemsize, int8 pays 1 byte plus the per-block
    f32 scale row amortized over ``block_len`` tokens.  ``mixed`` keeps
    the device pool at native precision, so it streams full bytes."""
    c = config
    tok = int(c.num_hidden_layers) * 2 * int(c.num_key_value_heads) \
        * int(c.head_dim)
    native = _itemsize(c)
    if kv_dtype == "int8":
        scales = int(c.num_hidden_layers) * 2 * int(c.num_key_value_heads) * 4
        # contiguous int8 rows carry per-position scales too; default the
        # amortization granule to one position when there is no block
        return float(tok + scales / max(1, int(block_len)))
    return float(tok * native)


def _itemsize(config: Any) -> int:
    """Bytes of one element of the model dtype (``config.dtype``, a
    name such as ``"bfloat16"``)."""
    import torch
    dt = getattr(config, "torch_dtype", None)
    if not isinstance(dt, torch.dtype):
        dt = getattr(torch, str(config.dtype))
    return torch.empty((), dtype=dt).element_size()


_BOUNDS = ("weight-stream", "kv-stream", "compute", "comm", "swap")


def _bucket(n: int) -> int:
    """Round live-token counts up to the next power of two (floor 0):
    the memo key stays tiny while the KV term tracks depth within 2x."""
    n = int(n)
    if n <= 0:
        return 0
    return 1 << (n - 1).bit_length()


class CostModel:
    """The pure roofline: inputs are the engine's static byte/FLOP
    models, output is a per-term breakdown memoized per tick key."""

    def __init__(self, profile: HardwareProfile, *,
                 weight_bytes: int, n_params: int,
                 kv_token_bytes: float, num_slots: int,
                 comm_bytes_fn: Optional[Callable[[], int]] = None) -> None:
        self.profile = profile
        self.weight_bytes = int(weight_bytes)
        self.n_params = int(n_params)
        self.kv_token_bytes = float(kv_token_bytes)
        self.num_slots = int(num_slots)
        self._comm_bytes_fn = comm_bytes_fn
        self._comm_bytes: Optional[int] = None
        self._memo: Dict[Tuple[int, int, int, int, int],
                         Dict[str, Any]] = {}

    @property
    def comm_bytes_per_step(self) -> int:
        """Per-step collective bytes (0 without a mesh); computed lazily
        once."""
        if self._comm_bytes is None:
            self._comm_bytes = (int(self._comm_bytes_fn())
                                if self._comm_bytes_fn is not None else 0)
        return self._comm_bytes

    def predict(self, occ: int, live_tokens: int, chunk_tokens: int = 0,
                window: int = 1, swap_bytes: int = 0) -> Dict[str, Any]:
        """Roofline for one tick at the given occupancy / live context
        depth / prefill-chunk length / decode window (spec_k+1 under
        speculative decoding) / host↔HBM swap traffic (preemption
        swap-outs, tier demotions/promotions — exact bytes, not
        bucketed: swap volume is quantized to whole blocks already).
        Memoized per (occ, depth-bucket, chunk, window, swap); the
        returned dict is shared — treat it as frozen."""
        key = (int(occ), _bucket(live_tokens), int(chunk_tokens),
               int(window), int(swap_bytes))
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        p = self.profile
        # memory: the weight pass streams once per tick regardless of
        # occupancy (the step is static over num_slots rows); the KV
        # fetch scales with the live context depth (idle rows read one
        # block or none) and is dtype-aware through kv_token_bytes
        weight_ms = self.weight_bytes / p.hbm_bps * 1e3
        kv_ms = key[1] * self.kv_token_bytes / p.hbm_bps * 1e3
        # compute: dense decode GEMMs run over all num_slots rows
        # (masked, not skipped — static shapes), 2*N FLOPs per token
        # position; the chunk adds its prompt tokens on top.
        tokens = self.num_slots * max(1, int(window)) + int(chunk_tokens)
        compute_ms = 2.0 * self.n_params * tokens / p.peak_bf16_flops * 1e3
        comm_ms = self.comm_bytes_per_step / p.ici_bps * 1e3
        # swap: host <-> device block copies ride the host link and are
        # serialized against the tick's dispatch (the engine moves them
        # between dispatches), so they bound the tick when they dominate
        swap_ms = int(swap_bytes) / p.host_bps * 1e3
        hbm_ms = weight_ms + kv_ms
        predicted = max(hbm_ms, compute_ms, comm_ms, swap_ms)
        if predicted == hbm_ms:
            bound = "weight-stream" if weight_ms >= kv_ms else "kv-stream"
        elif predicted == compute_ms:
            bound = "compute"
        elif predicted == comm_ms:
            bound = "comm"
        else:
            bound = "swap"
        out = {"weight_stream_ms": weight_ms, "kv_stream_ms": kv_ms,
               "compute_ms": compute_ms, "comm_ms": comm_ms,
               "swap_ms": swap_ms,
               "predicted_ms": predicted, "bound": bound,
               "live_tokens_bucket": key[1]}
        self._memo[key] = out
        return out

    def predicted_tick_ms(self, occ: int, live_tokens: int,
                          chunk_tokens: int = 0, window: int = 1,
                          swap_bytes: int = 0) -> float:
        """Scalar convenience over :meth:`predict`: predictive admission
        needs only the tick's bounding milliseconds."""
        return float(self.predict(occ, live_tokens,
                                  chunk_tokens=chunk_tokens,
                                  window=window,
                                  swap_bytes=swap_bytes)["predicted_ms"])

    def memo_size(self) -> int:
        return len(self._memo)

    def clear(self) -> None:
        self._memo.clear()
        self._comm_bytes = None


# live TickAttribution instances, so observability.reset() can clear
# cost-model memos + detector state without owning engine lifecycles
_LIVE: "weakref.WeakSet[TickAttribution]" = weakref.WeakSet()


class TickAttribution:
    """Engine-side recorder: stamps ticks with the model's prediction,
    tracks measured/predicted per bound, and detects drift/anomalies."""

    #: EWMA parameters: the first ``skip`` ticks are discarded (a wave's
    #: first build of its step lands in an early measure window), the
    #: next ``warmup`` calibrate the
    #: per-bound baseline ratio, and the monitored EWMA must then stay
    #: inside [base/(1+tol), base*(1+tol)] (tol = FLAGS_perf_model_tol).
    SKIP = 2
    WARMUP = 8
    ALPHA = 0.25

    def __init__(self, model: CostModel, *, engine_id: str = "0",
                 registry: Optional[_metrics.MetricsRegistry] = None)\
            -> None:
        self.model = model
        self._eid = str(engine_id)
        self._reg = registry or _metrics.default_registry()
        self._lock = threading.Lock()
        self._hist: Dict[str, Any] = {}     # bound -> ratio histogram
        self._anom = self._reg.counter(
            "serving.perf_anomalies",
            "EWMA anomaly detections on perf streams, by kind "
            "(ttft|tpot|tick_ms|ratio) — regression.EwmaDetector")
        self._reset_state()
        _LIVE.add(self)

    # -- state ---------------------------------------------------------

    def _reset_state(self) -> None:
        tol = float(_flags.flag("perf_model_tol"))
        kw = dict(alpha=self.ALPHA, warmup=self.WARMUP, skip=self.SKIP)
        with self._lock:
            self.model.clear()
            self._ticks = 0
            self.last_ratio: Optional[float] = None
            self._measured_ms = 0.0
            self._bounds: Dict[str, Dict[str, float]] = {}
            self._terms = {"weight_stream_ms": 0.0, "kv_stream_ms": 0.0,
                           "compute_ms": 0.0, "comm_ms": 0.0,
                           "swap_ms": 0.0, "predicted_ms": 0.0}
            self._ratios: List[float] = []
            self._drift: Dict[str, Dict[str, Any]] = {}
            # one two-sided ratio detector per bound feeds the drift
            # findings; the one-sided stream detectors feed the
            # serving.perf_anomalies counters (latency regressions are
            # upward-only — getting faster is not an anomaly)
            self._ratio_det: Dict[str, EwmaDetector] = {}
            self._ratio_tol = tol
            self._stream_det = {
                kind: EwmaDetector(kind, tol=tol, **kw)
                for kind in ("ttft", "tpot", "tick_ms", "ratio")}

    def reset(self) -> None:
        """Clear memo, detectors, drift findings and accumulators
        (observability.reset() calls this on every live instance)."""
        self._reset_state()

    # -- per-tick ------------------------------------------------------

    def _ratio_hist(self, bound: str):
        h = self._hist.get(bound)
        if h is None:
            h = self._reg.histogram(
                "perf.tick_model_ratio",
                "measured/predicted tick time against the roofline "
                "cost model, labelled by the predicted bound",
                buckets=RATIO_BUCKETS).labels(engine=self._eid,
                                              bound=bound)
            self._hist[bound] = h
        return h

    def on_tick(self, measured_ms: float, *, occ: int, live_tokens: int,
                chunk_tokens: int = 0, window: int = 1,
                swap_bytes: int = 0) -> Dict[str, Any]:
        """Record one measured tick against its prediction.  Returns the
        prediction breakdown (shared memoized dict — do not mutate)."""
        pred = self.model.predict(occ, live_tokens, chunk_tokens, window,
                                  swap_bytes)
        bound = pred["bound"]
        ratio = float(measured_ms) / max(pred["predicted_ms"], 1e-12)
        with self._lock:
            self._ticks += 1
            self.last_ratio = ratio
            self._measured_ms += float(measured_ms)
            agg = self._bounds.setdefault(
                bound, {"ticks": 0, "predicted_ms_sum": 0.0})
            agg["ticks"] += 1
            agg["predicted_ms_sum"] += pred["predicted_ms"]
            for term in self._terms:
                self._terms[term] += pred[term]
            if len(self._ratios) < 65536:
                self._ratios.append(ratio)
            det = self._ratio_det.get(bound)
            if det is None:
                det = EwmaDetector(f"ratio[{bound}]", tol=self._ratio_tol,
                                   alpha=self.ALPHA, warmup=self.WARMUP,
                                   skip=self.SKIP, two_sided=True)
                self._ratio_det[bound] = det
            if det.observe(ratio) and bound not in self._drift:
                self._drift[bound] = {
                    "bound": bound, "tick": self._ticks,
                    "ewma": det.ewma, "baseline": det.baseline,
                    "lo": det.lo, "hi": det.hi}
        self._ratio_hist(bound).observe(ratio)
        for kind, v in (("tick_ms", float(measured_ms)), ("ratio", ratio)):
            if self._stream_det[kind].observe(v):
                self._anom.labels(engine=self._eid, kind=kind).inc()
        tracer = _tracing.get_tracer()
        tracer.counter("serving.tick_model",
                       predicted_ms=pred["predicted_ms"],
                       measured_ms=float(measured_ms))
        return pred

    def on_ttft(self, ms: float) -> None:
        if self._stream_det["ttft"].observe(float(ms)):
            self._anom.labels(engine=self._eid, kind="ttft").inc()

    def on_tpot(self, ms: float) -> None:
        if self._stream_det["tpot"].observe(float(ms)):
            self._anom.labels(engine=self._eid, kind="tpot").inc()

    # -- report --------------------------------------------------------

    def has_drift(self) -> bool:
        """Cheap per-tick probe for the control plane: True once any
        bound's ratio EWMA has left its calibrated band.  Predictive
        admission consults this before trusting a prediction — the
        full Finding rendering stays in :meth:`drift_findings`."""
        with self._lock:
            return bool(self._drift)

    def drift_findings(self) -> List[Any]:
        """Sticky drift findings in the reference's Finding shape: one
        per bound whose ratio EWMA left the calibrated band."""
        out = []
        with self._lock:
            for d in self._drift.values():
                out.append(Finding(
                    rule="perf-drift", severity="warning",
                    path=f"serving.step[engine={self._eid}]"
                         f"[bound={d['bound']}]",
                    message=(
                        f"measured/predicted ratio EWMA {d['ewma']:.3g} "
                        f"left the calibrated band "
                        f"[{d['lo']:.3g}, {d['hi']:.3g}] "
                        f"(baseline {d['baseline']:.3g}, "
                        f"tol {self._ratio_tol:g}) at tick {d['tick']}")))
        return _sort_findings(out)

    def report(self) -> Dict[str, Any]:
        """The perf_report() payload.  The ``predicted``/``bounds``
        side is a pure function of the deterministic schedule (byte-
        stable across replays of the same trace, and equal to the JAX
        package's over the same schedule — see ``perf_signature``); the
        ``ratio``/``measured_ms_sum`` side is wall clock."""
        with self._lock:
            ratios = sorted(self._ratios)
            bounds = {
                b: {"ticks": a["ticks"],
                    "predicted_ms_sum": round(a["predicted_ms_sum"], 6),
                    "share": round(a["ticks"] / max(1, self._ticks), 6)}
                for b, a in sorted(self._bounds.items())}
            terms = {k: round(v, 6) for k, v in sorted(self._terms.items())}
            ticks = self._ticks
            measured = self._measured_ms
        rep: Dict[str, Any] = {
            "profile": self.model.profile.as_dict(),
            "model_inputs": {
                "weight_bytes": self.model.weight_bytes,
                "n_params": self.model.n_params,
                "kv_bytes_per_token": round(self.model.kv_token_bytes, 6),
                "comm_bytes_per_step": self.model.comm_bytes_per_step,
                "num_slots": self.model.num_slots},
            "ticks_modeled": ticks,
            "bounds": bounds,
            "predicted_ms": terms,
            "memo_entries": self.model.memo_size(),
            "ratio": _percentiles(ratios),
            "measured_ms_sum": round(measured, 3),
            "drift": [f.as_dict() for f in self.drift_findings()],
            "anomalies": {k: d.anomalies
                          for k, d in sorted(self._stream_det.items())},
        }
        return rep


def _percentiles(ratios: List[float]) -> Dict[str, Any]:
    if not ratios:
        return {"count": 0}
    def q(p: float) -> float:
        i = min(len(ratios) - 1, int(p * len(ratios)))
        return round(ratios[i], 4)
    return {"count": len(ratios),
            "mean": round(sum(ratios) / len(ratios), 4),
            "p50": q(0.50), "p90": q(0.90), "p99": q(0.99)}


def perf_signature(report: Dict[str, Any]) -> str:
    """Canonical JSON of the deterministic side of a perf report: the
    profile, model inputs, tick count, per-bound predicted attribution
    and drift-finding count.  Two replays of the same deterministic
    trace must produce byte-identical signatures; wall-clock fields
    (ratio percentiles, measured_ms_sum, anomaly counts) are excluded."""
    sig = {"profile": report.get("profile", {}).get("name"),
           "model_inputs": report.get("model_inputs"),
           "ticks_modeled": report.get("ticks_modeled"),
           "bounds": report.get("bounds"),
           "predicted_ms": report.get("predicted_ms"),
           "drift": len(report.get("drift", []))}
    return json.dumps(sig, sort_keys=True, separators=(",", ":"))


def reset() -> None:
    """Clear memo + detector + drift state on every live
    TickAttribution (observability.reset() test isolation)."""
    for att in list(_LIVE):
        att.reset()
