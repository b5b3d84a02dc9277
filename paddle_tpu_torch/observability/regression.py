"""EWMA anomaly detector for runtime perf streams (mirrors the
``EwmaDetector`` of ``paddle_tpu/observability/regression.py``).

:class:`EwmaDetector` is a calibrate-then-monitor detector for one stream
(TTFT, TPOT, tick time, or the cost model's measured / predicted ratio):
the first ``skip`` samples are discarded (the first ticks pay one-time
builds), the next ``warmup`` samples average into a baseline, and from
then on an EWMA of the stream must stay inside
``[baseline / (1 + tol), baseline * (1 + tol)]``.  Latency streams watch
the upper side only (getting faster is not an anomaly); the cost model's
drift detectors watch both.  Detections feed the
``serving.perf_anomalies{kind=}`` counters through
:class:`.costmodel.TickAttribution`.

The reference module's other half, ``check_history`` (the offline gate
over committed ``BENCH_*.json`` files), waits for the port's first
accepted benchmark: the committed files hold the JAX package's numbers
on a TPU, which no run of the port can be held to.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional

__all__ = ["EwmaDetector", "reset"]


_LIVE: "weakref.WeakSet[EwmaDetector]" = weakref.WeakSet()


class EwmaDetector:
    """Calibrate-then-monitor EWMA threshold detector on one stream."""

    def __init__(self, kind: str, *, tol: float, alpha: float = 0.25,
                 warmup: int = 8, skip: int = 2,
                 two_sided: bool = False) -> None:
        self.kind = str(kind)
        self.tol = float(tol)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.skip = int(skip)
        self.two_sided = bool(two_sided)
        self.reset()
        _LIVE.add(self)

    def reset(self) -> None:
        self.seen = 0
        self.baseline: Optional[float] = None
        self.ewma: Optional[float] = None
        self.anomalies = 0
        self._cal: List[float] = []

    @property
    def lo(self) -> float:
        base = self.baseline or 0.0
        return base / (1.0 + self.tol)

    @property
    def hi(self) -> float:
        base = self.baseline or 0.0
        return base * (1.0 + self.tol)

    def observe(self, v: float) -> bool:
        """Feed one sample; True when the post-calibration EWMA sits
        outside the band at this sample."""
        v = float(v)
        self.seen += 1
        if self.seen <= self.skip:
            return False
        if self.baseline is None:
            self._cal.append(v)
            if len(self._cal) >= self.warmup:
                self.baseline = sum(self._cal) / len(self._cal)
                self.ewma = self.baseline
                self._cal = []
            return False
        self.ewma = (1.0 - self.alpha) * self.ewma + self.alpha * v
        bad = self.ewma > self.hi or (self.two_sided and self.ewma < self.lo)
        if bad:
            self.anomalies += 1
        return bad

    def state(self) -> Dict[str, Any]:
        return {"kind": self.kind, "seen": self.seen,
                "baseline": self.baseline, "ewma": self.ewma,
                "anomalies": self.anomalies, "tol": self.tol,
                "two_sided": self.two_sided}


def reset() -> None:
    """Reset every live detector (observability.reset())."""
    for det in list(_LIVE):
        det.reset()
