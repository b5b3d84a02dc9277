"""Predictive SLO admission: the control plane's pricing layer (mirrors
``paddle_tpu/serving/admission.py``).

The reactive engine admits on queue depth alone and repairs mistakes
after the fact (preemption).  This module turns the engine's roofline
cost model into a question asked *before* placement: will admitting this
prompt at this replica's current occupancy, depth and backlog blow the
pooled TPOT / TTFT SLO?  Two pieces:

* :func:`place_verdict` prices one candidate placement against the
  engine's :meth:`~paddle_tpu_torch.serving.engine.ServingEngine.
  admission_probe`: ``admit`` when the predicted post-admission tick
  (calibrated into wall ms by ``FLAGS_serving_admission_calib``) fits
  every armed deadline with ``FLAGS_serving_admission_slack`` headroom,
  else ``defer`` with a *price* (the worst predicted overage in ms);

* :class:`HoldQueue` is the priced deferral queue the router parks
  deferred requests in instead of rejecting them: entries pop by (aged
  first, priority class, price, arrival).  Priority classes outrank
  pricing, the cheapest request within a class goes first, and an entry
  older than ``FLAGS_serving_admission_max_defer_ticks`` jumps the whole
  line (aging beats pricing: the queue never starves).

Decisions are pure functions of scheduler state (no wall clock), so twin
replays of one trace hold and place identically: the fleet simulator and
the loadgen smoke lean on that.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional

from .. import flags as _flags

__all__ = ["Verdict", "place_verdict", "HoldEntry", "HoldQueue"]


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One priced placement decision.  ``verdict`` is ``admit`` or
    ``defer``; ``price`` is the worst predicted SLO overage in wall ms (0
    for admit), the hold queue's order within a priority class;
    ``reason`` names the deciding rule."""

    verdict: str
    predicted_tpot_ms: float = 0.0
    predicted_ttft_ms: float = 0.0
    price: float = 0.0
    reason: str = ""


def place_verdict(engine, prompt_len: int, *,
                  ttft_slo_ms: float = 0.0,
                  tpot_slo_ms: float = 0.0) -> Verdict:
    """Price placing one more ``prompt_len``-token request on ``engine``.
    Admits unconditionally when the engine has no cost model
    (``FLAGS_perf_model`` off: the reactive policy is the fallback) or the
    request carries no armed deadline (batch traffic is not starved by a
    gate it never asked for; the pooled guard is the engine's own
    ``_admission_defer``)."""
    probe = engine.admission_probe(int(prompt_len))
    if probe is None:
        return Verdict("admit", reason="no_model")
    calib = float(_flags.flag("serving_admission_calib"))
    tpot = probe["predicted_tpot_ms"] * calib
    ttft = probe["predicted_ttft_ms"] * calib
    if ttft_slo_ms <= 0 and tpot_slo_ms <= 0:
        return Verdict("admit", tpot, ttft, reason="no_deadline")
    slack = float(_flags.flag("serving_admission_slack"))
    price = 0.0
    if tpot_slo_ms > 0:
        price = max(price, tpot - tpot_slo_ms * slack)
    if ttft_slo_ms > 0:
        price = max(price, ttft - ttft_slo_ms * slack)
    if price > 0:
        return Verdict("defer", tpot, ttft, price, "predicted_slo")
    return Verdict("admit", tpot, ttft, reason="fits")


@dataclasses.dataclass(eq=False)
class HoldEntry:
    """One deferred request in the hold queue.  ``payload`` is the owner's
    placement state (the router keeps the prompt, sampling and session
    there); ``seq`` is the arrival tiebreak.  Identity equality: the queue
    removes entries by identity, and payloads may hold numpy arrays."""

    payload: Any
    priority: int = 0
    price: float = 0.0
    seq: int = 0
    defer_ticks: int = 0


class HoldQueue:
    """The priced deferral queue.  Pop order: aged entries first (in
    arrival order: FIFO among the starving), then by descending priority
    class, ascending price, arrival.  ``tick()`` ages every entry once a
    scheduler tick; the owner re-prices entries it fails to place."""

    def __init__(self, max_defer_ticks: Optional[int] = None) -> None:
        self._max_defer = max_defer_ticks
        self._entries: List[HoldEntry] = []
        self._seq = 0

    @property
    def max_defer_ticks(self) -> int:
        if self._max_defer is not None:
            return int(self._max_defer)
        return int(_flags.flag("serving_admission_max_defer_ticks"))

    def push(self, payload: Any, *, priority: int = 0,
             price: float = 0.0) -> HoldEntry:
        e = HoldEntry(payload, priority=int(priority), price=float(price),
                      seq=self._seq)
        self._seq += 1
        self._entries.append(e)
        return e

    def aged(self, e: HoldEntry) -> bool:
        """True once ``e`` waited past the starvation bound: the owner
        places it whatever the SLO prediction says."""
        maxd = self.max_defer_ticks
        return maxd > 0 and e.defer_ticks >= maxd

    def _key(self, e: HoldEntry):
        return (0 if self.aged(e) else 1,
                e.seq if self.aged(e) else 0,
                -e.priority, e.price, e.seq)

    def ordered(self) -> List[HoldEntry]:
        """Entries in pop order, without removing them (the owner walks
        this each tick and removes what it placed)."""
        return sorted(self._entries, key=self._key)

    def remove(self, entry: HoldEntry) -> None:
        self._entries.remove(entry)

    def tick(self) -> None:
        for e in self._entries:
            e.defer_ticks += 1

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[HoldEntry]:
        return iter(self._entries)

    def snapshot(self) -> List[Dict[str, Any]]:
        return [{"priority": e.priority, "price": round(e.price, 6),
                 "seq": e.seq, "defer_ticks": e.defer_ticks,
                 "aged": self.aged(e)} for e in self.ordered()]
