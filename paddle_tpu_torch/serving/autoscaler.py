"""Replica autoscaling against the predictive control plane (mirrors
``paddle_tpu/serving/autoscaler.py``).

:class:`ReplicaAutoscaler` wraps a :class:`~paddle_tpu_torch.serving.
router.ReplicaRouter` and turns the control plane's pressure signals into
replica decisions:

* **scale up** when pressure persists: the router's hold queue is not
  empty (every candidate priced the next placement over the pooled SLO)
  or the fleet's demand runs past the high water mark;
* **scale down** when slack persists: demand would fit on one replica
  fewer.  Shrinking drains before it retires: the chosen replica takes no
  NEW placements but serves its queue and pinned sessions, and retires
  once empty.  Pressure arriving mid-drain undrains instead of building a
  replica (the cheapest capacity is the one still running).

Hysteresis: a signal must persist ``FLAGS_serving_autoscale_min_ticks``
consecutive ``observe()`` ticks, and two actions lie at least
``FLAGS_serving_autoscale_cooldown`` ticks apart.  Decisions are pure
functions of scheduler state (no wall clock), so fleet-simulator replays
of one trace scale identically; the tests drive the loop over
:class:`~paddle_tpu_torch.serving.fleet_sim.SimEngine` replicas.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .. import flags as _flags
from .. import observability as _obs
from .router import ReplicaRouter

__all__ = ["ReplicaAutoscaler"]


class ReplicaAutoscaler:
    """Drive ``router`` elastic from control-plane pressure and slack.

    Call :meth:`observe` once a router tick (after ``router.step()``).
    ``engine_factory`` builds one replica for a scale-up; a router built
    from a model carries its own factory.  ``high`` / ``low`` are the
    demand-per-slot water marks (demand = active + queued + pending +
    preempted + held)."""

    def __init__(self, router: ReplicaRouter, *,
                 min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 engine_factory: Optional[Callable[[], Any]] = None,
                 high: float = 0.9, low: float = 0.4) -> None:
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not 0.0 <= low < high:
            raise ValueError("need 0 <= low < high")
        self.router = router
        self.min_replicas = int(min_replicas)
        self.max_replicas = (int(max_replicas)
                             if max_replicas is not None else None)
        self._factory = engine_factory
        self.high = float(high)
        self.low = float(low)
        self._pressure_ticks = 0
        self._slack_ticks = 0
        self._since_action = 10 ** 9    # the first decision is not damped
        self._actions: List[Dict[str, Any]] = []
        self._tick = 0
        reg = _obs.default_registry()
        self._f_actions = reg.counter(
            "autoscaler.actions",
            "ReplicaAutoscaler decisions by kind: add (new replica "
            "built), undrain (draining replica returned to service), "
            "drain (replica excluded from new placements), retire "
            "(empty drained replica left the tick loop)")

    # -- signals -------------------------------------------------------------

    def _serving(self) -> List[int]:
        """Replicas taking NEW placements (live, not draining)."""
        return [i for i in self.router.live_replicas
                if i not in self.router._draining]

    def demand(self) -> int:
        """Work in flight or waiting across the fleet: busy slots, every
        scheduler queue and the router's hold queue."""
        n = 0
        for i in self.router.live_replicas:
            e = self.router.engines[i]
            n += (e.num_active + e.queue_depth + e.num_pending
                  + getattr(e, "num_preempted", 0))
        return n + self.router.pending_held

    def utilization(self) -> float:
        """Demand per serving slot (> 1: more work than the serving
        replicas can hold resident)."""
        serving = self._serving()
        slots = sum(self.router.engines[i].num_slots for i in serving)
        return self.demand() / slots if slots else float("inf")

    # -- the decision loop ---------------------------------------------------

    def observe(self) -> Optional[str]:
        """One hysteresis tick; returns the action taken (``"add"``,
        ``"undrain"``, ``"drain"``, ``"retire"``) or None.  Retiring an
        empty draining replica completes an earlier decision and skips the
        cooldown."""
        self._tick += 1
        self._since_action += 1
        for i in sorted(self.router._draining):
            if (self.router.replica_empty(i)
                    and len(self.router.live_replicas) > max(
                        1, self.min_replicas)):
                self.router.retire_replica(i)
                return self._record("retire", i)
        util = self.utilization()
        pressure = self.router.pending_held > 0 or util > self.high
        slack = (self.router.pending_held == 0 and util < self.low)
        self._pressure_ticks = self._pressure_ticks + 1 if pressure else 0
        self._slack_ticks = self._slack_ticks + 1 if slack else 0
        min_ticks = int(_flags.flag("serving_autoscale_min_ticks"))
        cooldown = int(_flags.flag("serving_autoscale_cooldown"))
        if self._since_action < cooldown:
            return None
        if self._pressure_ticks >= min_ticks:
            return self._scale_up()
        if self._slack_ticks >= min_ticks:
            return self._scale_down()
        return None

    def _scale_up(self) -> Optional[str]:
        if self.router._draining:
            i = min(self.router._draining)
            self.router.undrain_replica(i)
            return self._record("undrain", i)
        if (self.max_replicas is not None
                and len(self.router.live_replicas) >= self.max_replicas):
            return None
        engine = self._factory() if self._factory is not None else None
        try:
            i = self.router.add_replica(engine)
        except ValueError:
            # pre-built engines and no factory: the fleet cannot grow
            return None
        return self._record("add", i)

    def _scale_down(self) -> Optional[str]:
        serving = self._serving()
        if len(serving) <= self.min_replicas:
            return None
        # drain the least-loaded serving replica: the shortest tail
        i = min(serving,
                key=lambda j: (self.router._load(self.router.engines[j]),
                               j))
        self.router.drain_replica(i)
        return self._record("drain", i)

    def _record(self, kind: str, replica: int) -> str:
        self._since_action = 0
        self._pressure_ticks = 0
        self._slack_ticks = 0
        self._actions.append({"tick": self._tick, "action": kind,
                              "replica": int(replica)})
        self._f_actions.labels(action=kind).inc()
        return kind

    # -- telemetry -----------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        return {
            "tick": self._tick,
            "live_replicas": len(self.router.live_replicas),
            "serving_replicas": len(self._serving()),
            "draining": sorted(self.router._draining),
            "utilization": round(self.utilization(), 4),
            "held_requests": self.router.pending_held,
            "actions": list(self._actions),
        }
