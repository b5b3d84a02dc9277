"""Serving of the port (mirrors ``paddle_tpu/serving``).  The engine's
decode step is built once (``step_graph.py``: one CUDA graph per engine on
the card; ``disable_graphs()`` is the port's ``jax.disable_jit()``).  The
engine and the block manager report into ``paddle_tpu_torch.observability``
(the metrics registry, span tracer, request log, cost model and build
watchdog).  The single-host control plane sits above the engine: the
replica router (``router.py``), the predictive admission primitives
(``admission.py``), the autoscaler (``autoscaler.py``), the seeded load
generator and replay (``loadgen.py``) and the device-free fleet simulator
(``fleet_sim.py``).  The multihost plane (``multihost/``) puts engines
behind RPC workers, in this process or in processes of their own: the
plane places, migrates (disaggregated prefill and decode) and fails
requests over, and a front end streams them over HTTP."""

from .admission import HoldQueue, Verdict, place_verdict
from .autoscaler import ReplicaAutoscaler
from .drafter import Drafter, DraftModelDrafter, NgramDrafter
from .engine import Request, SamplingParams, ServingEngine
from .fleet_sim import FleetSim, SimEngine, SimSpec, run_fleet
from .kv_cache import BlockManager, init_paged_kv_cache
from .loadgen import LoadRequest, LoadSpec, generate_load, replay
from .router import ReplicaRouter
from .step_graph import disable_graphs

__all__ = ["ServingEngine", "SamplingParams", "Request", "BlockManager",
           "init_paged_kv_cache", "Drafter", "DraftModelDrafter",
           "NgramDrafter", "ReplicaRouter",
           "LoadRequest", "LoadSpec", "generate_load", "replay",
           "HoldQueue", "Verdict", "place_verdict", "ReplicaAutoscaler",
           "FleetSim", "SimEngine", "SimSpec", "run_fleet",
           "disable_graphs"]
