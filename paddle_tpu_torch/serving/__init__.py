"""Serving of the port (mirrors ``paddle_tpu/serving``).  The engine's
decode step is built once (``step_graph.py``: one CUDA graph per engine on
the card; ``disable_graphs()`` is the port's ``jax.disable_jit()``).  The
engine and the block manager report into ``paddle_tpu_torch.observability``
(the metrics registry, span tracer, request log, cost model and build
watchdog)."""

from .engine import Request, SamplingParams, ServingEngine
from .step_graph import disable_graphs

__all__ = ["Request", "SamplingParams", "ServingEngine", "disable_graphs"]
