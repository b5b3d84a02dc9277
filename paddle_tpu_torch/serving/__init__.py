"""Serving of the port (mirrors ``paddle_tpu/serving``).  The observability
modules (metrics registry, tracing, request log, watchdog) wait for a later
slice (ROADMAP A5b)."""

from .engine import Request, SamplingParams, ServingEngine

__all__ = ["Request", "SamplingParams", "ServingEngine"]
