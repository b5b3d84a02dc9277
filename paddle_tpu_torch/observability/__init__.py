"""Observability of the port (mirrors ``paddle_tpu/observability``).  This
slice holds the build watchdog (``watchdog.py``); the metrics registry,
tracing and the request log are ROADMAP A5b."""

from .watchdog import (RetraceError, RetraceWarning, TrackedFunction,
                       track_retraces)

__all__ = ["RetraceError", "RetraceWarning", "TrackedFunction",
           "track_retraces"]
