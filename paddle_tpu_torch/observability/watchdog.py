"""Build watchdog: per-site counting of step-program builds with a budget
(mirrors ``paddle_tpu/observability/watchdog.py``).

The reference's serving engine rests on "the step function compiles exactly
once": its ``track_retraces`` counts every jit trace of a wrapped step and,
past a ``budget``, warns or raises (``FLAGS_retrace_watchdog``) at the
moment the offending trace happens.  The port builds its step programs
itself instead of tracing them — a warm-up and one CUDA-graph capture on
the card, the static-buffer step on the CPU — so :func:`track_retraces`
wraps the BUILD: every call of the returned function is one build, counted
under ``(site, labels)``, and a build past the budget consults
``FLAGS_retrace_watchdog``: ``raise`` → :class:`RetraceError` before the
build runs, ``warn`` → :class:`RetraceWarning`, then the build, ``off`` →
count only.  Over one sequence of builds the counts, warnings and errors
are the reference's over the same sequence of traces.

Every build is reported into the metrics registry as the reference's
trace is, ``jit.traces{site=<name>, <labels>}``, and the engine labels its
site with ``engine=<id>`` so engines budget independently.  The budget
itself reads the site's own count, kept beside the registry's: a family
past ``FLAGS_metrics_max_children`` label sets coalesces new children into
``{overflow="true"}``, and a site whose registry child is that shared one
must still be budgeted alone.
"""

from __future__ import annotations

import collections
import functools
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

from .. import flags
from . import metrics as _metrics

__all__ = ["RetraceError", "RetraceWarning", "TrackedFunction",
           "track_retraces"]

# (site, sorted label items) -> builds counted
_counts: Dict[Tuple[str, tuple], int] = collections.Counter()


class RetraceError(RuntimeError):
    """A tracked site built its program more often than its budget
    allows."""


class RetraceWarning(UserWarning):
    pass


def _key(name: str, labels: Optional[Dict[str, Any]]) -> Tuple[str, tuple]:
    return name, tuple(sorted((k, str(v)) for k, v in (labels or {}).items()))


def _describe_args(args, kwargs) -> str:
    def one(a):
        shape = getattr(a, "shape", None)
        if shape is not None:
            return f"{getattr(a, 'dtype', None)}{tuple(shape)}"
        return type(a).__name__
    parts = [one(a) for a in args]
    parts += [f"{k}={one(v)}" for k, v in kwargs.items()]
    return ", ".join(parts)


class TrackedFunction:
    """Callable wrapper returned by :func:`track_retraces`: ``fn(...)`` is
    one counted build; ``.traces`` reads the site's count; ``.counter`` is
    its registry child."""

    def __init__(self, fn: Callable, name: str, key: Tuple[str, tuple],
                 counter=None):
        self._fn = fn
        self.name = name
        self.key = key
        self.counter = counter
        functools.update_wrapper(self, fn, updated=())

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    @property
    def traces(self) -> int:
        return int(_counts[self.key])


def track_retraces(fn: Callable, name: str, budget: Optional[int] = None,
                   labels: Optional[Dict[str, Any]] = None,
                   registry: Optional[_metrics.MetricsRegistry] = None
                   ) -> TrackedFunction:
    """Wrap the build function ``fn`` so every call is counted as one build
    of site ``name`` (and budgeted).

    ``budget``: the most builds allowed (``1`` = "built once, never
    rebuilt").  Exceeding it consults ``FLAGS_retrace_watchdog`` at the
    offending build: ``raise`` → :class:`RetraceError` (the build does not
    run), ``warn`` → :class:`RetraceWarning`, ``off`` → count only.
    ``labels`` extend the counter's key (``engine=<id>``); ``registry``
    (default: the process-wide one) receives ``jit.traces``."""
    key = _key(name, labels)
    reg = registry if registry is not None else _metrics.default_registry()
    counter = reg.counter(
        "jit.traces",
        "jit compilations per tracked call-site (trace-time side effect; "
        "value N means N compiled programs, not N calls)",
    ).labels(site=name, **(labels or {}))

    @functools.wraps(fn)
    def counted(*args, **kwargs):
        _counts[key] += 1
        counter.inc()
        n = _counts[key]
        if budget is not None and n > budget:
            action = str(flags.flag("retrace_watchdog"))
            if action != "off":
                msg = (f"{name}: trace #{n} exceeds the retrace budget of "
                       f"{budget} — the call signature that retraced: "
                       f"({_describe_args(args, kwargs)}).  A step program "
                       f"was built again at a site meant to build "
                       f"{budget} time(s).")
                if action == "raise":
                    raise RetraceError(msg)
                warnings.warn(msg, RetraceWarning, stacklevel=2)
        return fn(*args, **kwargs)

    return TrackedFunction(counted, name, key, counter)
