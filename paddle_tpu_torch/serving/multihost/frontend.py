"""Streaming HTTP front end of the multihost plane (mirrors
``paddle_tpu/serving/multihost/frontend.py``).

:class:`ServingFrontend` owns a :class:`~.plane.MultiHostRouter`, drives
it from one background thread, and offers the generator
``stream(payload) -> Iterator[dict]`` that
:class:`~paddle_tpu_torch.observability.http_exposition.ExpositionServer`
serves as ``POST /v1/generate``.

Tokens surface per tick, not at retirement: the first line a stream
yields carries the request's lifecycle ``uid``, each later line the
tokens that surfaced in one plane tick, the last ``done`` and the
total.  Under streaming, TTFT is the first chunk on the wire, which is
why the driver thread hands deltas to each request's queue the moment
``plane.step()`` returns.

The plane is single-threaded by design (deterministic ticks): the front
end serialises the HTTP handlers' submits against the driver's steps
with one lock, so concurrency lives at the edges and the tick order,
which the timeline signature hashes, stays deterministic.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

from ... import flags as _flags
from ...observability.http_exposition import ExpositionServer
from ..engine import SamplingParams
from .plane import MultiHostRouter

__all__ = ["ServingFrontend"]


class ServingFrontend:
    """Background-driven plane + the ``stream`` generator surface."""

    def __init__(self, plane: MultiHostRouter,
                 poll_s: Optional[float] = None):
        self.plane = plane
        self._poll_s = float(
            poll_s if poll_s is not None
            else _flags.flag("multihost_stream_poll_s"))
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ServingFrontend":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._drive, name="multihost-frontend-driver",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    def serve(self, port: int = -1) -> ExpositionServer:
        """An ExpositionServer wired to this front end: /metrics (the
        process exposition plus the plane's federated per-worker
        series), /fleet (live per-worker health), /healthz, /requests
        (uid lookup included) and the streaming POST /v1/generate, all
        on one port."""
        self.start()
        return ExpositionServer(port=port, engines=[self.plane],
                                generator=self).start()

    # -- the driver ----------------------------------------------------

    def _drive(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                busy = any(not r.done
                           for r in self.plane._reqs.values())
                if busy:
                    self.plane.step()
            if not busy:
                self._stop.wait(self._poll_s)

    # -- the generator the HTTP layer consumes -------------------------

    def stream(self, payload: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        """Yield JSON-able chunks for one generate call.  Lines:
        ``{"uid", "rid"}`` (accepted), then ``{"tokens": [...]}`` per
        tick that surfaced tokens, then ``{"done": true, "uid",
        "tokens_total"}``.  A rejection yields one ``{"error": ...}``
        line instead (the uid's timeline holds the rejection trail)."""
        prompt = [int(t) for t in payload.get("prompt", [])]
        sp = payload.get("sampling") or {}
        sampling = None
        if sp:
            sampling = SamplingParams(
                temperature=float(sp.get("temperature", 0.0)),
                top_k=int(sp.get("top_k", 0)),
                top_p=float(sp.get("top_p", 1.0)))
        q: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        with self._lock:
            try:
                rid = self.plane.submit(
                    prompt,
                    max_new_tokens=int(payload.get("max_new_tokens", 32)),
                    sampling=sampling,
                    session=payload.get("session"),
                    priority=int(payload.get("priority", 0)),
                    ttft_slo_ms=payload.get("ttft_slo_ms"),
                    tpot_slo_ms=payload.get("tpot_slo_ms"))
            except ValueError as e:
                yield {"error": str(e)}
                return
            uid = self.plane.request_uid(rid)
            self.plane.attach_stream(rid, q.put)
        yield {"uid": int(uid), "rid": int(rid)}
        while True:
            item = q.get()
            if item["tokens"]:
                yield {"tokens": item["tokens"]}
            if item["done"]:
                with self._lock:
                    total = len(self.plane.result(rid))
                yield {"done": True, "uid": int(uid),
                       "tokens_total": int(total)}
                return
