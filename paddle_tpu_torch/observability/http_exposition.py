"""A small stdlib HTTP exposition server (mirrors
``paddle_tpu/observability/http_exposition.py``).

Serves the observability layer to a scraping or poking operator with
nothing beyond ``http.server``:

  * ``/metrics``: the registry's Prometheus text exposition; when an
    attached engine is a multihost plane, its federated per-worker
    series ride along under the ``paddle_tpu_fleet_`` prefix;
  * ``/fleet``: the attached plane's live fleet health (each worker's
    heartbeat age in ticks, slots in flight, utilization, last tick's
    cost-model ratio, transport errors; 404 when no attached engine
    has ``fleet_report()``);
  * ``/healthz``: JSON liveness: the attached engines' step builds,
    drift findings and the registry's perf anomaly total (a load
    balancer's readiness answer in one GET);
  * ``/requests``: the request log's most recent timelines as JSON
    (``?n=`` / ``?limit=`` caps the tail, default 32, at most 1024;
    ``?uid=`` returns ONE request's whole timeline, across routers and
    failovers, since its uid is minted once);
  * ``POST /v1/generate``: present when the server was built with a
    ``generator`` (the multihost front end).  It streams JSON lines over
    a chunked response: tokens go on the wire the tick they surface, not
    at retirement.

Off by default: ``FLAGS_metrics_port`` 0 disables it, a positive port
binds it and ``-1`` binds an ephemeral port (tests read ``server.port``).
The server binds the loopback address unless told otherwise.  Its
lifetime is a context manager: the daemon thread serving requests ends
with the ``with`` block.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from .. import flags as _flags
from . import metrics as _metrics
from .request_log import get_request_log

__all__ = ["ExpositionServer", "maybe_serve"]


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle_tpu_obs/1"

    def log_message(self, fmt: str, *args: Any) -> None:
        pass                                    # no stderr chatter

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:                   # noqa: N802 (stdlib API)
        owner: "ExpositionServer" = self.server.owner  # type: ignore
        url = urlparse(self.path)
        if url.path == "/metrics":
            text = owner.metrics_text()
            self._send(200, text.encode(), "text/plain; version=0.0.4")
        elif url.path == "/fleet":
            payload = owner.fleet()
            if payload is None:
                self._send(404, b'{"error": "no fleet source"}\n',
                           "application/json")
                return
            body = json.dumps(payload, sort_keys=True, default=str)
            self._send(200, body.encode(), "application/json")
        elif url.path == "/healthz":
            body = json.dumps(owner.healthz(), sort_keys=True)
            self._send(200, body.encode(), "application/json")
        elif url.path == "/requests":
            q = parse_qs(url.query)
            if "uid" in q:
                payload = owner.request_timeline(int(q["uid"][0]))
                code = 200 if payload["found"] else 404
                body = json.dumps(payload, sort_keys=True, default=str)
                self._send(code, body.encode(), "application/json")
                return
            n = int(q.get("limit", q.get("n", ["32"]))[0])
            body = json.dumps(owner.request_tail(n), sort_keys=True,
                              default=str)
            self._send(200, body.encode(), "application/json")
        else:
            self._send(404, b'{"error": "not found"}\n',
                       "application/json")

    def do_POST(self) -> None:                  # noqa: N802 (stdlib API)
        owner: "ExpositionServer" = self.server.owner  # type: ignore
        url = urlparse(self.path)
        if url.path != "/v1/generate" or owner.generator is None:
            self._send(404, b'{"error": "not found"}\n',
                       "application/json")
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._send(400, b'{"error": "bad json"}\n',
                       "application/json")
            return
        # chunked transfer: one JSON line a flush, flushed a tick
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for chunk in owner.generator.stream(payload):
                data = (json.dumps(chunk, sort_keys=True) + "\n").encode()
                self.wfile.write(b"%x\r\n" % len(data))
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            return                              # the client went away
        self.wfile.write(b"0\r\n\r\n")


class ExpositionServer:
    """Threaded HTTP exposition over the default (or given) registry.

    ``engines``: live ServingEngines (or anything with their
    ``perf_report()`` / ``step_traces``) whose liveness ``/healthz`` folds
    in; the server only reads them.  ``generator``: anything with
    ``stream(payload) -> Iterator[dict]`` (the multihost front end)
    enables ``POST /v1/generate``."""

    def __init__(self, port: Optional[int] = None,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 engines: Optional[List[Any]] = None,
                 host: str = "127.0.0.1",
                 generator: Optional[Any] = None) -> None:
        if port is None:
            port = int(_flags.flag("metrics_port"))
        self._requested_port = int(port)
        self.registry = registry or _metrics.default_registry()
        self.engines = list(engines or [])
        self.host = host
        self.generator = generator
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self._requested_port != 0

    @property
    def port(self) -> int:
        """The bound port (an ephemeral one resolved after start())."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return max(0, self._requested_port)

    # -- payloads --------------------------------------------------------------

    def metrics_text(self) -> str:
        """The ``/metrics`` page: the registry's exposition and, for each
        attached engine that is a fleet plane (it has
        ``federated_metrics_text``), the federated worker series under
        the ``paddle_tpu_fleet_`` prefix."""
        text = self.registry.prometheus_text()
        for e in self.engines:
            fed = getattr(e, "federated_metrics_text", None)
            if callable(fed):
                try:
                    text += fed()
                except Exception:
                    pass            # a half-lost fleet still scrapes
        return text

    def fleet(self) -> Optional[Dict[str, Any]]:
        """The ``/fleet`` payload of the first attached engine with
        ``fleet_report()`` (the multihost plane); None gives a 404."""
        for e in self.engines:
            fr = getattr(e, "fleet_report", None)
            if callable(fr):
                return fr()
        return None

    def healthz(self) -> Dict[str, Any]:
        """The ``/healthz`` payload: ok unless an engine carries a drift
        finding or built its step more than once, or the registry counted
        a perf anomaly."""
        anomalies = 0.0
        fam = self.registry.get("serving.perf_anomalies")
        if fam is not None:
            anomalies = sum(c.value() for c in fam.children())
        engines = []
        ok = True
        for e in self.engines:
            drift = 0
            try:
                drift = len(e.perf_report().get("drift", []))
            except Exception:
                pass
            traces = getattr(e, "step_traces", None)
            info = {"engine": getattr(e, "_eid", "?"),
                    "num_slots": getattr(e, "num_slots", None),
                    "step_traces": traces,
                    "drift_findings": drift}
            engines.append(info)
            # the built-once contract: a second step build fails liveness
            ok = ok and drift == 0 and (traces is None or traces <= 1)
        return {"ok": bool(ok and anomalies == 0),
                "perf_anomalies": anomalies,
                "engines": engines}

    def request_tail(self, n: int = 32) -> Dict[str, Any]:
        n = min(max(0, int(n)), 1024)           # bounded: never a full dump
        recs = get_request_log().records()
        uids = sorted(recs)[-n:] if n else []
        return {"requests": {str(u): recs[u] for u in uids},
                "total": len(recs), "limit": n}

    def request_timeline(self, uid: int) -> Dict[str, Any]:
        """ONE request's lifecycle (the ``?uid=`` lookup)."""
        tl = get_request_log().timeline(int(uid))
        return {"uid": int(uid), "found": bool(tl), "events": tl}

    # -- lifetime --------------------------------------------------------------

    def start(self) -> "ExpositionServer":
        if not self.enabled or self._httpd is not None:
            return self
        port = self._requested_port if self._requested_port > 0 else 0
        self._httpd = ThreadingHTTPServer((self.host, port), _Handler)
        self._httpd.owner = self                # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        # a 50 ms poll: stop() returns within it (the stdlib's 0.5 s
        # default made every server's teardown cost half a second)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, args=(0.05,),
            name="obs-exposition", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "ExpositionServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def maybe_serve(engines: Optional[List[Any]] = None
                ) -> Optional[ExpositionServer]:
    """Start a server iff ``FLAGS_metrics_port`` is not 0; returns the
    started server or None (the default 0 keeps every run socket-free
    unless asked)."""
    srv = ExpositionServer(engines=engines)
    if not srv.enabled:
        return None
    return srv.start()
