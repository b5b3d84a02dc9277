"""Wire layer of the multihost serving plane (mirrors
``paddle_tpu/serving/multihost/transport.py``).

One protocol, two carriers:

  * :class:`SocketTransport` / :class:`RpcServer`: length-prefixed JSON
    frames over TCP (a 4-byte big-endian length, then a UTF-8 JSON body;
    arrays and raw bytes ride inline as tagged base64 objects, so paged
    KV blocks cross the wire with the standard library alone).  Calls
    carry a timeout each; a failed connect retries with deterministic
    exponential backoff, and IDEMPOTENT methods (``ping``, ``status``,
    ``result``, ...) also retry a broken call once the connection is up
    again.

  * :class:`LoopbackTransport`: the same interface in one process.  Every
    call still goes through ``encode_message`` / ``decode_message`` both
    ways, so the tests, the load harness's smoke and the card's phase
    exercise the whole serialisation without sockets or processes, and
    deterministically.  ``kill()`` simulates the loss of a worker: later
    calls raise :class:`TransportError`, as a dead TCP peer's do.

The codec keeps the reference's frames: a numpy array, or a torch tensor
of a dtype numpy holds, is an ``__nd__`` object (dtype name, shape,
base64 of its bytes) and decodes to a numpy array, so a frame that
carries no bfloat16 is byte-equal to the reference's.  numpy has no
bfloat16, so a tensor of a dtype numpy lacks is a ``__tensor__`` object
(the torch dtype's name, shape, base64 of its raw bytes) and decodes to a
CPU tensor through ``torch.frombuffer(...).view(dtype)``, bit for bit.
That is how an engine's bf16 KV blocks migrate.

Worker rendezvous is TCP-store style: :class:`StoreServer` is a small
key / value service (set / get / wait) behind the same RPC framing;
workers publish ``worker/<name> -> host:port`` and the plane's
:func:`rendezvous` blocks until every expected worker has registered.

Telemetry: every call counts into ``rpc.calls`` / ``rpc.errors`` /
``rpc.retries`` and the byte counters and opens an ``rpc.call`` span;
the labels are the transport's name, never the method.

Clock stitching: every frame carries timestamps from both sides.  The
client stamps ``t0`` / ``t3`` (send / receive) on its own clock, the
server answers with ``t1`` / ``t2`` (receive / respond) on the worker's,
and each transport feeds the four into a
:class:`~paddle_tpu_torch.observability.federation.TransportStitch`
(``transport.stitch``), whose least-RTT NTP-style estimator recovers the
worker clock's offset from the plane's.  Clocks are pluggable (``clock=``
returns milliseconds; the default is the request log's relative clock),
so loopback planes stitch deterministically.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import flags as _flags
from ... import observability as _obs
from ...observability.federation import TransportStitch

__all__ = [
    "encode_message", "decode_message", "RpcError", "TransportError",
    "Transport", "LoopbackTransport", "SocketTransport", "RpcServer",
    "StoreServer", "StoreClient", "rendezvous",
]

# calls safe to replay blind after a reconnect (read-only or naturally
# idempotent); everything else fails fast to the caller's failover path
IDEMPOTENT_METHODS = frozenset({
    "ping", "status", "result", "request_uid", "metrics",
    "metrics_snapshot", "prefix_probe", "lint",
    "store.get", "store.set", "store.wait"})

_HDR = struct.Struct(">I")
_MAX_FRAME = 1 << 30


# -- message codec -----------------------------------------------------------

# torch dtypes numpy holds: such a tensor travels as the reference's
# ``__nd__`` array; any other (bfloat16) as a ``__tensor__`` of raw bytes
_NUMPY_HOLDS = frozenset({
    torch.float64, torch.float32, torch.float16, torch.int64, torch.int32,
    torch.int16, torch.int8, torch.uint8, torch.bool})


def _enc_tensor(t: "torch.Tensor") -> Any:
    t = t.detach().to("cpu").contiguous()
    if t.dtype in _NUMPY_HOLDS:
        return _enc(t.numpy())
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return {"__tensor__": {"dtype": str(t.dtype).split(".")[-1],
                           "shape": list(t.shape),
                           "data": base64.b64encode(raw).decode("ascii")}}


def _dec_tensor(tt: Dict[str, Any]) -> "torch.Tensor":
    dtype = getattr(torch, str(tt["dtype"]), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"frame names no torch dtype: {tt['dtype']!r}")
    raw = base64.b64decode(tt["data"])
    if not raw:
        return torch.empty(tt["shape"], dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(
        dtype).reshape(tt["shape"])


def _enc(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return _enc_tensor(obj)
    if isinstance(obj, np.ndarray):
        return {"__nd__": {"dtype": obj.dtype.name,
                           "shape": list(obj.shape),
                           "data": base64.b64encode(
                               np.ascontiguousarray(obj).tobytes()
                           ).decode("ascii")}}
    if isinstance(obj, (bytes, bytearray)):
        return {"__bytes__": base64.b64encode(bytes(obj)).decode("ascii")}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): _enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    return obj


def _dec(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__nd__" in obj and len(obj) == 1:
            nd = obj["__nd__"]
            raw = base64.b64decode(nd["data"])
            return np.frombuffer(raw, dtype=np.dtype(nd["dtype"])).reshape(
                nd["shape"]).copy()
        if "__tensor__" in obj and len(obj) == 1:
            return _dec_tensor(obj["__tensor__"])
        if "__bytes__" in obj and len(obj) == 1:
            return base64.b64decode(obj["__bytes__"])
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


def encode_message(obj: Any) -> bytes:
    """Serialize a payload tree (JSON scalars, lists, str-keyed dicts,
    numpy arrays, torch tensors, bytes) into one wire frame body.  Dict keys are
    coerced to ``str`` — the protocol convention is string keys
    everywhere (worker responses key deltas by ``str(rid)``)."""
    return json.dumps(_enc(obj), separators=(",", ":"),
                      allow_nan=False).encode("utf-8")


def decode_message(body: bytes) -> Any:
    return _dec(json.loads(body.decode("utf-8")))


def write_frame(sock: socket.socket, body: bytes) -> None:
    sock.sendall(_HDR.pack(len(body)) + body)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return buf


def read_frame(sock: socket.socket) -> bytes:
    (n,) = _HDR.unpack(_read_exact(sock, _HDR.size))
    if n > _MAX_FRAME:
        raise ConnectionError(f"frame length {n} exceeds cap {_MAX_FRAME}")
    return _read_exact(sock, n)


# -- errors ------------------------------------------------------------------

class RpcError(Exception):
    """The remote handler raised: the call REACHED the worker and failed
    there (``kind`` is the remote exception type — the plane's admission
    failover keys on ``kind == 'ValueError'``, the engine's rejection
    contract).  The worker itself is alive."""

    def __init__(self, kind: str, message: str):
        super().__init__(f"{kind}: {message}")
        self.kind = kind
        self.message = message


class TransportError(Exception):
    """The call did NOT complete: connection refused/reset, timeout, or
    a killed loopback peer.  The caller must treat the worker as lost
    (heartbeat/failover territory) — whether the side effect happened is
    unknowable from here."""


# -- metrics -----------------------------------------------------------------

class _RpcMetrics:
    def __init__(self, name: str):
        reg = _obs.default_registry()
        lbl = {"transport": name}
        self.calls = reg.counter(
            "rpc.calls", "RPC calls issued").labels(**lbl)
        self.errors = reg.counter(
            "rpc.errors",
            "RPC calls that failed (remote fault or transport "
            "loss)").labels(**lbl)
        self.retries = reg.counter(
            "rpc.retries",
            "reconnect/backoff retries across all calls").labels(**lbl)
        self.bytes_sent = reg.counter(
            "rpc.bytes_sent", "request frame bytes").labels(**lbl)
        self.bytes_recv = reg.counter(
            "rpc.bytes_recv", "response frame bytes").labels(**lbl)
        self.call_ms = reg.histogram(
            "rpc.call_ms", "round-trip wall time per call").labels(**lbl)


# -- transports --------------------------------------------------------------

class Transport:
    """The one client surface both carriers implement."""

    name = "?"
    # True when client and worker share one process (and therefore one
    # RequestLog): the plane skips merging shipped worker events then,
    # since the worker already wrote them into the shared log
    shares_process = False
    # clock-stitching state; concrete carriers replace it per instance
    stitch: Optional[TransportStitch] = None

    def call(self, method: str, payload: Optional[Dict[str, Any]] = None,
             timeout: Optional[float] = None) -> Any:
        raise NotImplementedError

    def close(self) -> None:
        pass

    @property
    def alive(self) -> bool:
        return True

    @property
    def errors(self) -> int:
        """Failed calls so far (transport loss + remote faults) — the
        /fleet per-worker transport error count."""
        m = getattr(self, "_m", None)
        return int(m.errors.value()) if m is not None else 0


def _default_clock_ms() -> float:
    """The plane/worker default timestamp source for RPC stitching: the
    process request log's relative clock, so RPC timestamps, request
    events, and merged timelines share one base per process (and one
    seam — swapping ``RequestLog._clock`` re-clocks all three)."""
    return _obs.get_request_log().now_ms()


class LoopbackTransport(Transport):
    """In-process carrier: ``handler(method, payload) -> result`` with
    the full encode/decode round trip on BOTH legs, so whatever the
    socket path would serialize, this path serializes too.  Worker loss
    is scripted — ``kill()`` makes every later call raise
    :class:`TransportError`, which is exactly what a dead TCP peer looks
    like to the plane."""

    shares_process = True

    def __init__(self, handler: Callable[[str, Dict[str, Any]], Any],
                 name: str = "loopback",
                 clock: Optional[Callable[[], float]] = None,
                 server_clock: Optional[Callable[[], float]] = None):
        self._handler = handler
        self.name = name
        self._dead = False
        self._m = _RpcMetrics(name)
        self._tracer = _obs.get_tracer()
        # ``clock``/``server_clock`` return ms on the caller's / the
        # worker's clock; both default to the shared request-log clock
        # (one process, one clock -> offset ~ 0 by construction)
        self._clock = clock or _default_clock_ms
        self._server_clock = server_clock or self._clock
        self.stitch = TransportStitch(name)

    def kill(self) -> None:
        """Simulate worker loss from now on (deterministic)."""
        self._dead = True

    @property
    def alive(self) -> bool:
        return not self._dead

    def call(self, method: str, payload: Optional[Dict[str, Any]] = None,
             timeout: Optional[float] = None) -> Any:
        self._m.calls.inc()
        t_wall = time.perf_counter()
        with self._tracer.span("rpc.call", transport=self.name,
                               method=method):
            if self._dead:
                self._m.errors.inc()
                raise TransportError(f"{self.name}: worker is gone")
            t0 = float(self._clock())
            req = encode_message({"method": method,
                                  "payload": payload or {},
                                  "ts": {"t0": t0}})
            self._m.bytes_sent.inc(len(req))
            frame = decode_message(req)
            t1 = float(self._server_clock())
            try:
                result = self._handler(frame["method"], frame["payload"])
                t2 = float(self._server_clock())
                resp = encode_message({"ok": True, "result": result,
                                       "ts": {"t1": t1, "t2": t2}})
            except Exception as e:                      # noqa: BLE001
                t2 = float(self._server_clock())
                resp = encode_message({"ok": False,
                                       "error": {"kind": type(e).__name__,
                                                 "msg": str(e)},
                                       "ts": {"t1": t1, "t2": t2}})
            self._m.bytes_recv.inc(len(resp))
            out = decode_message(resp)
            t3 = float(self._clock())
            self.stitch.record(method, t0, t1, t2, t3)
        self._m.call_ms.observe((time.perf_counter() - t_wall) * 1e3)
        if not out["ok"]:
            self._m.errors.inc()
            raise RpcError(out["error"]["kind"], out["error"]["msg"])
        return out["result"]


class SocketTransport(Transport):
    """TCP carrier with per-call timeouts, deterministic exponential
    backoff on (re)connect, and blind retry only for IDEMPOTENT
    methods.  One in-flight call at a time per transport (the plane is
    a single-threaded scheduler; the frontend talks to the plane, not
    to workers)."""

    def __init__(self, host: str, port: int, name: Optional[str] = None,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.host = host
        self.port = int(port)
        self.name = name or f"{host}:{port}"
        self._clock = clock or _default_clock_ms
        self.stitch = TransportStitch(self.name)
        self._timeout = float(timeout if timeout is not None
                              else _flags.flag("multihost_call_timeout_s"))
        self._retries = int(retries if retries is not None
                            else _flags.flag("multihost_call_retries"))
        self._backoff = float(backoff if backoff is not None
                              else _flags.flag("multihost_retry_backoff_s"))
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._dead = False
        self._m = _RpcMetrics(self.name)
        self._tracer = _obs.get_tracer()

    @property
    def alive(self) -> bool:
        return not self._dead

    def _connect(self, timeout: float) -> socket.socket:
        last: Optional[Exception] = None
        for attempt in range(self._retries + 1):
            if attempt:
                self._m.retries.inc()
                time.sleep(self._backoff * (2 ** (attempt - 1)))
            try:
                s = socket.create_connection((self.host, self.port),
                                             timeout=timeout)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return s
            except OSError as e:
                last = e
        raise TransportError(
            f"{self.name}: connect failed after "
            f"{self._retries + 1} attempts: {last}")

    def _roundtrip(self, req: bytes, timeout: float) -> bytes:
        if self._sock is None:
            self._sock = self._connect(timeout)
        self._sock.settimeout(timeout)
        write_frame(self._sock, req)
        return read_frame(self._sock)

    def call(self, method: str, payload: Optional[Dict[str, Any]] = None,
             timeout: Optional[float] = None) -> Any:
        if self._dead:
            self._m.errors.inc()
            raise TransportError(f"{self.name}: transport closed")
        tmo = float(timeout if timeout is not None else self._timeout)
        self._m.calls.inc()
        t_wall = time.perf_counter()
        with self._lock, self._tracer.span(
                "rpc.call", transport=self.name, method=method):
            attempts = (self._retries + 1
                        if method in IDEMPOTENT_METHODS else 1)
            last: Optional[Exception] = None
            resp = None
            t0 = t3 = 0.0
            for attempt in range(attempts):
                if attempt:
                    self._m.retries.inc()
                    time.sleep(self._backoff * (2 ** (attempt - 1)))
                try:
                    # t0 per attempt: the stitch sample must bracket the
                    # round trip that actually completed
                    t0 = float(self._clock())
                    req = encode_message({"method": method,
                                          "payload": payload or {},
                                          "ts": {"t0": t0}})
                    self._m.bytes_sent.inc(len(req))
                    resp = self._roundtrip(req, tmo)
                    t3 = float(self._clock())
                    break
                except (OSError, ConnectionError) as e:
                    last = e
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
            if resp is None:
                self._m.errors.inc()
                raise TransportError(f"{self.name}: {method} failed: {last}")
        self._m.bytes_recv.inc(len(resp))
        self._m.call_ms.observe((time.perf_counter() - t_wall) * 1e3)
        out = decode_message(resp)
        ts = out.get("ts") or {}
        if "t1" in ts and "t2" in ts:
            self.stitch.record(method, t0, float(ts["t1"]),
                               float(ts["t2"]), t3)
        if not out["ok"]:
            self._m.errors.inc()
            raise RpcError(out["error"]["kind"], out["error"]["msg"])
        return out["result"]

    def close(self) -> None:
        self._dead = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


# -- server ------------------------------------------------------------------

class RpcServer:
    """Threaded frame server: one accept loop, one thread per
    connection, ``handler(method, payload) -> result`` dispatched per
    frame.  Handler exceptions become structured error responses (the
    connection survives); transport-level breakage just drops that
    connection."""

    def __init__(self, handler: Callable[[str, Dict[str, Any]], Any],
                 host: str = "127.0.0.1", port: int = 0,
                 clock: Optional[Callable[[], float]] = None):
        self._handler = handler
        # server-side stitch clock (ms); workers pass their own clock so
        # t1/t2 share a base with the request-log events they ship
        self._clock = clock or _default_clock_ms
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, int(port)))
        self._lsock.listen(16)
        self.host, self.port = self._lsock.getsockname()[:2]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._accept = threading.Thread(target=self._accept_loop,
                                        name=f"rpc-accept:{self.port}",
                                        daemon=True)
        self._accept.start()

    def _accept_loop(self) -> None:
        self._lsock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    frame = decode_message(read_frame(conn))
                except (ConnectionError, OSError, ValueError):
                    return
                t1 = float(self._clock())
                try:
                    result = self._handler(frame["method"],
                                           frame.get("payload") or {})
                    resp = {"ok": True, "result": result}
                except Exception as e:                  # noqa: BLE001
                    resp = {"ok": False,
                            "error": {"kind": type(e).__name__,
                                      "msg": str(e)}}
                resp["ts"] = {"t1": t1, "t2": float(self._clock())}
                try:
                    write_frame(conn, encode_message(resp))
                except (ConnectionError, OSError):
                    return

    def stop(self) -> None:
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass

    def __enter__(self) -> "RpcServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


# -- TCP-store rendezvous ----------------------------------------------------

class StoreServer:
    """TCP-store-style rendezvous: a key/value dict behind the RPC
    framing with a blocking ``wait`` — workers ``set`` their address
    under ``worker/<name>``, the plane ``wait``s for the full roster."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._kv: Dict[str, Any] = {}
        self._cond = threading.Condition()
        self._rpc = RpcServer(self._handle, host=host, port=port)
        self.host, self.port = self._rpc.host, self._rpc.port

    def _handle(self, method: str, payload: Dict[str, Any]) -> Any:
        if method == "store.set":
            with self._cond:
                self._kv[str(payload["key"])] = payload["value"]
                self._cond.notify_all()
            return {"ok": 1}
        if method == "store.get":
            with self._cond:
                return {"value": self._kv.get(str(payload["key"]))}
        if method == "store.wait":
            keys = [str(k) for k in payload["keys"]]
            deadline = time.monotonic() + float(payload.get("timeout", 30.0))
            with self._cond:
                while not all(k in self._kv for k in keys):
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._cond.wait(timeout=left):
                        missing = [k for k in keys if k not in self._kv]
                        raise TimeoutError(
                            f"rendezvous timed out waiting for {missing}")
                return {"values": {k: self._kv[k] for k in keys}}
        raise ValueError(f"unknown store method {method!r}")

    def stop(self) -> None:
        self._rpc.stop()

    def __enter__(self) -> "StoreServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


class StoreClient:
    """Client half of the rendezvous store (workers + plane)."""

    def __init__(self, host: str, port: int,
                 timeout: Optional[float] = None):
        self._t = SocketTransport(host, port, name=f"store:{host}:{port}",
                                  timeout=timeout)

    def set(self, key: str, value: Any) -> None:
        self._t.call("store.set", {"key": key, "value": value})

    def get(self, key: str) -> Any:
        return self._t.call("store.get", {"key": key})["value"]

    def wait(self, keys: List[str], timeout: float = 30.0) -> Dict[str, Any]:
        return self._t.call("store.wait",
                            {"keys": list(keys), "timeout": timeout},
                            timeout=timeout + 5.0)["values"]

    def close(self) -> None:
        self._t.close()


def rendezvous(store: StoreClient, names: List[str],
               timeout: float = 30.0) -> Dict[str, Tuple[str, int]]:
    """Block until every worker in ``names`` has published its RPC
    address under ``worker/<name>``; returns name -> (host, port)."""
    vals = store.wait([f"worker/{n}" for n in names], timeout=timeout)
    return {n: (vals[f"worker/{n}"]["host"],
                int(vals[f"worker/{n}"]["port"])) for n in names}
