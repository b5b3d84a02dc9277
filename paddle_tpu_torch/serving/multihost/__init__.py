"""The multihost serving plane (mirrors ``paddle_tpu/serving/multihost``):
a process-separated router, engine workers behind an RPC surface, KV
migration by value and a streaming HTTP front end.

Layering::

    frontend.ServingFrontend        streaming /v1/generate, driver thread
        plane.MultiHostRouter       placement / failover / disagg policy
            transport.Transport     Loopback (in-process) or Socket (TCP)
                worker.EngineWorker RPC verbs over ONE ServingEngine

The same protocol runs in one process over :class:`LoopbackTransport`
(the tests, the load harness's smoke, the card's phase) and over sockets
between processes (``python -m paddle_tpu_torch.serving.multihost
--worker`` / ``--selfcheck``).
"""

from .transport import (IDEMPOTENT_METHODS, LoopbackTransport, RpcError,
                        RpcServer, SocketTransport, StoreClient,
                        StoreServer, Transport, TransportError,
                        decode_message, encode_message, rendezvous)
from .worker import EngineWorker
from .plane import MultiHostRouter
from .frontend import ServingFrontend

__all__ = [
    "IDEMPOTENT_METHODS", "LoopbackTransport", "RpcError", "RpcServer",
    "SocketTransport", "StoreClient", "StoreServer", "Transport",
    "TransportError", "decode_message", "encode_message", "rendezvous",
    "EngineWorker", "MultiHostRouter", "ServingFrontend",
]
