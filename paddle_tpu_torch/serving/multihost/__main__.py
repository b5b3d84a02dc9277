"""Command line of the multihost serving plane (mirrors
``paddle_tpu/serving/multihost/__main__.py``).

Two modes, each on the card unless the caller passes ``--device cpu``:

``--worker --name w0 --store-host H --store-port P [--device D]``
    Run one engine worker in this process: build the seeded tiny model
    (the same seed gives the same weights in every process), serve the
    EngineWorker's RPC verbs on an ephemeral localhost port, publish the
    address under ``worker/<name>`` in the rendezvous store, and wait
    until the plane sends ``shutdown``.

``--selfcheck [--device D]``
    Spawn two worker processes on localhost (on the same device), meet
    them through a TCP store, run a short seeded trace through the socket
    plane, killing one worker process mid-trace, and check that (a) every
    request finishes, (b) the outputs equal a single in-process engine's
    token for token (float32), (c) every request has one lifecycle
    timeline (one ``submitted``, a ``retired``, and ``worker_lost ->
    failover -> placed`` in order on the victims) and (d) the merged fleet
    Perfetto timeline holds both workers' process tracks and at least one
    stitched cross-process request track.  Exits non-zero on any of them.

Without a card and without ``--device cpu`` both modes raise; they never
carry on on the CPU.  A worker process loads the kernels the parent (or
an earlier process) built: a library is written under a temporary name
and renamed into place, so its content-hashed path exists only once it
is whole, and a process that finds it loads it without building.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import OrderedDict
from typing import List

_TRACE_SEED = 11
_MODEL_SEED = 7
_ENGINE_KW = dict(num_slots=4, max_length=128, prefill_batch=2,
                  paged=True, block_len=8)


def _device(name):
    """The device a mode runs on (``paddle_tpu_torch.default_device``:
    the card unless ``cpu`` is asked for).  On the CPU a process takes one
    intra-op thread: the tiny model needs no more, and the selfcheck runs
    three processes side by side."""
    import torch
    from paddle_tpu_torch import default_device
    dev = default_device(name)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    return dev


def _build_engine(device):
    from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
    from paddle_tpu_torch.serving.engine import ServingEngine
    model = LlamaForCausalLM(tiny_llama_config(), device=device,
                             seed=_MODEL_SEED)
    model.eval()
    return ServingEngine(model, device=device, **_ENGINE_KW)


def _trace(n: int = 4):
    import numpy as np
    rng = np.random.default_rng(_TRACE_SEED)
    return [rng.integers(3, 90, size=int(ln)).tolist()
            for ln in rng.integers(5, 17, size=n)]


def _run_worker(args: argparse.Namespace) -> int:
    from .transport import RpcServer, StoreClient
    from .worker import EngineWorker
    worker = EngineWorker(_build_engine(_device(args.device)),
                          name=args.name)
    # the RPC server stamps t1/t2 with the worker's request-log clock,
    # so the plane's offset estimate maps shipped events and handler
    # slices onto the plane clock in one go
    rpc = RpcServer(worker.handle, host="127.0.0.1", port=0,
                    clock=worker.clock_ms)
    store = StoreClient(args.store_host, args.store_port)
    store.set(f"worker/{args.name}",
              {"host": rpc.host, "port": rpc.port})
    print(f"[worker {args.name}] serving on {rpc.host}:{rpc.port}",
          flush=True)
    try:
        while not worker.stop_requested:
            time.sleep(0.05)
    finally:
        rpc.stop()
        store.close()
    return 0


def _spawn_worker(name: str, store_host: str, store_port: int,
                  device: str) -> "subprocess.Popen[bytes]":
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.multihost",
         "--worker", "--name", name, "--store-host", store_host,
         "--store-port", str(store_port), "--device", device],
        env=env)


def _selfcheck(args: argparse.Namespace) -> int:
    from paddle_tpu_torch import observability as obs
    from .plane import MultiHostRouter
    from .transport import (SocketTransport, StoreClient, StoreServer,
                            rendezvous)

    failures: List[str] = []

    def check(ok: bool, what: str) -> None:
        print(f"[selfcheck] {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            failures.append(what)

    device = _device(args.device)
    prompts = _trace()
    store = StoreServer(host="127.0.0.1", port=0)
    names = ["w0", "w1"]
    print(f"[selfcheck] store on {store.host}:{store.port}; "
          f"spawning workers {names} on {device}", flush=True)
    procs = [_spawn_worker(n, store.host, store.port, str(device))
             for n in names]
    try:
        # the workers start up (torch import, the model, the engine's
        # build) while the reference engine runs
        print("[selfcheck] building in-process reference engine",
              flush=True)
        ref = _build_engine(device)
        import numpy as np
        rref = [ref.submit(np.asarray(p, np.int32), max_new_tokens=8)
                for p in prompts]
        ref_out = dict(ref.drain())
        expected = [ref_out[r] for r in rref]
        client = StoreClient(store.host, store.port)
        addrs = rendezvous(client, names, timeout=args.timeout)
        print(f"[selfcheck] rendezvous complete: {addrs}", flush=True)
        transports = OrderedDict(
            (n, SocketTransport(addrs[n][0], addrs[n][1], name=n,
                                timeout=10.0, retries=1, backoff=0.05))
            for n in names)
        plane = MultiHostRouter(transports, policy="prefix")
        rids = [plane.submit(p, max_new_tokens=8) for p in prompts]
        for _ in range(3):
            plane.step()
        victim = None
        for rid in rids:
            w = plane.worker_of(rid)
            if w is not None:
                victim = w
                break
        check(victim is not None, "some request is placed before the kill")
        if victim is not None:
            k = names.index(victim)
            print(f"[selfcheck] killing worker process {victim} "
                  f"(pid {procs[k].pid}) mid-trace", flush=True)
            procs[k].kill()
            procs[k].wait(timeout=30)
        out = dict(plane.drain())
        check(all(out[rids[i]] == list(expected[i])
                  for i in range(len(prompts))),
              "outputs token-identical to the in-process reference")
        check(len(plane.lost_workers) == 1, "exactly one worker lost")
        check(plane.step_traces <= 1, "surviving engine built its step once")
        rlog = obs.get_request_log()
        saw_failover = False
        for rid in rids:
            uid = plane.request_uid(rid)
            evs = [ev["name"] for ev in rlog.timeline(uid)]
            check(evs.count("submitted") == 1,
                  f"uid {uid}: one submitted event")
            check("retired" in evs, f"uid {uid}: retired")
            if "failover" in evs:
                saw_failover = True
                order = [evs.index("worker_lost"), evs.index("failover"),
                         len(evs) - 1 - evs[::-1].index("placed")]
                check(order == sorted(order),
                      f"uid {uid}: worker_lost -> failover -> placed order")
        check(saw_failover, "at least one request failed over")
        # the merged fleet timeline over real processes must stitch both
        # workers' clock domains onto the plane clock
        trace = plane.export_merged_perfetto()
        tracks = {e["args"]["name"] for e in trace["traceEvents"]
                  if e.get("name") == "process_name"}
        check({"paddle_tpu worker w0",
               "paddle_tpu worker w1"} <= tracks,
              "merged timeline carries both worker process tracks")
        stitched = any(
            str(e.get("name", "")).startswith("on w")
            and e.get("ph") == "X"
            for e in trace["traceEvents"])
        check(stitched, "merged timeline has >= 1 stitched "
                        "cross-process request track")
        check(any(str(e.get("name", "")).startswith("rpc.call:")
                  for e in trace["traceEvents"]),
              "merged timeline splits rpc.call slices")
        plane.shutdown()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        store.stop()
    if failures:
        print(f"[selfcheck] FAILED: {failures}", flush=True)
        return 1
    print("[selfcheck] PASS", flush=True)
    return 0


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.multihost")
    ap.add_argument("--worker", action="store_true",
                    help="run one engine worker process")
    ap.add_argument("--selfcheck", action="store_true",
                    help="spawn 2 worker processes, run the kill-"
                         "failover trace, exit non-zero on drift")
    ap.add_argument("--name", default="w0")
    ap.add_argument("--store-host", default="127.0.0.1")
    ap.add_argument("--store-port", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the engines run (default: the card; "
                         "'cpu' to run without one); the spawned workers "
                         "take the same")
    ap.add_argument("--timeout", type=float, default=240.0,
                    help="rendezvous timeout (workers import torch and "
                         "build the tiny model's engine first)")
    args = ap.parse_args(argv)
    if args.worker:
        return _run_worker(args)
    if args.selfcheck:
        return _selfcheck(args)
    ap.error("pick a mode: --worker or --selfcheck")
    return 2


if __name__ == "__main__":
    sys.exit(main())
