"""The port's multihost serving plane (``paddle_tpu_torch/serving/
multihost/``) against the JAX package's, on the CPU.

* The ten cases of ``tests/test_multihost.py`` on the port: the codec and
  framing, the RPC server and the rendezvous store over localhost
  sockets, the plane over loopback workers (placement, a worker killed
  mid-decode, disaggregated prefill and decode with migration) and the
  streaming front end over HTTP.  Each plane case runs the port's plane
  beside the JAX plane on the same prompts and holds tokens, placements
  (``worker_of``), timelines (event names a request and the timeline
  signature), the ``multihost.*`` aggregates and the migrated bytes
  equal; failover is token-identical at float32.
* The codec: frames without bfloat16 are byte-equal to the reference's
  (a float32 tensor travels as the reference's numpy array), the two
  packages' sockets interoperate, and a bfloat16 payload round-trips
  bit for bit (NaN, infinities and subnormals included).
* The ``lint`` verb answers ``RpcError(kind="NotImplementedError")``
  naming ROADMAP A11, never an empty list of findings.
* ``python -m paddle_tpu_torch.serving.multihost --selfcheck --device
  cpu`` (two worker processes over sockets, one killed mid-trace) exits 0;
  without ``--device`` both modes ask for the card and raise without one.

One JAX ``tiny_llama_config`` model (float32, seed 0) is bridged into the
port (``models/convert.py``).  Tolerance: exact (tokens, counts, bytes,
signatures).
"""

import http.client
import json
import os
import socket
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import observability as jobs
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import multihost as jmh
from paddle_tpu.serving.multihost import transport as jtransport

from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import one_thread  # noqa: F401
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import multihost as tmh
from paddle_tpu_torch.serving.multihost import (
    EngineWorker, LoopbackTransport, MultiHostRouter, RpcError, RpcServer,
    ServingFrontend, SocketTransport, StoreClient, StoreServer,
    TransportError, decode_message, encode_message, rendezvous)
from paddle_tpu_torch.serving.multihost.transport import (read_frame,
                                                          write_frame)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Each test on one intra-op thread (``torch_chip_rehearsal``)."""
    yield


# -- the codec and framing (no sockets, no engines) ------------------------

def test_codec_roundtrip_arrays_bytes_nested():
    msg = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
           "b": np.float32(1.5), "c": b"\x00\xffraw",
           "d": {"nested": [1, "two", None, True,
                            np.array([0.25, -2.0], np.float64)]},
           5: "int-key"}
    out = decode_message(encode_message(msg))
    np.testing.assert_array_equal(out["a"], msg["a"])
    assert out["a"].dtype == np.int32 and out["a"].shape == (3, 4)
    assert out["b"] == 1.5 and out["c"] == b"\x00\xffraw"
    assert out["d"]["nested"][:4] == [1, "two", None, True]
    np.testing.assert_array_equal(out["d"]["nested"][4],
                                  np.array([0.25, -2.0]))
    assert out["5"] == "int-key"
    # the reference's frame, byte for byte, and each side decodes the
    # other's
    assert encode_message(msg) == jtransport.encode_message(msg)
    back = jtransport.decode_message(encode_message(msg))
    np.testing.assert_array_equal(back["a"], msg["a"])


def test_codec_frames_without_bf16_byte_equal_to_reference():
    """A tensor of a dtype numpy holds travels as the reference's numpy
    array: a frame of float32 / int8 / int32 tensors (an export record's
    blocks, a float32 pool's and an int8 pool's) is byte-equal to the
    reference's frame of the same arrays, and decodes to numpy."""
    g = torch.Generator().manual_seed(3)
    f32 = torch.randn(2, 2, 8, 4, 16, generator=g)
    i8 = torch.randint(-127, 128, (2, 2, 8, 4, 16), dtype=torch.int8,
                       generator=g)
    sc = torch.rand(2, 2, 4, generator=g)
    msg = {"record": {"uid": 3, "blocks": {"entries": [
        {"dtype": "bf16", "payload": (f32,)},
        {"dtype": "int8", "payload": (i8, sc)}]}},
        "ids": torch.arange(5, dtype=torch.int32)}
    as_np = {"record": {"uid": 3, "blocks": {"entries": [
        {"dtype": "bf16", "payload": (f32.numpy(),)},
        {"dtype": "int8", "payload": (i8.numpy(), sc.numpy())}]}},
        "ids": np.arange(5, dtype=np.int32)}
    frame = encode_message(msg)
    assert frame == jtransport.encode_message(as_np)
    out = decode_message(frame)
    p = out["record"]["blocks"]["entries"][1]["payload"]
    assert isinstance(p[0], np.ndarray) and p[0].dtype == np.int8
    assert np.array_equal(p[0], i8.numpy()) and np.array_equal(
        p[1], sc.numpy())


def test_codec_bf16_round_trip_bit_equal():
    """bfloat16 (which numpy cannot hold) as raw bytes under the torch
    dtype's name: every bit pattern back as it went, NaN payloads,
    infinities, signed zeros and subnormals included, and an empty
    tensor."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    bf = bits.view(torch.bfloat16).reshape(256, 256)
    out = decode_message(encode_message({"kv": (bf, bf[:0])}))
    got, empty = out["kv"]
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    assert got.shape == bf.shape and empty.shape == (0, 256)
    assert torch.equal(got.view(torch.int16), bf.view(torch.int16))
    frame = json.loads(encode_message({"x": bf[:1, :2]}))
    assert set(frame["x"]) == {"__tensor__"}
    assert frame["x"]["__tensor__"]["dtype"] == "bfloat16"
    # a frame naming something that is not a dtype is refused
    frame["x"]["__tensor__"]["dtype"] = "save"
    with pytest.raises(ValueError, match="no torch dtype"):
        decode_message(json.dumps(frame).encode())


def test_framing_length_prefix_roundtrip_and_cap():
    a, b = socket.socketpair()
    try:
        body = encode_message({"x": np.arange(5)})
        write_frame(a, body)
        write_frame(a, b"")
        assert read_frame(b) == body
        assert read_frame(b) == b""
        # the two packages' framing is one wire format
        jtransport.write_frame(a, body)
        assert read_frame(b) == body
        a.sendall(b"\xff\xff\xff\xff")
        with pytest.raises(ConnectionError, match="exceeds cap"):
            read_frame(b)
    finally:
        a.close()
        b.close()


# -- RPC and rendezvous over localhost sockets ------------------------------

def test_rpc_server_roundtrip_remote_error_and_dead_peer():
    calls = []

    def handler(method, payload):
        calls.append(method)
        if method == "boom":
            raise ValueError("rejected: no slot")
        return {"echo": payload}

    srv = RpcServer(handler, port=0)
    t = SocketTransport(srv.host, srv.port, name="t0", timeout=5.0,
                        retries=1, backoff=0.01)
    try:
        out = t.call("ping", {"arr": np.arange(3, dtype=np.int32)})
        np.testing.assert_array_equal(out["echo"]["arr"], np.arange(3))
        with pytest.raises(RpcError) as ei:
            t.call("boom", {})
        assert ei.value.kind == "ValueError"
        assert "no slot" in str(ei.value)
        # the reference's client speaks to the port's server
        jt = jtransport.SocketTransport(srv.host, srv.port, name="jt",
                                        timeout=5.0, retries=0)
        assert jt.call("ping", {"v": 1})["echo"] == {"v": 1}
        jt.close()
    finally:
        srv.stop()
        t.close()
    t2 = SocketTransport(srv.host, srv.port, name="t1", timeout=1.0,
                         retries=0, backoff=0.01)
    with pytest.raises(TransportError):
        t2.call("ping", {})
    t2.close()
    assert calls == ["ping", "boom", "ping"]


def test_store_rendezvous_wait_and_timeout():
    with StoreServer() as store:
        c1 = StoreClient(store.host, store.port)
        c2 = StoreClient(store.host, store.port)
        try:
            c1.set("worker/w0", {"host": "127.0.0.1", "port": 1111})
            assert c2.get("worker/w0")["port"] == 1111
            assert c2.get("worker/missing") is None
            c2.set("worker/w1", {"host": "127.0.0.1", "port": 2222})
            addrs = rendezvous(c1, ["w0", "w1"], timeout=5.0)
            assert addrs == {"w0": ("127.0.0.1", 1111),
                             "w1": ("127.0.0.1", 2222)}
            with pytest.raises(RpcError) as ei:
                c1.wait(["worker/w2"], timeout=0.2)
            assert ei.value.kind == "TimeoutError"
        finally:
            c1.close()
            c2.close()


# -- the plane over loopback workers, port beside JAX ----------------------

@pytest.fixture(scope="module")
def pair():
    pt.seed(0)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    tm.eval()
    return jm, tm


ENGINE_KW = dict(num_slots=4, max_length=128, prefill_batch=2, paged=True,
                 block_len=8)


def _engine(model):
    if isinstance(model, LlamaForCausalLM):
        return ServingEngine(model, device="cpu", **ENGINE_KW)
    return JaxEngine(model, **ENGINE_KW)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(3, 90, size=n).tolist() for n in (7, 12, 9, 15)]


@pytest.fixture(scope="module")
def ref_tokens(pair, prompts):
    """The single-engine greedy reference, port and JAX alike."""
    outs = []
    for m in pair:
        eng = _engine(m)
        rids = [eng.submit(np.asarray(p, np.int32), max_new_tokens=8)
                for p in prompts]
        out = dict(eng.drain())
        outs.append([list(out[r]) for r in rids])
    assert outs[0] == outs[1]
    return outs[1]


def _plane(model, policy="prefix", prefill=None):
    port = isinstance(model, LlamaForCausalLM)
    mh = tmh if port else jmh
    workers = OrderedDict()
    for i in range(2):
        w = mh.EngineWorker(_engine(model), name=f"w{i}")
        workers[f"w{i}"] = mh.LoopbackTransport(w.handle, name=f"w{i}")
    return mh.MultiHostRouter(workers, policy=policy, prefill=prefill)


def _run(model, prompts, policy="prefix", prefill=None, kill_at=None):
    """One plane run: submit every prompt (8 new tokens), step (killing
    the first placed request's worker after ``kill_at`` ticks), drain.
    Returns what the port and the JAX package must agree on."""
    log = (tobs if isinstance(model, LlamaForCausalLM)
           else jobs).get_request_log()
    plane = _plane(model, policy, prefill)
    mark = log.mark()
    rids = [plane.submit(p, max_new_tokens=8) for p in prompts]
    placed = [plane.worker_of(r) for r in rids]
    victim = None
    if kill_at is not None:
        for _ in range(kill_at):
            plane.step()
        victim = next(plane.worker_of(r) for r in rids
                      if plane.worker_of(r) is not None)
        plane._workers[victim].kill()
    out = dict(plane.drain())
    end = log.mark()
    agg = dict(plane.metrics()["aggregate"])
    agg.pop("workers")                  # engine ids and wall-clock ratios
    return {"plane": plane, "tokens": [out[r] for r in rids],
            "placed": placed, "worker_of": [plane.worker_of(r)
                                            for r in rids],
            "victim": victim,
            "events": [log.event_names(plane.request_uid(r))
                       for r in rids],
            "signature": log.timeline_signature(since_uid=mark,
                                                until_uid=end),
            "aggregate": agg, "step_traces": plane.step_traces,
            "fleet": plane.fleet_report()}


def _same(got, want):
    for k in ("tokens", "placed", "worker_of", "victim", "events",
              "signature", "aggregate", "step_traces"):
        assert got[k] == want[k], k


def test_plane_parity_and_one_timeline(pair, prompts, ref_tokens):
    jm, tm = pair
    got, want = _run(tm, prompts), _run(jm, prompts)
    _same(got, want)
    assert got["tokens"] == ref_tokens
    assert got["step_traces"] <= 1
    for names in got["events"]:
        assert names[0] == "submitted" and "retired" in names
        assert names.count("submitted") == 1


def _plane_rows(snap, family, plane):
    return sorted((tuple(sorted((k, v) for k, v in r["labels"].items()
                                if k != "plane")), r["value"])
                  for r in snap[family]["series"]
                  if r["labels"].get("plane") == plane._pid)


def test_worker_loss_failover_keeps_one_timeline(pair, prompts,
                                                 ref_tokens):
    """A worker killed mid-decode: every request completes with the
    reference tokens (float32: token for token), one timeline a uid
    (``worker_lost -> failover -> placed``), the loss classified in
    ``plane.worker_lost`` and the survivor's heartbeat age exact, all as
    the JAX plane does."""
    jm, tm = pair
    got = _run(tm, prompts, kill_at=4)
    gsnap = tobs.snapshot()
    want = _run(jm, prompts, kill_at=4)
    wsnap = jobs.snapshot()
    _same(got, want)
    assert got["tokens"] == ref_tokens
    plane = got["plane"]
    victim = got["victim"]
    assert list(plane.lost_workers) == [victim]
    assert got["aggregate"]["failovers"] >= 1
    for fam in ("plane.worker_lost", "plane.heartbeat_age_ticks",
                "multihost.failovers", "multihost.workers_lost",
                "multihost.heartbeats"):
        assert (_plane_rows(gsnap, fam, plane)
                == _plane_rows(wsnap, fam, want["plane"])), fam
    (lost,) = _plane_rows(gsnap, "plane.worker_lost", plane)
    assert dict(lost[0])["worker"] == victim and lost[1] == 1
    assert dict(lost[0])["reason"] in ("missed_heartbeat",
                                       "transport_error")
    survivor = next(n for n in ("w0", "w1") if n != victim)
    fleet = got["fleet"]["workers"]
    assert fleet[survivor]["alive"] is True
    assert 0 <= fleet[survivor]["heartbeat_age_ticks"] <= plane._hb_every
    assert fleet[victim]["alive"] is False
    assert fleet[victim]["heartbeat_age_ticks"] is None
    saw_failover = False
    for names in got["events"]:
        assert names.count("submitted") == 1, names
        if "failover" in names:
            saw_failover = True
            placed = [j for j, n in enumerate(names) if n == "placed"]
            assert (names.index("worker_lost") < names.index("failover")
                    < max(placed)), names
    assert saw_failover


def test_disagg_migration_token_identical(pair, prompts, ref_tokens):
    """``disagg``: w0 prefills, each request migrates to w1 after its
    first token (export / import over the transport): tokens equal the
    reference's, and the migrations and migrated bytes (float32 pools)
    equal the JAX plane's."""
    jm, tm = pair
    got = _run(tm, prompts, policy="disagg", prefill=["w0"])
    want = _run(jm, prompts, policy="disagg", prefill=["w0"])
    _same(got, want)
    agg = got["aggregate"]
    assert got["tokens"] == ref_tokens
    assert agg["migrations"] >= 1 and agg["migration_bytes"] > 0
    assert got["step_traces"] <= 1
    migrated = 0
    for names in got["events"]:
        assert names.count("submitted") == 1
        if "migrated" in names:
            migrated += 1
            assert names.index("migrated") > names.index("placed")
    assert migrated == agg["migrations"]
    # a float32 block of the tiny model: 2 layers x K / V x 8 positions
    # x 2 KV heads x 16 dims x 4 bytes; every request's blocks counted
    assert agg["migration_bytes"] % (2 * 2 * 8 * 2 * 16 * 4) == 0


def test_lint_verb_names_a11_never_an_empty_list(pair):
    _, tm = pair
    w = EngineWorker(_engine(tm), name="w0")
    t = LoopbackTransport(w.handle, name="w0")
    with pytest.raises(RpcError) as ei:
        t.call("lint", {})
    assert ei.value.kind == "NotImplementedError"
    assert "A11" in ei.value.message


# -- the streaming front end over HTTP, port beside JAX --------------------

def _stream(frontend_cls, plane, prompt):
    """One ``POST /v1/generate`` against a live server, and the
    ``/requests`` probes; returns the streamed lines (uid and rid
    replaced by their place), whether the request had retired when its
    first token chunk was read, and the probes."""
    fe = frontend_cls(plane)
    srv = fe.serve(port=-1)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=60)
        body = json.dumps({"prompt": prompt, "max_new_tokens": 8})
        conn.request("POST", "/v1/generate", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        lines, buf = [], b""
        retired_at_first_chunk = None
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                obj = json.loads(line)
                lines.append(obj)
                if "tokens" in obj and retired_at_first_chunk is None:
                    retired_at_first_chunk = plane._reqs[
                        lines[0]["rid"]].done
        conn.close()
        uid = lines[0]["uid"]

        def get(path):
            c = http.client.HTTPConnection("127.0.0.1", srv.port,
                                           timeout=30)
            c.request("GET", path)
            r = c.getresponse()
            out = (r.status, json.loads(r.read()))
            c.close()
            return out

        probes = {"uid": get(f"/requests?uid={uid}"),
                  "missing": get("/requests?uid=999999"),
                  "limit": get("/requests?limit=1")}
    finally:
        srv.stop()
        fe.stop()
    norm = [dict(ln, **{k: "#" for k in ("uid", "rid") if k in ln})
            for ln in lines]
    return {"lines": lines, "norm": norm, "uid": uid,
            "retired_at_first_chunk": retired_at_first_chunk,
            "probes": probes}


@pytest.fixture()
def http_run(pair, prompts):
    jm, tm = pair
    got = _stream(ServingFrontend, _plane(tm), prompts[0])
    want = _stream(jmh.ServingFrontend, _plane(jm), prompts[0])
    return got, want


def test_streaming_generate_first_chunk_before_retirement(http_run,
                                                          ref_tokens):
    got, want = http_run
    lines = got["lines"]
    toks = [t for ln in lines if "tokens" in ln for t in ln["tokens"]]
    assert toks == ref_tokens[0]
    done = lines[-1]
    assert done.get("done") is True and done["tokens_total"] == len(toks)
    assert len([ln for ln in lines if "tokens" in ln]) > 1
    assert got["retired_at_first_chunk"] is False
    # the JAX front end's stream, line for line (ids apart)
    assert got["norm"] == want["norm"]


def test_requests_endpoint_uid_lookup(http_run):
    got, want = http_run
    status, tl = got["probes"]["uid"]
    assert status == 200 and tl["found"] and tl["uid"] == got["uid"]
    names = [ev["name"] for ev in tl["events"]]
    assert names[0] == "submitted" and "retired" in names
    assert names == [ev["name"] for ev in want["probes"]["uid"][1]["events"]]
    status, missing = got["probes"]["missing"]
    assert status == 404 and missing["found"] is False


def test_requests_endpoint_bounded_limit(http_run):
    got, _ = http_run
    status, tail = got["probes"]["limit"]
    assert status == 200
    assert tail["limit"] == 1 and len(tail["requests"]) <= 1


# -- worker processes over sockets -----------------------------------------

def test_selfcheck_worker_processes_on_the_cpu():
    """Two worker processes over a TCP store and sockets, one killed
    mid-trace: every request finishes token-identical to an in-process
    engine, one timeline a request, the merged Perfetto timeline
    stitched across processes."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving.multihost",
         "--selfcheck", "--device", "cpu"], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert "[selfcheck] PASS" in res.stdout


def test_worker_processes_load_a_built_library_without_building(
        monkeypatch, tmp_path):
    """A worker process finds the kernels its parent built and builds
    nothing: a library's content-hashed path exists only once it is
    whole (``_build.build`` writes a temporary file and renames it), and
    an existing path starts no ``nvcc``."""
    from paddle_tpu_torch.ops.cuda import _build
    lib = tmp_path / "decode_attention-0123456789abcdef.so"
    lib.write_bytes(b"built by the parent")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_library", lambda name: lib)

    def no_nvcc(*args, **kwargs):
        raise AssertionError("a second build started")
    monkeypatch.setattr(_build.subprocess, "Popen", no_nvcc)
    assert _build.build(["decode_attention"]) == {"decode_attention": lib}
    assert [p.name for p in tmp_path.iterdir()] == [lib.name]


@pytest.mark.parametrize("mode", ["--selfcheck", "--worker"])
def test_modes_run_on_the_card_unless_asked(monkeypatch, mode):
    """No ``--device``: both modes ask for the card, and a box without
    one refuses them rather than falling back to the CPU (before any
    store, socket or worker process is made)."""
    from paddle_tpu_torch.serving.multihost import __main__ as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([mode, "--store-port", "1"])


def test_multihost_imports_leave_jax_out():
    code = ("import sys, paddle_tpu_torch.serving.multihost, "
            "paddle_tpu_torch.serving.multihost.__main__, "
            "paddle_tpu_torch.observability.federation; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
