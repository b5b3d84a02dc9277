"""The port's HTTP exposition (``paddle_tpu_torch/observability/
http_exposition.py``) against the JAX package's, on the CPU.

Real GETs over an ephemeral loopback port: the four cases of
``tests/test_http_exposition.py`` on the port's server; ``/metrics``
byte-equal to the JAX server's body over the same series; ``/healthz``
equal to the JAX server's for engines in the same state (served the same
requests); with a multihost plane attached, ``/fleet`` equal to the JAX
server's for planes in the same state, ``/metrics`` carrying the
federated ``paddle_tpu_fleet_`` series a worker, and ``POST
/v1/generate`` streaming the reference's chunks.  Then the control
plane's new modules import no JAX: the
router, admission, autoscaler, load generator, fleet simulator and the
exposition, imported in a subprocess, leave ``jax`` and ``paddle_tpu``
out of ``sys.modules``.  Tolerance: exact.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import flags as jflags
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.observability import http_exposition as jhttp
from paddle_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import one_thread  # noqa: F401
from paddle_tpu_torch import flags
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.observability.http_exposition import (ExpositionServer,
                                                            maybe_serve)
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.serving import ServingEngine

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Each test on one intra-op thread (``torch_chip_rehearsal``): its
    tensors are tiny, and six parallel workers that each take every core
    make such tests many times slower than alone."""
    yield


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


# -- the reference's four cases --------------------------------------------

def test_disabled_by_default_and_off_at_port_zero():
    assert flags.flag("metrics_port") == 0
    assert maybe_serve() is None            # the default: no socket
    srv = ExpositionServer(port=0)
    assert not srv.enabled
    assert srv.start() is srv               # a no-op, still unbound
    assert srv.port == 0


def test_metrics_healthz_requests_and_404_over_http():
    reg = MetricsRegistry()
    reg.counter("t.hits", "exposition smoke").labels(op="a").inc(3)
    with ExpositionServer(port=-1, registry=reg) as srv:
        assert srv.port > 0                 # the ephemeral port resolved

        code, ctype, body = _get(srv.port, "/metrics")
        assert code == 200
        assert ctype.startswith("text/plain")
        assert body.decode() == reg.prometheus_text()

        code, ctype, body = _get(srv.port, "/healthz")
        assert code == 200 and ctype.startswith("application/json")
        h = json.loads(body)
        assert h["ok"] is True
        assert h["perf_anomalies"] == 0
        assert h["engines"] == []

        code, _, body = _get(srv.port, "/requests?n=4")
        tail = json.loads(body)
        assert set(tail) == {"requests", "total", "limit"}

        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.port, "/no/such/path")
        assert e.value.code == 404
        assert json.loads(e.value.read()) == {"error": "not found"}
    # the context manager tore the socket down
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        _get(srv.port, "/healthz")


class _DriftyEngine:
    _eid = "9"
    num_slots = 2
    step_traces = 1

    def perf_report(self):
        return {"drift": [{"rule": "perf-drift"}]}


class _RebuiltEngine:
    _eid = "7"
    num_slots = 2
    step_traces = 3                        # past the built-once budget

    def perf_report(self):
        return {"drift": []}


def test_healthz_folds_in_engine_drift_and_rebuilds():
    with ExpositionServer(port=-1, registry=MetricsRegistry(),
                          engines=[_DriftyEngine()]) as srv:
        h = json.loads(_get(srv.port, "/healthz")[2])
        assert h["ok"] is False
        assert h["engines"] == [{"engine": "9", "num_slots": 2,
                                 "step_traces": 1, "drift_findings": 1}]
    with ExpositionServer(port=-1, registry=MetricsRegistry(),
                          engines=[_RebuiltEngine()]) as srv:
        h = json.loads(_get(srv.port, "/healthz")[2])
        assert h["ok"] is False
        assert h["engines"][0]["step_traces"] == 3


def test_maybe_serve_honours_the_flag():
    old = flags.flag("metrics_port")
    flags.set_flags({"metrics_port": -1})
    try:
        srv = maybe_serve()
        assert srv is not None
        assert _get(srv.port, "/healthz")[0] == 200
        srv.stop()
    finally:
        flags.set_flags({"metrics_port": old})


# -- against the JAX server ------------------------------------------------

def _fill(reg):
    """The same series in either package's registry."""
    reg.counter("router.requests", "requests placed").labels(
        router="0", replica="1", route="prefix").inc(5)
    reg.gauge("router.held_requests", "held").labels(router="0").set(2)
    h = reg.histogram("serving.ttft_ms", "time to first token")
    for v in (0.5, 3.0, 12.0, 250.0):
        h.labels(engine="0").observe(v)


def test_metrics_body_byte_equal_to_jax_server():
    treg, jreg = MetricsRegistry(), JaxRegistry()
    _fill(treg)
    _fill(jreg)
    with ExpositionServer(port=-1, registry=treg) as t, \
            jhttp.ExpositionServer(port=-1, registry=jreg) as j:
        got, want = _get(t.port, "/metrics"), _get(j.port, "/metrics")
    assert got == want
    assert b"router_requests" in got[2]


@pytest.fixture(scope="module")
def pair():
    pt.seed(7)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    return jm, tm


def test_healthz_equal_to_jax_for_engines_in_the_same_state(pair):
    jm, tm = pair
    prompts = [np.arange(3 + i, 13 + 2 * i, dtype=np.int32) for i in range(3)]
    engines = []
    for eng in (JaxEngine(jm, num_slots=2, max_length=64),
                ServingEngine(tm, num_slots=2, max_length=64,
                              device="cpu")):
        for p in prompts:
            eng.submit(p, max_new_tokens=4)
        eng.drain()
        engines.append(eng)
    with jhttp.ExpositionServer(port=-1, registry=JaxRegistry(),
                                engines=[engines[0]]) as j, \
            ExpositionServer(port=-1, registry=MetricsRegistry(),
                             engines=[engines[1]]) as t:
        want = json.loads(_get(j.port, "/healthz")[2])
        got = json.loads(_get(t.port, "/healthz")[2])
    for h, eng in ((want, engines[0]), (got, engines[1])):
        assert h["engines"][0].pop("engine") == eng._eid
    assert got == want
    assert got["ok"] is True and got["engines"][0]["step_traces"] == 1
    assert jflags.flag("metrics_port") == flags.flag("metrics_port") == 0


# -- the multihost plane's routes, against the JAX server's ----------------

def _planes(pair, prompts):
    """The port's and the JAX package's two-worker loopback plane, each
    having served ``prompts`` (6 new tokens) to the end."""
    from collections import OrderedDict

    from paddle_tpu.serving import multihost as jmh
    from paddle_tpu_torch.serving import multihost as tmh

    planes = []
    for m, mh in zip(pair, (jmh, tmh)):
        workers = OrderedDict()
        for i in range(2):
            kw = dict(num_slots=2, max_length=64, paged=True, block_len=8)
            eng = (ServingEngine(m, device="cpu", **kw)
                   if mh is tmh else JaxEngine(m, **kw))
            w = mh.EngineWorker(eng, name=f"w{i}")
            workers[f"w{i}"] = mh.LoopbackTransport(w.handle, name=f"w{i}")
        plane = mh.MultiHostRouter(workers, policy="prefix")
        for p in prompts:
            plane.submit(p, max_new_tokens=6)
        plane.drain()
        planes.append(plane)
    return planes


def test_fleet_and_federated_metrics_equal_to_jax_for_planes(pair):
    """``/fleet`` of a server attached to a plane equals the JAX server's
    for planes that served the same requests (the last tick's measured /
    predicted ratio, a wall-clock reading, aside); ``/metrics`` appends
    the federated worker series; without a plane ``/fleet`` is 404."""
    prompts = [np.arange(3 + i, 13 + 2 * i, dtype=np.int32)
               for i in range(3)]
    jplane, tplane = _planes(pair, prompts)
    with jhttp.ExpositionServer(port=-1, engines=[jplane]) as j, \
            ExpositionServer(port=-1, engines=[tplane]) as t:
        want = json.loads(_get(j.port, "/fleet")[2])
        got = json.loads(_get(t.port, "/fleet")[2])
        status, ctype, text = _get(t.port, "/metrics")
    for fleet in (got, want):
        for w in fleet["workers"].values():
            w.pop("last_step_ratio")
    assert got == want
    assert got["plane"]["ticks"] > 0 and all(
        w["alive"] for w in got["workers"].values())
    assert status == 200 and ctype.startswith("text/plain")
    assert b"paddle_tpu_fleet_" in text
    assert b'worker="w0"' in text and b'worker="w1"' in text
    with ExpositionServer(port=-1, registry=MetricsRegistry()) as t:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(t.port, "/fleet")
    assert e.value.code == 404


def _post(port, path, body):
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("POST", path, body=body,
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    out = (r.status, r.read())
    c.close()
    return out


def test_generate_stream_equal_to_jax(pair):
    """``POST /v1/generate`` through each package's front end: the
    streamed JSON lines equal (the uid and rid aside: each package's log
    mints its own), tokens arriving over more than one chunk; a server
    without a generator answers 404, bad JSON 400."""
    from paddle_tpu.serving import multihost as jmh
    from paddle_tpu_torch.serving import multihost as tmh

    jplane, tplane = _planes(pair, [])
    body = json.dumps({"prompt": list(range(3, 14)),
                       "max_new_tokens": 6})
    lines = []
    for plane, mh in ((jplane, jmh), (tplane, tmh)):
        fe = mh.ServingFrontend(plane)
        srv = fe.serve(port=-1)
        try:
            status, raw = _post(srv.port, "/v1/generate", body)
            assert status == 200
            bad = _post(srv.port, "/v1/generate", b"{not json")
        finally:
            srv.stop()
            fe.stop()
        assert bad[0] == 400
        lines.append([dict(ln, **{k: "#" for k in ("uid", "rid")
                                  if k in ln})
                      for ln in map(json.loads, raw.splitlines())])
    want, got = lines
    assert got == want
    assert len([ln for ln in got if "tokens" in ln]) > 1
    assert got[-1]["done"] is True and got[-1]["tokens_total"] == 6
    with ExpositionServer(port=-1, registry=MetricsRegistry()) as t:
        assert _post(t.port, "/v1/generate", body)[0] == 404


# -- the new modules import no JAX -----------------------------------------

def test_control_plane_imports_leave_jax_out():
    code = ("import sys, paddle_tpu_torch.serving.admission, "
            "paddle_tpu_torch.serving.router, "
            "paddle_tpu_torch.serving.autoscaler, "
            "paddle_tpu_torch.serving.loadgen, "
            "paddle_tpu_torch.serving.fleet_sim, "
            "paddle_tpu_torch.observability.http_exposition; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
