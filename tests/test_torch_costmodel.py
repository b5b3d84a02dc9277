"""The port's roofline cost model (``paddle_tpu_torch/observability/
costmodel.py``) and the engine's perf accounting, against the JAX
package's, on the CPU: the reference's ``tests/test_costmodel.py`` and
``tests/test_perf_model.py`` case by case.

The pure model gets the same inputs in both packages: every prediction
term equal to 1e-9 relative, the same bound, the same memo behaviour, the
same ``report()`` and ``perf_signature`` after the same ticks.  The port
carries the ``cpu_smoke`` profile unchanged and an ``h100`` one in place
of the reference's ``v5e``; the cases that named ``v5e`` name ``h100``.
The engines are one JAX ``tiny_llama_config`` model (float32) and its
port.
"""

import json

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import observability as jobs
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.observability import costmodel as jcm
from paddle_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.models.quantized import quantize_for_decode
from paddle_tpu_torch.observability import costmodel as cm
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.serving import ServingEngine

MAXLEN = 64
BL = 8


# -- profiles ----------------------------------------------------------------

def test_profiles_and_resolution():
    assert set(cm.PROFILES) == {"h100", "cpu_smoke"}
    h100 = cm.resolve_profile("h100")
    assert h100.peak_bf16_flops == 989e12
    assert h100.hbm_bps == 3350.0 * 1e9
    assert h100.host_bps == 42.0 * 1e9
    # the reference's profile, unchanged
    assert cm.PROFILES["cpu_smoke"].as_dict() == \
        jcm.PROFILES["cpu_smoke"].as_dict()
    # the tests run on the CPU: 'auto' (and the flag default) pick the
    # smoke profile; a CUDA device picks h100
    assert cm.resolve_profile("auto", device="cpu").name == "cpu_smoke"
    assert cm.resolve_profile(device="cpu").name == "cpu_smoke"
    assert cm.resolve_profile("auto", device="cuda").name == "h100"
    with pytest.raises(ValueError, match="unknown hardware profile"):
        cm.resolve_profile("v9000")
    with pytest.raises(ValueError, match="unknown hardware profile"):
        cm.resolve_profile("v5e")        # measured for a TPU: not carried


def test_profile_as_dict_round_trips():
    d = cm.PROFILES["h100"].as_dict()
    assert d == {"name": "h100", "peak_bf16_flops": 989e12,
                 "hbm_gbps": 3350.0, "ici_gbps": 900.0, "host_gbps": 42.0}
    assert cm.HardwareProfile(**d) == cm.PROFILES["h100"]


# -- prediction arithmetic ---------------------------------------------------

def _model(pkg=cm, **kw):
    """1 GB/s memory and interconnect, 1 GFLOP/s: every term is
    hand-computable."""
    prof = pkg.HardwareProfile("unit", peak_bf16_flops=1e9,
                               hbm_gbps=1.0, ici_gbps=1.0)
    kw.setdefault("weight_bytes", 1_000_000)
    kw.setdefault("n_params", 1_000)
    kw.setdefault("kv_token_bytes", 100.0)
    kw.setdefault("num_slots", 4)
    return pkg.CostModel(prof, **kw)


def _same(a, b):
    """Two prediction dicts equal: numbers to 1e-9 relative."""
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], float):
            assert a[k] == pytest.approx(b[k], rel=1e-9, abs=0.0), k
        else:
            assert a[k] == b[k], k


# (occ, live tokens, chunk tokens, window, swap bytes), model options
PREDICT_CASES = [
    ((4, 64, 0, 1, 0), {}),
    ((2, 16, 32, 1, 0), {}),
    ((2, 16, 0, 5, 0), {}),
    ((1, 0, 0, 1, 0), {}),
    ((4, 1024, 0, 1, 0), {"kv_token_bytes": 1e6}),
    ((4, 16, 0, 1, 0), {"n_params": 10**9}),
    ((4, 16, 0, 1, 10**9), {}),
    ((3, 33, 8, 4, 4096), {"weight_bytes": 123_457, "n_params": 9_876}),
]


@pytest.mark.parametrize("args,kw", PREDICT_CASES)
def test_predictions_equal_the_jax_model(args, kw):
    _same(_model(**kw).predict(*args), _model(jcm, **kw).predict(*args))


@pytest.mark.parametrize("args", [a for a, _ in PREDICT_CASES])
def test_cpu_smoke_predictions_equal_the_jax_model(args):
    kw = dict(weight_bytes=435456, n_params=108864, kv_token_bytes=512.0,
              num_slots=2)
    _same(cm.CostModel(cm.PROFILES["cpu_smoke"], **kw).predict(*args),
          jcm.CostModel(jcm.PROFILES["cpu_smoke"], **kw).predict(*args))


def test_predict_term_arithmetic():
    p = _model().predict(occ=4, live_tokens=64)
    assert p["weight_stream_ms"] == pytest.approx(1.0)
    assert p["kv_stream_ms"] == pytest.approx(64 * 100.0 / 1e9 * 1e3)
    assert p["compute_ms"] == pytest.approx(2 * 1_000 * 4 / 1e9 * 1e3)
    assert p["comm_ms"] == 0.0
    assert p["predicted_ms"] == pytest.approx(
        p["weight_stream_ms"] + p["kv_stream_ms"])
    assert p["bound"] == "weight-stream"


def test_chunk_and_window_grow_the_compute_term():
    m = _model()
    base = m.predict(2, 16)["compute_ms"]
    assert m.predict(2, 16, chunk_tokens=32)["compute_ms"] == \
        pytest.approx(base * (4 + 32) / 4)
    assert m.predict(2, 16, window=5)["compute_ms"] == \
        pytest.approx(base * 5)


def test_bound_verdicts_cover_all_five():
    assert _model().predict(1, 0)["bound"] == "weight-stream"
    assert _model(kv_token_bytes=1e6).predict(4, 1024)["bound"] \
        == "kv-stream"
    assert _model(n_params=10**9).predict(4, 16)["bound"] == "compute"
    big_comm = _model(comm_bytes_fn=lambda: 10**10)
    assert big_comm.predict(4, 16)["bound"] == "comm"
    assert big_comm.comm_bytes_per_step == 10**10
    assert _model().predict(4, 16, swap_bytes=10**9)["bound"] == "swap"
    assert _model().predicted_tick_ms(4, 16, swap_bytes=10**9) == \
        pytest.approx(1e3)


def test_comm_bytes_fn_is_lazy_and_memoized():
    calls = []
    m = _model(comm_bytes_fn=lambda: calls.append(1) or 4096)
    assert not calls
    m.predict(1, 8)
    m.predict(2, 8)
    assert calls == [1]
    m.clear()
    m.predict(1, 8)
    assert calls == [1, 1]


def test_depth_bucketing_and_memoization():
    m = _model()
    a = m.predict(2, 33)
    b = m.predict(2, 64)
    assert a is b
    assert a["live_tokens_bucket"] == 64
    assert m.predict(2, 65)["live_tokens_bucket"] == 128
    assert m.memo_size() == 2
    m.clear()
    assert m.memo_size() == 0


# -- dtype-aware KV cost -----------------------------------------------------

def test_kv_bytes_per_token_matches_the_jax_model():
    """The per-token KV cost of every pool dtype equals the JAX model's
    (the port reads the torch dtype's itemsize where the reference reads
    jnp's); int8 pays a byte plus the amortized float32 scale row, and
    shrinks the full-precision cost by the committed ratio (0.254 at the
    tiny config's float32)."""
    jc = jax_tiny()
    c = config_from(jc)
    for dt, kw in (("bf16", {}), ("int8", {"block_len": 16}),
                   ("int8", {}), ("mixed", {})):
        assert cm.kv_bytes_per_token(c, dt, **kw) == \
            jcm.kv_bytes_per_token(jc, dt, **kw)
    full = cm.kv_bytes_per_token(c, "bf16")
    int8 = cm.kv_bytes_per_token(c, "int8", block_len=16)
    tok = c.num_hidden_layers * 2 * c.num_key_value_heads * c.head_dim
    assert full == tok * 4
    scales = c.num_hidden_layers * 2 * c.num_key_value_heads * 4
    assert int8 == pytest.approx(tok + scales / 16)
    assert round(int8 / full, 3) == 0.254
    bf = config_from(jax_tiny(dtype="bfloat16"))
    assert cm.kv_bytes_per_token(bf, "bf16") == tok * 2


# -- attribution: signature determinism + reset ------------------------------

def _drive(measured, pkg=cm, reg=None):
    att = pkg.TickAttribution(_model(pkg), engine_id="sig",
                              registry=reg or MetricsRegistry())
    for i, ms in enumerate(measured):
        att.on_tick(ms, occ=2, live_tokens=8 + i)
    return att.report()


def test_perf_signature_is_schedule_deterministic():
    a = _drive([1.0] * 12)
    b = _drive([5.0, 2.0] * 6)
    assert cm.perf_signature(a) == cm.perf_signature(b)
    assert a["ratio"] != b["ratio"]
    assert a["measured_ms_sum"] != b["measured_ms_sum"]
    sig = json.loads(cm.perf_signature(a))
    assert sig["ticks_modeled"] == 12
    assert sig["profile"] == "unit"
    assert sig["drift"] == 0


def test_report_equals_the_jax_attribution():
    """The same measured ticks: the whole report (ratios, anomalies and
    drift included) and its signature equal the JAX attribution's, and
    the two registries hold the same ratio histograms."""
    ticks = [1.0] * 10 + [40.0] * 10
    jreg, reg = JaxRegistry(), MetricsRegistry()
    want = _drive(ticks, jcm, jreg)
    got = _drive(ticks, cm, reg)
    assert got == want
    assert got["drift"]                  # the slowdown left the band
    assert cm.perf_signature(got) == jcm.perf_signature(want)
    assert json.dumps(reg.snapshot()) == json.dumps(jreg.snapshot())


def test_report_bounds_partition_the_ticks():
    rep = _drive([1.0] * 10)
    assert rep["ticks_modeled"] == 10
    assert sum(b["ticks"] for b in rep["bounds"].values()) == 10
    assert sum(b["share"] for b in rep["bounds"].values()) \
        == pytest.approx(1.0)
    assert rep["ratio"]["count"] == 10
    assert rep["anomalies"] == {"ratio": 0, "tick_ms": 0,
                                "tpot": 0, "ttft": 0}


def test_observability_reset_clears_attribution_state():
    att = cm.TickAttribution(_model(), engine_id="rst",
                             registry=MetricsRegistry())
    att.on_tick(1.0, occ=1, live_tokens=8)
    assert att.report()["ticks_modeled"] == 1
    assert att.model.memo_size() == 1
    obs.reset()
    assert att.report()["ticks_modeled"] == 0
    assert att.model.memo_size() == 0
    assert att.report()["drift"] == []


def test_ewma_detector_equals_the_jax_detector():
    from paddle_tpu.observability.regression import EwmaDetector as JaxDet
    stream = [1.0, 9.0] + [1.0] * 8 + [1.2, 3.0, 6.0, 0.1, 0.1, 0.1, 8.0]
    for two_sided in (False, True):
        a = obs.EwmaDetector("k", tol=1.0, two_sided=two_sided)
        b = JaxDet("k", tol=1.0, two_sided=two_sided)
        assert [a.observe(v) for v in stream] == \
            [b.observe(v) for v in stream]
        assert a.state() == b.state() and a.anomalies > 0


# -- engine-level attribution ------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    pt.seed(7)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    return jm, tm


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


def _engine(model, **kw):
    return ServingEngine(model, device="cpu", **kw)


# the eight layouts the reference sweeps
LAYOUTS = [
    ("contiguous", {}),
    ("paged", dict(paged=True, block_len=BL)),
    ("contiguous+chunked", dict(chunked=True, prefill_chunk=8)),
    ("paged+chunked", dict(paged=True, block_len=BL, chunked=True,
                           prefill_chunk=8)),
    ("contiguous+spec", dict(spec_decode=True, spec_k=4)),
    ("paged+spec", dict(paged=True, block_len=BL, spec_decode=True,
                        spec_k=4)),
    ("paged+chunked+spec", dict(paged=True, block_len=BL, chunked=True,
                                prefill_chunk=8, spec_decode=True,
                                spec_k=4)),
    ("contiguous+chunked+spec", dict(chunked=True, prefill_chunk=8,
                                     spec_decode=True, spec_k=4)),
]


class _ScriptedClock:
    """A stand-in for the engine module's ``time``: each
    ``perf_counter`` call advances ``dt``, so a tick costs the clock reads
    it spans; raising ``dt`` mid-run fakes a sustained slowdown."""

    def __init__(self, dt=1e-4):
        self.t = 0.0
        self.dt = dt

    def perf_counter(self):
        self.t += self.dt
        return self.t


@pytest.mark.parametrize("name,kw", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_clean_layouts_produce_no_drift(pair, name, kw, monkeypatch):
    """Every clean layout models every tick and reports no drift (on a
    scripted clock, so host noise cannot fake a slowdown)."""
    from paddle_tpu_torch.serving import engine as engine_mod
    monkeypatch.setattr(engine_mod, "time", _ScriptedClock())
    _, tm = pair
    eng = _engine(tm, num_slots=3, max_length=MAXLEN, **kw)
    for i, n in enumerate((5, 9)):
        eng.submit(_prompt(n, seed=40 + i), max_new_tokens=16)
    eng.drain()
    rep = eng.perf_report()
    m = eng.metrics()
    assert rep["enabled"]
    assert rep["ticks_modeled"] == m["decode_ticks"] + m.get(
        "mixed_ticks", 0) > 0
    assert rep["drift"] == []
    assert sum(b["ticks"] for b in rep["bounds"].values()) \
        == rep["ticks_modeled"]
    assert sum(b["share"] for b in rep["bounds"].values()) \
        == pytest.approx(1.0)
    assert rep["model_inputs"]["weight_bytes"] > 0
    assert rep["memo_entries"] >= 1


def test_model_inputs_equal_the_jax_engine(pair):
    """weight_bytes and n_params count what the reference's params tree
    counts (RoPE tables included); with int8 weights, the int8 payloads,
    their scales and the float rest (RoPE tables below min_elems, which
    both keep in float)."""
    jm, tm = pair
    for kw in ({}, dict(paged=True, block_len=BL, kv_cache_dtype="int8")):
        want = JaxEngine(jm, num_slots=2, max_length=MAXLEN, **kw)
        got = _engine(tm, num_slots=2, max_length=MAXLEN, **kw)
        assert got.perf_report()["model_inputs"] == \
            want.perf_report()["model_inputs"]
    from paddle_tpu.models.quantized import quantize_for_decode as jq
    want = JaxEngine(jq(jm, min_elems=2048), num_slots=2,
                     max_length=MAXLEN)
    got = _engine(quantize_for_decode(tm, min_elems=2048), num_slots=2,
                  max_length=MAXLEN)
    wi = want.perf_report()["model_inputs"]
    assert got.perf_report()["model_inputs"] == wi
    assert wi["weight_bytes"] < _engine(tm, num_slots=2, max_length=MAXLEN
                                        ).perf_report()["model_inputs"][
        "weight_bytes"]


def test_int8_kv_shrinks_the_modeled_kv_term(pair):
    _, tm = pair
    full = _engine(tm, num_slots=2, max_length=MAXLEN, paged=True,
                   block_len=BL)
    int8 = _engine(tm, num_slots=2, max_length=MAXLEN, paged=True,
                   block_len=BL, kv_cache_dtype="int8")
    kf = full.perf_report()["model_inputs"]["kv_bytes_per_token"]
    k8 = int8.perf_report()["model_inputs"]["kv_bytes_per_token"]
    assert k8 < kf
    c = tm.config
    scales = c.num_hidden_layers * 2 * c.num_key_value_heads * 4
    assert k8 == pytest.approx(kf / 4 + scales / BL)


def test_perf_model_off_flag_disables_the_layer(pair, monkeypatch):
    _, tm = pair
    monkeypatch.setitem(flags._values, "perf_model", "off")
    eng = _engine(tm, num_slots=2, max_length=MAXLEN)
    eng.submit(_prompt(5, seed=44), max_new_tokens=4)
    eng.drain()
    assert eng.perf_report() == {"enabled": False}
    assert eng.admission_probe(8) is None and not eng.admission_armed()


def test_scripted_slow_tick_produces_drift_finding(pair, monkeypatch):
    """After the EWMA calibrates on steady ticks, a sustained slowdown
    pushes measured / predicted out of the band: perf_report carries a
    perf-drift finding in the reference's Finding shape and the anomaly
    counters trip; a reset clears it."""
    from paddle_tpu_torch.serving import engine as engine_mod
    _, tm = pair
    clk = _ScriptedClock()
    monkeypatch.setattr(engine_mod, "time", clk)
    eng = _engine(tm, num_slots=1, max_length=MAXLEN)
    eng.submit(_prompt(6, seed=50), max_new_tokens=40)
    for _ in range(16):
        eng.step()
    clk.dt *= 400.0
    eng.drain()
    rep = eng.perf_report()
    assert rep["drift"], "slowed ticks produced no drift finding"
    d = rep["drift"][0]
    assert d["rule"] == "perf-drift"
    assert d["severity"] == "warning"
    assert "bound=" in d["path"]
    assert "left the calibrated band" in d["message"]
    assert rep["anomalies"]["tick_ms"] >= 1
    assert rep["anomalies"]["ratio"] >= 1
    assert eng.perf_report()["drift"]
    obs.reset()
    assert eng.perf_report()["drift"] == []


def test_tick_model_counter_track_in_chrome_trace(pair, tmp_path):
    _, tm = pair
    eng = _engine(tm, num_slots=2, max_length=MAXLEN)
    eng.submit(_prompt(5, seed=60), max_new_tokens=6)
    eng.drain()
    path = tmp_path / "trace.json"
    obs.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    counters = [e for e in events
                if e.get("ph") == "C" and e["name"] == "serving.tick_model"]
    steps = [e for e in events
             if e.get("ph") == "X" and e["name"] == "serving.step"]
    assert steps and counters
    assert len(counters) == eng.perf_report()["ticks_modeled"]
    for e in counters:
        assert set(e["args"]) == {"predicted_ms", "measured_ms"}
        assert all(isinstance(v, float) for v in e["args"].values())
        assert e["args"]["predicted_ms"] > 0
        for k in ("ts", "pid", "tid", "cat"):
            assert k in e


# -- predictive admission ----------------------------------------------------

def _predictive_trace(eng):
    """Two batch requests decode, then an interactive one with a TPOT
    deadline the cost model prices as missed at three rows."""
    for s in (0, 1):
        eng.submit(_prompt(6, seed=70 + s), max_new_tokens=8)
    eng.step()
    eng.submit(_prompt(6, seed=72), max_new_tokens=8, tpot_slo_ms=1e-6)
    eng.drain()
    return eng


def test_predictive_admission_defers_like_the_jax_engine(pair,
                                                         monkeypatch):
    """FLAGS_serving_admission="predictive" arms the gate (no drift,
    model on): a request whose post-admission tick the cost model prices
    over its TPOT deadline waits in the queue, ``admission_deferred``
    logged once, until FLAGS_serving_admission_max_defer_ticks ages it
    out; the same holds, tick for tick, in the JAX engine.  Off, nothing
    waits."""
    from paddle_tpu import flags as jflags
    jm, tm = pair
    eng = _predictive_trace(_engine(tm, num_slots=3, max_length=MAXLEN))
    assert eng.metrics()["requests_finished"] == 3
    assert not eng.admission_armed()
    names = {e[0] for s in obs.get_request_log().timeline_signature()
             for e in s}
    assert "admission_deferred" not in names
    obs.reset()
    old = {k: jflags.flag(k) for k in ("serving_admission",
                                       "serving_admission_max_defer_ticks")}
    new = {"serving_admission": "predictive",
           "serving_admission_max_defer_ticks": 3}
    for k, v in new.items():
        monkeypatch.setitem(flags._values, k, v)
    jflags.set_flags(new)
    try:
        jeng = _predictive_trace(JaxEngine(jm, num_slots=3,
                                           max_length=MAXLEN))
        eng = _engine(tm, num_slots=3, max_length=MAXLEN)
        assert eng.admission_armed()
        probe = eng.admission_probe(6)
        assert probe["occupancy_after"] == 1.0
        assert probe["predicted_ttft_ms"] == probe["predicted_tick_ms"] > 0
        _predictive_trace(eng)
    finally:
        jflags.set_flags(old)
    deferred = eng.metrics()
    sig = obs.get_request_log().timeline_signature()
    assert sig == jobs.get_request_log().timeline_signature()
    assert any(e[0] == "admission_deferred" for e in sig[2])
    row = [r for r in obs.snapshot()["serving.admission_deferred"]["series"]
           if r["labels"] == {"engine": eng._eid}]
    jrow = [r for r in jobs.snapshot()["serving.admission_deferred"][
        "series"] if r["labels"] == {"engine": jeng._eid}]
    assert row[0]["value"] == jrow[0]["value"] == 3
    assert deferred["requests_finished"] == 3
