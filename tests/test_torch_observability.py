"""The port's metrics registry, span tracer and build watchdog
(``paddle_tpu_torch/observability``) against the JAX package's, on the CPU:
the reference's ``tests/test_observability.py`` case by case.

Where the JAX package has the function, both packages get the same
operations: registry ``snapshot()`` (as JSON text) and ``prometheus_text()``
must be byte-equal, and the engines' registry series equal after the same
schedule (``tests/torch_obs_compare.py``: engine / pool ids matched in
order; families that differ by design named there).  The engines are one
JAX ``tiny_llama_config`` model (float32) and its port.

Left out: the reference's profiler cases (``test_record_event_emits_host_
span`` and the three profiler segment-export tests), which wait for
``profiler/`` (ROADMAP A10).
"""

import json
import threading
import warnings

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import flags as jflags
from paddle_tpu import observability as jobs
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.kv_cache import BlockManager as JaxBlockManager

from torch_obs_compare import assert_same_series
from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.kv_cache import BlockManager

MAXLEN = 64


def _both(ops):
    """``ops(registry)`` on a fresh registry of each package: the JSON of
    their snapshots and their Prometheus texts byte-equal.  Returns the
    port's registry."""
    j, t = JaxRegistry(), MetricsRegistry()
    ops(j)
    ops(t)
    assert json.dumps(t.snapshot()) == json.dumps(j.snapshot())
    assert t.prometheus_text() == j.prometheus_text()
    return t


# -- registry ----------------------------------------------------------------

def test_counter_inc_labels_and_idempotent_family():
    def ops(reg):
        c = reg.counter("t.hits", "help text")
        c.inc()
        c.inc(2)
        c.labels(op="a").inc(5)
    reg = _both(ops)
    c = reg.counter("t.hits")
    assert c.value() == 3
    assert c.value(op="a") == 5
    assert reg.counter("t.hits") is c
    assert c.labels(op="a") is c.labels(op="a")
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1)


def test_gauge_set_inc_dec():
    def ops(reg):
        g = reg.gauge("t.g")
        g.set(2.5)
        g.inc()
        g.dec(0.5)
    assert _both(ops).gauge("t.g").value() == 3.0


def test_kind_conflict_raises():
    reg = MetricsRegistry()
    reg.counter("t.x")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("t.x")
    reg.histogram("t.h", buckets=(1, 2))
    with pytest.raises(ValueError, match="different buckets"):
        reg.histogram("t.h", buckets=(1, 2, 3))
    with pytest.raises(ValueError, match="bad metric name"):
        reg.counter("bad name!")


def test_histogram_buckets_counts_and_percentiles():
    def ops(reg):
        h = reg.histogram("t.lat", buckets=(1.0, 2.0, 4.0, 8.0)).labels()
        for v in (0.5, 1.5, 3.0, 3.0, 7.0):
            h.observe(v)
    reg = _both(ops)
    h = reg.histogram("t.lat", buckets=(1.0, 2.0, 4.0, 8.0)).labels()
    assert h.count == 5
    assert h.sum == pytest.approx(15.0)
    assert h.bucket_counts() == {"1": 1, "2": 2, "4": 4, "8": 5,
                                 "+Inf": 5}
    # rank 2.5 in the (2, 4] bucket of observations 3 and 4
    assert h.percentile(0.5) == pytest.approx(2.5)
    assert h.percentile(1.0) == pytest.approx(8.0)
    h.observe(1000.0)                    # past the last bound: clamps
    assert h.percentile(1.0) == pytest.approx(8.0)
    with pytest.raises(ValueError):
        h.percentile(1.5)


def test_empty_histogram_percentile_is_none():
    assert MetricsRegistry().histogram("t.e").labels().percentile(0.5) \
        is None


def test_histogram_thread_safety_smoke():
    reg = MetricsRegistry()
    h = reg.histogram("t.mt", buckets=(10.0, 20.0)).labels()
    c = reg.counter("t.mtc").labels()
    n, per = 8, 2000

    def work():
        for i in range(per):
            h.observe(float(i % 30))
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert h.count == n * per
    assert c.value() == n * per
    assert h.bucket_counts()["+Inf"] == n * per


def test_snapshot_is_json_and_structured():
    def ops(reg):
        reg.counter("t.c", "c help").labels(op="x").inc(3)
        reg.gauge("t.g").set(1.5)
        reg.histogram("t.h", buckets=(1.0,)).observe(0.5)
    snap = _both(ops).snapshot()
    assert snap["t.c"]["type"] == "counter"
    assert snap["t.c"]["series"][0] == {"labels": {"op": "x"}, "value": 3}
    assert snap["t.g"]["series"][0]["value"] == 1.5
    hrow = snap["t.h"]["series"][0]
    assert hrow["count"] == 1 and "p50" in hrow and "buckets" in hrow


def test_prometheus_text_exposition():
    def ops(reg):
        reg.counter("serving.requests", "total requests").labels(
            engine="0").inc(7)
        reg.gauge("kv_cache.pool_occupancy").set(0.25)
        reg.histogram("serving.ttft_ms", buckets=(5.0, 10.0)).observe(7.0)
    lines = _both(ops).prometheus_text().splitlines()
    assert "# HELP paddle_tpu_serving_requests_total total requests" in lines
    assert "# TYPE paddle_tpu_serving_requests_total counter" in lines
    assert 'paddle_tpu_serving_requests_total{engine="0"} 7' in lines
    assert "paddle_tpu_kv_cache_pool_occupancy 0.25" in lines
    assert "# TYPE paddle_tpu_serving_ttft_ms histogram" in lines
    assert 'paddle_tpu_serving_ttft_ms_bucket{le="5"} 0' in lines
    assert 'paddle_tpu_serving_ttft_ms_bucket{le="10"} 1' in lines
    assert 'paddle_tpu_serving_ttft_ms_bucket{le="+Inf"} 1' in lines
    assert "paddle_tpu_serving_ttft_ms_sum 7" in lines
    assert "paddle_tpu_serving_ttft_ms_count 1" in lines


def test_prometheus_text_escapes_nasty_values():
    """Backslash, double quote and newline in label values (and HELP
    text) are escaped, and the escaped value round-trips."""
    nasty = 'a\\b"c\nd'

    def ops(reg):
        reg.counter("t.nasty", "help with\nnewline and \\ backslash"
                    ).labels(tenant=nasty).inc()
    lines = _both(ops).prometheus_text().splitlines()
    sample = [ln for ln in lines if ln.startswith("paddle_tpu_t_nasty")]
    assert sample == \
        ['paddle_tpu_t_nasty_total{tenant="a\\\\b\\"c\\nd"} 1']
    assert ("# HELP paddle_tpu_t_nasty_total help with\\nnewline "
            "and \\\\ backslash") in lines
    raw = sample[0].split('tenant="', 1)[1].rsplit('"}', 1)[0]
    out, i = [], 0
    while i < len(raw):
        if raw[i] == "\\":
            out.append({"\\": "\\", "n": "\n", '"': '"'}[raw[i + 1]])
            i += 2
        else:
            out.append(raw[i])
            i += 1
    assert "".join(out) == nasty


def test_snapshot_schema_version_and_byte_stable():
    def ops(reg):
        reg.counter("t.zz").labels(b="2", a="1").inc()
        reg.counter("t.aa").labels(x="9").inc(2)
        reg.histogram("t.mm", buckets=(1.0, 2.0)).observe(1.5)
    reg = _both(ops)
    snap = reg.snapshot()
    assert snap["schema_version"] == obs.SNAPSHOT_SCHEMA_VERSION \
        == jobs.SNAPSHOT_SCHEMA_VERSION
    assert list(snap)[0] == "schema_version"
    assert list(snap)[1:] == ["t.aa", "t.mm", "t.zz"]
    assert json.dumps(reg.snapshot()) == json.dumps(reg.snapshot())


def test_trace_dropped_events_gauge_in_snapshot():
    """Ring drops surface as the obs.trace_dropped_events gauge, and a
    reset re-registers it at 0; the default snapshot after the same
    operations equals the JAX package's."""
    for pkg in (jobs, obs):
        pkg.reset()
        tr = pkg.get_tracer()
        old = tr.max_events
        tr.max_events = 2
        try:
            for i in range(5):
                tr.instant(f"drop{i}")
            series = pkg.snapshot()["obs.trace_dropped_events"]["series"]
            assert series[0]["value"] == tr.dropped == 3
        finally:
            tr.max_events = old
    assert json.dumps(obs.snapshot()) == json.dumps(jobs.snapshot())
    obs.reset()
    assert obs.snapshot()["obs.trace_dropped_events"]["series"][0][
        "value"] == 0


# -- tracer ------------------------------------------------------------------

def test_spans_nest_and_export_chrome_trace(tmp_path):
    tr = obs.SpanTracer(max_events=100, enabled=True)
    with tr.span("outer", tick=3):
        with tr.span("inner"):
            pass
    tr.instant("marker", rid=1)
    tr.counter("track", a=1)
    path = tmp_path / "trace.json"
    tr.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    evs = trace["traceEvents"]
    by_name = {e["name"]: e for e in evs}
    assert by_name["process_name"]["ph"] == "M"
    outer, inner = by_name["outer"], by_name["inner"]
    for e in (outer, inner):
        assert e["ph"] == "X"
        for field in ("ts", "dur", "pid", "tid"):
            assert field in e
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert inner["tid"] == outer["tid"]
    assert outer["args"] == {"tick": 3}
    assert by_name["marker"]["ph"] == "i"
    assert by_name["track"]["ph"] == "C"
    # the same events as the JAX tracer records, timestamps aside
    jt = jobs.SpanTracer(max_events=100, enabled=True)
    with jt.span("outer", tick=3):
        with jt.span("inner"):
            pass
    jt.instant("marker", rid=1)
    jt.counter("track", a=1)

    def shape(t):
        return [{k: v for k, v in e.items()
                 if k not in ("ts", "dur", "pid", "tid")}
                for e in t.events()]
    assert shape(tr) == shape(jt)


def test_tracer_ring_buffer_drops():
    tr = obs.SpanTracer(max_events=3, enabled=True)
    for i in range(5):
        tr.instant(f"e{i}")
    assert [e["name"] for e in tr.events()] == ["e2", "e3", "e4"]
    assert tr.dropped == 2
    assert tr.export_chrome_trace()["otherData"]["dropped_events"] == 2


def test_tracer_disabled_is_noop():
    tr = obs.SpanTracer(max_events=10, enabled=False)
    with tr.span("x"):
        pass
    tr.instant("y")
    tr.counter("z", v=1)
    assert tr.events() == []


def test_tracer_defaults_follow_the_flags(monkeypatch):
    monkeypatch.setitem(flags._values, "observability_spans", False)
    monkeypatch.setitem(flags._values, "trace_buffer_events", 7)
    tr = obs.SpanTracer()
    assert not tr.enabled and tr.max_events == 7


# -- build watchdog ----------------------------------------------------------

def test_track_retraces_counts_and_raises_past_budget(monkeypatch):
    """The port counts builds (each call of the wrapped build is one),
    with the reference's budget, message and registry counter."""
    monkeypatch.setitem(flags._values, "retrace_watchdog", "raise")
    built = []
    f = obs.track_retraces(lambda n: built.append(n), "t.port_poly",
                           budget=1)
    f(2)
    assert f.traces == 1 and built == [2]
    with pytest.raises(obs.RetraceError, match="trace #2 exceeds"):
        f(3)
    assert built == [2]                  # the offending build did not run
    assert f.traces == 2
    assert obs.default_registry().counter("jit.traces").value(
        site="t.port_poly") == 2
    assert f.counter.value() == 2


def test_track_retraces_warn_and_off_modes(monkeypatch):
    monkeypatch.setitem(flags._values, "retrace_watchdog", "warn")
    f = obs.track_retraces(lambda x: x * 2, "t.port_poly_warn", budget=1)
    f(1)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        assert f(3) == 6                 # past budget: warned, still runs
    assert any(issubclass(w.category, obs.RetraceWarning) for w in got)
    monkeypatch.setitem(flags._values, "retrace_watchdog", "off")
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        f(4)
    assert not any(issubclass(w.category, obs.RetraceWarning)
                   for w in got)
    assert f.traces == 3


def test_budget_reads_the_site_not_a_coalesced_child(monkeypatch):
    """Past FLAGS_metrics_max_children label sets, a new site's registry
    child is the family's shared {overflow="true"} one; its budget still
    counts its own builds."""
    monkeypatch.setitem(flags._values, "metrics_max_children", 2)
    monkeypatch.setitem(flags._values, "retrace_watchdog", "raise")
    reg = MetricsRegistry()
    with pytest.warns(RuntimeWarning, match="label-cardinality cap"):
        sites = [obs.track_retraces(lambda: None, "t.cap", budget=1,
                                    labels={"engine": f"c{i}"},
                                    registry=reg) for i in range(4)]
    for s in sites:
        s()
    assert [s.traces for s in sites] == [1, 1, 1, 1]
    assert reg.counter("jit.traces").value(overflow="true") == 2


# -- kernel routes -----------------------------------------------------------

def test_kernel_routes_count_into_the_registry():
    """Each routing decision counts in the local tally and as
    ops.kernel_path{op, path}; a recorded capture counts once per
    credited replay in both."""
    import torch

    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _dispatch

    _dispatch.reset_kernel_paths()
    x = torch.ones(2, 8)
    ops.rms_norm(x, torch.ones(8))
    fam = obs.default_registry().counter("ops.kernel_path")
    assert fam.value(op="rms_norm", path="plain") == 1
    with ops.ReplayCounts.record() as rc:
        ops.rms_norm(x, torch.ones(8))   # a capture: no count yet
    assert fam.value(op="rms_norm", path="plain") == 1
    assert dict(_dispatch.kernel_paths) == {("rms_norm", "plain"): 1}
    rc.add(3)
    assert fam.value(op="rms_norm", path="plain") == 4
    assert dict(_dispatch.kernel_paths) == {("rms_norm", "plain"): 4}
    _dispatch.reset_kernel_paths()       # the tally only
    assert fam.value(op="rms_norm", path="plain") == 4


# -- serving integration -----------------------------------------------------

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
    if isinstance(model, LlamaForCausalLM):
        return ServingEngine(model, device="cpu", **kw)
    return JaxEngine(model, **kw)


def _staggered(eng):
    rids = [eng.submit(_prompt(5, 1), max_new_tokens=4),
            eng.submit(_prompt(9, 2), max_new_tokens=4)]
    eng.step()
    eng.step()
    rids.append(eng.submit(_prompt(7, 3), max_new_tokens=4))
    rids.append(eng.submit(_prompt(6, 4), max_new_tokens=4))
    results = dict(eng.drain())
    return [results[r] for r in rids]


def test_engine_metrics_on_staggered_trace(pair, tmp_path):
    """One staggered trace through the contiguous engine: every series
    lands in the registry, equal to the JAX engine's; ``metrics()`` reads
    them back; the tracer's Chrome export is a valid nested trace."""
    jm, tm = pair
    jeng = _engine(jm, num_slots=2, max_length=MAXLEN)
    want = _staggered(jeng)
    eng = _engine(tm, num_slots=2, max_length=MAXLEN)
    got = _staggered(eng)
    assert got == want
    assert_same_series(jobs.snapshot(), obs.snapshot(), ([jeng._eid],),
                       ([eng._eid],))

    m = eng.metrics()
    n_tok = sum(len(o) for o in got)
    assert m["requests_submitted"] == 4
    assert m["requests_finished"] == 4
    assert m["tokens_generated"] == n_tok
    assert m["ttft_ms"]["count"] == 4 and m["ttft_ms"]["p50"] > 0
    assert m["queue_wait_ms"]["count"] == 4
    assert m["tpot_ms"]["count"] == 4
    assert m["decode_step_ms"]["count"] >= 3
    assert m["step_traces"] == 1
    assert m["prefill_waves"] >= 2

    snap = obs.snapshot()
    row = snap["serving.ttft_ms"]["series"][0]
    assert row["count"] == 4 and row["labels"] == {"engine": eng._eid}
    assert snap["serving.active_slots"]["type"] == "gauge"
    assert "jit.traces" in snap
    paths = {(r["labels"]["op"], r["labels"]["path"])
             for r in snap["ops.kernel_path"]["series"]}
    assert ("decode_attention", "plain") in paths
    assert sum(r["value"]
               for r in snap["serving.prefill_bucket"]["series"]) >= 2
    reasons = {r["labels"]["reason"]: r["value"]
               for r in snap["serving.retired"]["series"]}
    assert sum(reasons.values()) == 4

    path = tmp_path / "serving_trace.json"
    obs.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    evs = trace["traceEvents"]
    steps = [e for e in evs if e.get("name") == "serving.step"]
    decodes = [e for e in evs if e.get("name") == "serving.decode"]
    prefills = [e for e in evs if e.get("name") == "serving.prefill"]
    assert steps and decodes and prefills
    assert len(decodes) == m["decode_ticks"]
    assert len(prefills) == m["prefill_waves"]
    for d in decodes:
        assert any(s["ts"] <= d["ts"]
                   and d["ts"] + d["dur"] <= s["ts"] + s["dur"] + 1e-6
                   for s in steps)


def _shared_prefix(eng):
    sys_p = _prompt(16, 9)
    eng.submit(np.concatenate([sys_p, _prompt(4, 10)]), max_new_tokens=4)
    eng.drain()
    eng.submit(np.concatenate([sys_p, _prompt(5, 11)]), max_new_tokens=4)
    eng.drain()


def test_paged_engine_metrics_and_zero_retraces(pair):
    """Paged engine with a shared system prompt: the step built once, the
    pool's series carrying the prefix-hit / occupancy story, all equal to
    the JAX engine's."""
    jm, tm = pair
    jeng = _engine(jm, num_slots=2, max_length=MAXLEN, paged=True,
                   block_len=8)
    _shared_prefix(jeng)
    eng = _engine(tm, num_slots=2, max_length=MAXLEN, paged=True,
                  block_len=8)
    _shared_prefix(eng)
    assert_same_series(jobs.snapshot(), obs.snapshot(),
                       ([jeng._eid], [jeng.kv._pid]),
                       ([eng._eid], [eng.kv._pid]))
    assert eng.step_traces == 1
    m = eng.metrics()
    kv = m["kv_cache"]
    assert kv["prefix_hit_tokens"] == 16
    assert 0 < kv["prefix_hit_rate"] < 1
    assert kv["peak_blocks_in_use"] > 0
    assert m["requests_finished"] == 2
    assert eng.prefill_tokens_computed < eng.prefill_tokens_total
    snap = obs.snapshot()
    assert snap["kv_cache.prefix_hit_tokens"]["series"][0]["value"] == 16
    assert "kv_cache.pool_occupancy" in snap


def test_block_manager_stats_are_registry_backed():
    for pkg, cls in ((jobs, JaxBlockManager), (obs, BlockManager)):
        pkg.reset()
        m = cls(8, 4, prefix_cache=True)
        assert m.admit(0, list(range(8)), 8, 4) == 0
        assert dict(m.stats)["prefix_lookups"] == 1
        assert m.stats["peak_blocks_in_use"] == 3
        snap = pkg.snapshot()
        assert snap["kv_cache.prefix_lookups"]["series"][0]["value"] == 1
        assert snap["kv_cache.blocks_in_use"]["series"][0]["value"] == 3
        assert snap["kv_cache.free_blocks"]["series"][0]["value"] == 4
        m.release(0)
        assert pkg.snapshot()["kv_cache.blocks_in_use"]["series"][0][
            "value"] == 0
    jm_, tm_ = jobs.snapshot(), obs.snapshot()
    assert_same_series(jm_, tm_, ((), [m_pid(jm_)]), ((), [m_pid(tm_)]))


def m_pid(snap):
    """The one pool id in ``snap``."""
    (row,) = snap["kv_cache.prefix_lookups"]["series"]
    return row["labels"]["pool"]


def test_cardinality_guard_coalesces_into_overflow_child(monkeypatch):
    """(The reference's ``tests/test_perf_model.py`` case.)  Past
    FLAGS_metrics_max_children label sets a family warns once and
    coalesces new label sets into {overflow="true"}; the two packages'
    expositions stay byte-equal."""
    monkeypatch.setitem(flags._values, "metrics_max_children", 4)
    old = jflags.flag("metrics_max_children")
    jflags.set_flags({"metrics_max_children": 4})
    try:
        def ops(reg):
            fam = reg.counter("t.card", "cardinality guard under test")
            for i in range(4):
                fam.labels(uid=str(i)).inc()
            with pytest.warns(RuntimeWarning,
                              match="label-cardinality cap"):
                fam.labels(uid="intruder-a").inc()
            with warnings.catch_warnings():
                warnings.simplefilter("error")   # once per family
                fam.labels(uid="intruder-b").inc(2)
                fam.labels(uid="2").inc()
        reg = _both(ops)
    finally:
        jflags.set_flags({"metrics_max_children": old})
    fam = reg.counter("t.card")
    assert fam.coalesced == 2
    assert fam.value(overflow="true") == 3.0
    assert fam.value(uid="2") == 2.0
    assert 'overflow="true"' in reg.prometheus_text()


def test_reset_isolates_engines_under_the_cap(monkeypatch, pair):
    """More engines than FLAGS_metrics_max_children in one process: with
    observability.reset() between them (as every test here and each
    serving run of chip_smoke.py do) each engine's metrics() are its own;
    without it, the engines past the cap read a pooled overflow child."""
    _, tm = pair
    monkeypatch.setitem(flags._values, "metrics_max_children", 2)

    def served(reset):
        out = []
        for _ in range(4):
            if reset:
                obs.reset()
            eng = _engine(tm, num_slots=1, max_length=MAXLEN)
            eng.submit(_prompt(5, 1), max_new_tokens=2)
            eng.drain()
            out.append(eng.metrics()["requests_submitted"])
        return out

    assert served(True) == [1, 1, 1, 1]
    obs.reset()
    with pytest.warns(RuntimeWarning, match="label-cardinality cap"):
        pooled = served(False)
    assert pooled[:2] == [1, 1] and pooled[2:] == [1, 2]
