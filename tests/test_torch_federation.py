"""The port's federated observability (``paddle_tpu_torch/observability/
federation.py``) against the JAX package's, on the CPU.

The fifteen cases of ``tests/test_federation.py`` on the port, with the
JAX package's outputs as the oracle where a case has one:

* the clock-offset estimator, the transport stitch's bounded records and
  the pooled-percentile math: the port's numbers equal the reference's
  on the same samples and buckets;
* ``FederatedRegistry``: worker labels, pooled rows, the schema-version
  refusal and the post-merge cardinality guard; ``merged()`` and the
  Prometheus text equal the reference's for the same snapshots;
* a two-worker loopback plane under injected virtual clocks (the port's
  beside the JAX package's, the same prompts): skews recovered within
  the estimator's bound (the same offsets), the merged Perfetto timeline
  whole and byte-equal to the reference's once uids are renumbered,
  federated counters equal to the registry's, and ``fleet_obs_signature``
  stable across replays and equal to the reference's over the families
  both packages count alike (``tests/torch_obs_compare.py``: the port
  counts builds in ``jit.traces`` and has two step-time histograms of
  its own), the trace's producer, which names the package, aside.

One JAX ``tiny_llama_config`` model (float32, seed 0) is bridged into the
port.  Tolerance: exact, but where a case of the reference compares
floats with ``pytest.approx``.
"""

import json
import warnings
from collections import OrderedDict

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import observability as jobs
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.observability import federation as jfed
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import multihost as jmh

from torch_obs_compare import BY_DESIGN
from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import one_thread  # noqa: F401
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.observability import federation as fed
from paddle_tpu_torch.observability.federation import (
    ClockOffsetEstimator, FederatedRegistry, TransportStitch,
    percentile_from_buckets, scope_snapshot)
from paddle_tpu_torch.observability.metrics import SNAPSHOT_SCHEMA_VERSION
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import multihost as tmh


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Each test on one intra-op thread (``torch_chip_rehearsal``)."""
    yield


def _both(cls_name, *samples):
    """The port's and the reference's estimator over the same samples."""
    out = []
    for mod in (fed, jfed):
        est = getattr(mod, cls_name)()
        for s in samples:
            est.add_sample(*s)
        out.append(est)
    return out


def _est_state(est):
    return (est.samples, est.ready, est.offset_ms, est.min_rtt_ms,
            est.error_bound_ms)


# -- the clock-offset estimator --------------------------------------------

def test_offset_exact_recovery_positive_and_negative_skew():
    for skew in (37.0, -53.0, 0.0):
        t0 = 100.0
        t1 = t0 + 2.0 + skew
        t2 = t1 + 1.0
        t3 = t0 + 2.0 + 1.0 + 2.0
        est, jest = _both("ClockOffsetEstimator", (t0, t1, t2, t3))
        assert est.ready
        assert est.offset_ms == pytest.approx(skew)
        assert est.min_rtt_ms == pytest.approx(4.0)
        assert est.error_bound_ms == pytest.approx(2.0)
        assert est.to_local_ms(t1) == pytest.approx(t0 + 2.0)
        assert _est_state(est) == _est_state(jest)
        assert est.to_local_ms(t1) == jest.to_local_ms(t1)


def test_offset_error_within_bound_under_asymmetric_rtt():
    skew = 11.0
    t0 = 50.0
    t1 = t0 + 8.0 + skew
    t2 = t1 + 1.0
    t3 = t0 + 8.0 + 1.0 + 2.0
    est, jest = _both("ClockOffsetEstimator", (t0, t1, t2, t3))
    err = abs(est.offset_ms - skew)
    assert err == pytest.approx(3.0)
    assert est.min_rtt_ms == pytest.approx(10.0)
    assert err <= est.error_bound_ms
    assert _est_state(est) == _est_state(jest)


def test_offset_keeps_min_rtt_sample_first_wins_ties():
    samples = [(0.0, 15.0, 16.0, 20.0),
               (100.0, 100.5 + 7.0, 101.5 + 7.0, 102.0),
               (200.0, 200.5 + 9.0, 201.5 + 9.0, 202.0)]
    est = ClockOffsetEstimator()
    est.add_sample(*samples[0])
    noisy = est.offset_ms
    est.add_sample(*samples[1])
    assert est.offset_ms == pytest.approx(7.0) and est.offset_ms != noisy
    est.add_sample(*samples[2])
    assert est.offset_ms == pytest.approx(7.0)
    assert est.samples == 3
    _, jest = _both("ClockOffsetEstimator", *samples)
    assert _est_state(est) == _est_state(jest)


def test_transport_stitch_bounds_records_counts_drops(monkeypatch):
    monkeypatch.setattr(TransportStitch, "MAX_RECORDS", 3)
    monkeypatch.setattr(jfed.TransportStitch, "MAX_RECORDS", 3)
    sts = [TransportStitch("w0"), jfed.TransportStitch("w0")]
    for st in sts:
        for i in range(5):
            st.record("step", i, i + 1.0, i + 1.5, i + 2.0)
    st, jst = sts
    assert len(st.records) == 3 and st.dropped == 2
    assert st.estimator.samples == 5
    assert st.records == jst.records and st.dropped == jst.dropped
    assert st.to_plane_ms(10.0) == jst.to_plane_ms(10.0)


# -- pooled percentiles ------------------------------------------------------

def test_percentile_from_buckets_interpolation_and_inf_clamp():
    buckets = {"1": 2, "5": 6, "10": 9, "+Inf": 10}
    assert percentile_from_buckets(buckets, 0.5) == pytest.approx(4.0)
    assert percentile_from_buckets(buckets, 1.0) == pytest.approx(10.0)
    assert percentile_from_buckets({"+Inf": 0}, 0.5) is None
    with pytest.raises(ValueError):
        percentile_from_buckets(buckets, 1.5)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert (percentile_from_buckets(buckets, q)
                == jfed.percentile_from_buckets(buckets, q))


# -- the federated registry --------------------------------------------------

def _snap(worker_families):
    out = {"schema_version": SNAPSHOT_SCHEMA_VERSION}
    out.update(worker_families)
    return out


def _regs(snaps, **kw):
    """The port's and the reference's registry over the same snapshots."""
    regs = [FederatedRegistry(**kw), jfed.FederatedRegistry(**kw)]
    for reg in regs:
        for w, snap in snaps.items():
            reg.add_snapshot(w, json.loads(json.dumps(snap)))
    return regs


def test_federated_merge_worker_labels_and_pooled_counter_sum():
    reg, jreg = _regs({
        "w0": _snap({"serving.requests": {
            "type": "counter", "help": "h",
            "series": [{"labels": {"tenant": "a"}, "value": 3.0},
                       {"labels": {"tenant": "b"}, "value": 1.0}]}}),
        "w1": _snap({"serving.requests": {
            "type": "counter", "help": "h",
            "series": [{"labels": {"tenant": "a"}, "value": 5.0}]}})})
    fam = reg.merged()["serving.requests"]
    got = {tuple(sorted(r["labels"].items())): r["value"]
           for r in fam["series"]}
    assert got == {(("tenant", "a"), ("worker", "w0")): 3.0,
                   (("tenant", "b"), ("worker", "w0")): 1.0,
                   (("tenant", "a"), ("worker", "w1")): 5.0}
    assert fam["pooled"]["value"] == 9.0
    assert reg.family_total("serving.requests") == 9.0
    assert reg.merged() == jreg.merged()
    assert reg.prometheus_text() == jreg.prometheus_text()


def test_federated_pooled_histogram_recomputes_from_summed_buckets():
    rows = {
        "w0": {"labels": {}, "count": 4, "sum": 10.0,
               "buckets": {"1": 2, "5": 4, "+Inf": 4}},
        "w1": {"labels": {}, "count": 6, "sum": 40.0,
               "buckets": {"1": 0, "5": 2, "+Inf": 6}},
    }
    reg, jreg = _regs({w: _snap({"lat": {"type": "histogram", "help": "h",
                                         "series": [row]}})
                       for w, row in rows.items()})
    fam = reg.merged()["lat"]
    assert fam["pooled"]["count"] == 10
    assert fam["pooled"]["sum"] == pytest.approx(50.0)
    assert fam["pooled"]["buckets"] == {"1": 2, "5": 6, "+Inf": 10}
    assert reg.pooled_percentile("lat", 0.5) == pytest.approx(
        percentile_from_buckets({"1": 2, "5": 6, "+Inf": 10}, 0.5))
    assert reg.merged() == jreg.merged()
    assert reg.prometheus_text() == jreg.prometheus_text()


def test_federated_ratio_sums_before_dividing():
    snaps = {}
    for w, (hits, lookups) in (("w0", (9.0, 10.0)), ("w1", (0.0, 1.0))):
        snaps[w] = _snap({
            "hits": {"type": "counter", "help": "",
                     "series": [{"labels": {}, "value": hits}]},
            "lookups": {"type": "counter", "help": "",
                        "series": [{"labels": {}, "value": lookups}]}})
    reg, jreg = _regs(snaps)
    assert reg.pooled_ratio("hits", "lookups") == pytest.approx(9 / 11)
    assert (reg.pooled_ratio("hits", "lookups")
            == jreg.pooled_ratio("hits", "lookups"))


def test_federated_schema_version_mismatch_refused():
    reg = FederatedRegistry()
    with pytest.raises(ValueError, match="schema_version"):
        reg.add_snapshot("w0", {"schema_version": -1})
    assert SNAPSHOT_SCHEMA_VERSION == jobs.SNAPSHOT_SCHEMA_VERSION


def test_post_merge_cardinality_guard_coalesces_loudly():
    snaps = {w: _snap({"reqs": {
        "type": "counter", "help": "h",
        "series": [{"labels": {"tenant": str(t)}, "value": 1.0}
                   for t in range(2)]}}) for w in ("w0", "w1", "w2")}
    reg, jreg = _regs(snaps, max_children=4)
    with pytest.warns(RuntimeWarning, match="post-merge cardinality"):
        merged = reg.merged()
    fam = merged["reqs"]
    assert fam["coalesced"] == 2
    assert len(fam["series"]) == 5
    spill = [r for r in fam["series"]
             if r["labels"].get("overflow") == "true"]
    assert len(spill) == 1 and spill[0]["value"] == 2.0
    assert fam["pooled"]["value"] == 6.0
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        reg.merged()
    with pytest.warns(RuntimeWarning):
        assert jreg.merged() == merged


def test_scope_snapshot_filters_by_engine_label():
    snap = {"schema_version": SNAPSHOT_SCHEMA_VERSION,
            "c": {"type": "counter", "help": "",
                  "series": [{"labels": {"engine": "1"}, "value": 2.0},
                             {"labels": {"engine": "2"}, "value": 5.0}]},
            "global": {"type": "counter", "help": "",
                       "series": [{"labels": {}, "value": 1.0}]}}
    scoped = scope_snapshot(snap, "1")
    assert [r["value"] for r in scoped["c"]["series"]] == [2.0]
    assert "global" not in scoped
    assert scoped == jfed.scope_snapshot(snap, "1")


# -- a two-worker loopback plane under injected clocks ----------------------

_SKEWS = {"w0": 37.0, "w1": -53.0}


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


def _fleet_run(model):
    """The reference's ``_fleet_run``: one seeded trace through a
    two-worker loopback plane of ``model``'s package with every clock
    virtual (a counter advancing 0.1 ms a read; each worker's clock at
    its injected skew)."""
    port = isinstance(model, LlamaForCausalLM)
    obs, mh = (tobs, tmh) if port else (jobs, jmh)
    log = obs.get_request_log()
    saved_clock, saved_t0 = log._clock, log._t0
    cell = {"t": 0.0}

    def vclock():
        cell["t"] += 1e-4
        return cell["t"]

    log._clock, log._t0 = vclock, 0.0
    try:
        rng = np.random.default_rng(13)
        prompts = [rng.integers(3, 90, size=n).tolist() for n in (7, 12, 9)]
        workers = OrderedDict()
        for i in range(2):
            nm = f"w{i}"
            kw = dict(num_slots=4, max_length=128, prefill_batch=2,
                      paged=True, block_len=8)
            eng = (ServingEngine(model, device="cpu", **kw) if port
                   else JaxEngine(model, **kw))
            eng._clock = vclock
            w = mh.EngineWorker(eng, name=nm)
            workers[nm] = mh.LoopbackTransport(
                w.handle, name=nm,
                server_clock=(lambda s=_SKEWS[nm]: log.now_ms() + s))
        plane = mh.MultiHostRouter(workers, policy="prefix")
        mark = log.mark()
        rids = [plane.submit(p, max_new_tokens=6) for p in prompts]
        out = dict(plane.drain())
        end = log.mark()
        eids = {str(t.call("metrics_snapshot", {})["engine"])
                for t in plane._workers.values()}
        trace = plane.export_merged_perfetto(since_uid=mark, until_uid=end)
        merged = plane.federation().merged()
        fleet = plane.fleet_report()
        common = {k: v for k, v in merged.items() if k not in BY_DESIGN}
        return {"plane": plane,
                "tokens": [out[r] for r in rids],
                "trace": trace,
                "sig": plane.fleet_obs_signature(since_uid=mark,
                                                 until_uid=end),
                # over the families both packages count alike, the
                # trace's producer (which names its package) left out
                "sig_common": jfed.fleet_obs_signature(
                    dict(trace, otherData=dict(trace["otherData"],
                                               producer="")),
                    common, fleet),
                "merged": merged, "snap": obs.snapshot(), "eids": eids,
                "offsets": {n: _est_state(t.stitch.estimator)
                            for n, t in plane._workers.items()}}
    finally:
        log._clock, log._t0 = saved_clock, saved_t0


@pytest.fixture(scope="module")
def fleet_runs(pair):
    jm, tm = pair
    tobs.reset()
    jobs.reset()
    return ((_fleet_run(tm), _fleet_run(tm)),
            (_fleet_run(jm), _fleet_run(jm)))


def test_injected_skews_recovered_within_bound(fleet_runs):
    (run, _), (jrun, _) = fleet_runs
    for nm, t in run["plane"]._workers.items():
        est = t.stitch.estimator
        assert est.ready
        assert abs(est.offset_ms - _SKEWS[nm]) <= est.error_bound_ms
    assert run["offsets"] == jrun["offsets"]


def test_merged_perfetto_structure(fleet_runs):
    (run, _), (jrun, _) = fleet_runs
    evs = run["trace"]["traceEvents"]
    procs = {e["args"]["name"] for e in evs
             if e.get("name") == "process_name"}
    assert {"paddle_tpu plane", "paddle_tpu requests",
            "paddle_tpu worker w0", "paddle_tpu worker w1"} <= procs
    calls = [e for e in evs
             if str(e.get("name", "")).startswith("rpc.call:")]
    assert calls
    for c in calls:
        assert c["args"]["wire_ms"] + c["args"]["in_worker_ms"] == \
            pytest.approx(c["dur"] / 1e3)
    assert any(e.get("name") == "in_worker" for e in evs)
    assert any(str(e.get("name", "")).startswith("worker.handle:")
               for e in evs)
    assert any(str(e.get("name", "")).startswith("on w")
               and e.get("ph") == "X" for e in evs)
    # the reference's timeline, event for event, once uids are renumbered
    got = json.dumps(fed._canonical_trace(run["trace"])["traceEvents"],
                     sort_keys=True)
    want = json.dumps(jfed._canonical_trace(jrun["trace"])["traceEvents"],
                      sort_keys=True)
    assert got == want


def test_federated_counters_equal_process_registry(fleet_runs):
    (_, run), _ = fleet_runs
    merged, snap, eids = run["merged"], run["snap"], run["eids"]
    checked = 0
    for name, fam in merged.items():
        if name in ("schema_version", "workers") \
                or fam["type"] != "counter":
            continue
        direct = sum(
            float(r["value"]) for r in snap[name]["series"]
            if str(r["labels"].get("engine", "")) in eids)
        assert fam["pooled"]["value"] == pytest.approx(direct), name
        checked += 1
    assert checked > 0


def test_fleet_obs_signature_byte_stable_across_replays(fleet_runs):
    (a, b), (ja, jb) = fleet_runs
    assert a["tokens"] == b["tokens"] == ja["tokens"]
    assert a["sig"] == b["sig"]
    ca = json.dumps(fed._canonical_trace(a["trace"]), sort_keys=True)
    cb = json.dumps(fed._canonical_trace(b["trace"]), sort_keys=True)
    assert ca == cb
    # equal to the reference's over the families both count alike
    assert a["sig_common"] == b["sig_common"] == ja["sig_common"]
    assert a["trace"]["otherData"]["producer"] == (
        "paddle_tpu_torch.observability.federation")
