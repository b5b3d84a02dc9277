"""The port's per-request lifecycle log
(``paddle_tpu_torch/observability/request_log.py``) and the engine's
lifecycle and SLO accounting, against the JAX package's, on the CPU: the
reference's ``tests/test_request_lifecycle.py`` case by case.

The store gets the same operations in both packages, with every event's
``t_ms`` fixed: records, ``timeline_signature``, ``slo_report`` and the
Perfetto export (process ids aside) must be equal.  The engines are one
JAX ``tiny_llama_config`` model (float32) and its port, on one schedule in
the wave, paged, chunked, speculative and swap-preempting engines: every
request's timeline (``timeline_signature``), the registry's series
(``tests/torch_obs_compare.py``) and the cost model's ``perf_signature``
on the ``cpu_smoke`` profile must be equal.

The router's case, ``test_router_failover_carries_one_uid_across_replicas``,
is in ``tests/test_torch_serving_router.py``.
"""

import json

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import observability as jobs
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.observability import RequestLog as JaxRequestLog
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_compare import assert_same_series
from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.observability import RequestLog, perf_signature
from paddle_tpu_torch.serving import ServingEngine

MAXLEN = 128


def _both(ops, **kw):
    """``ops(log)`` on a fresh log of each package; returns (jax, port)."""
    j, t = JaxRequestLog(**kw), RequestLog(**kw)
    ops(j)
    ops(t)
    return j, t


def _no_pid(trace):
    return [{k: v for k, v in e.items() if k != "pid"}
            for e in trace["traceEvents"] if e["name"] != "process_name"]


# -- RequestLog store --------------------------------------------------------

def test_event_timeline_order_and_mark_bracketing():
    def ops(log):
        u1 = log.new_uid()
        log.event(u1, "submitted", t_ms=0.5, prompt_len=4)
        log.event(u1, "admitted", t_ms=1.0, slot=0)
        log.marks = [log.mark()]
        u2 = log.new_uid()
        log.event(u2, "submitted", t_ms=2.0, prompt_len=8)
        log.marks.append(log.mark())
        u3 = log.new_uid()
        log.event(u3, "submitted", t_ms=3.0, prompt_len=2)
    j, log = _both(ops, max_requests=16)
    u1, u2 = 1, 2
    assert log.event_names(u1) == ["submitted", "admitted"]
    mark, end = log.marks
    assert list(log.records(since_uid=mark, until_uid=end)) == [u2]
    assert len(log.records()) == 3
    tl = log.timeline(u1)
    assert tl[0]["attrs"] == {"prompt_len": 4}
    assert tl[0]["t_ms"] <= tl[1]["t_ms"]
    assert log.records() == j.records()
    # the clock stamps an event given no t_ms
    u = log.new_uid()
    log.event(u, "submitted")
    assert 0.0 <= log.timeline(u)[0]["t_ms"] <= log.now_ms()


def test_signature_strips_ids_and_timings():
    def run(cls, engine_id, qw):
        log = cls(max_requests=8)
        u = log.new_uid()
        log.event(u, "submitted", engine=engine_id, prompt_len=4)
        log.event(u, "admitted", engine=engine_id, slot=1,
                  queue_wait_ms=qw)
        log.event(u, "retired", engine=engine_id, reason="eos", tokens=3,
                  violation="none")
        return log.timeline_signature()

    assert run(RequestLog, "0", 1.25) == run(RequestLog, "7", 99.0) \
        == run(JaxRequestLog, "3", 5.0)
    other = RequestLog(max_requests=8)
    u = other.new_uid()
    other.event(u, "submitted", engine="0", prompt_len=4)
    other.event(u, "admitted", engine="0", slot=1, queue_wait_ms=1.25)
    other.event(u, "retired", engine="0", reason="eos", tokens=4,
                violation="none")
    assert other.timeline_signature() != run(RequestLog, "0", 1.25)


def test_events_mirror_into_span_tracer():
    log = obs.get_request_log()
    u = log.new_uid()
    log.event(u, "submitted", prompt_len=4)
    evs = [e for e in obs.get_tracer().events()
           if e["name"] == "request.submitted"]
    assert evs and evs[-1]["args"]["uid"] == u
    assert evs[-1]["cat"] == "request"


def test_bounded_store_drops_oldest_whole_requests():
    def ops(log):
        for _ in range(5):
            u = log.new_uid()
            log.event(u, "submitted", t_ms=1.0)
            log.event(u, "retired", t_ms=2.0)
    j, log = _both(ops, max_requests=3)
    assert log.dropped == j.dropped == 2
    assert list(log.records()) == [3, 4, 5]
    assert log.event_names(1) == []


def test_request_log_capacity_follows_the_flag(monkeypatch):
    monkeypatch.setitem(flags._values, "request_log_max_requests", 2)
    assert RequestLog().max_requests == 2


def test_perfetto_export_one_named_track_per_request(tmp_path):
    def ops(log):
        for _ in range(2):
            u = log.new_uid()
            log.event(u, "submitted", t_ms=0.0, prompt_len=4)
            log.event(u, "admitted", t_ms=1.0, slot=0)
            log.event(u, "first_token", t_ms=2.0, ttft_ms=1.0)
            log.event(u, "retired", t_ms=3.0, reason="eos", tokens=3)
    j, log = _both(ops, max_requests=8)
    path = tmp_path / "requests.json"
    trace = log.export_perfetto(str(path))
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    assert _no_pid(trace) == _no_pid(j.export_perfetto())
    evs = trace["traceEvents"]
    tracks = {e["tid"]: e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "thread_name"}
    uids = sorted(log.records())
    assert tracks == {u: f"request {u}" for u in uids}
    for u in uids:
        mine = [e for e in evs if e["ph"] != "M" and e["tid"] == u]
        names = [e["name"] for e in mine]
        assert names[:4] == ["submitted", "admitted", "first_token",
                             "retired"]
        slices = {e["name"]: e for e in mine if e["ph"] == "X"}
        assert set(slices) == {"queued", "prefill", "decode"}
        assert slices["queued"]["ts"] + slices["queued"]["dur"] <= \
            slices["prefill"]["ts"] + 1e-6


# -- SLO goodput join --------------------------------------------------------

def _timeline(log, *, qw=1.0, ttft=2.0, tpot=1.0, tokens=5,
              slo=(0.0, 0.0), reject=False, retire=True, cancel=False):
    u = log.new_uid()
    log.event(u, "submitted", t_ms=0.0, prompt_len=4,
              max_new_tokens=tokens, ttft_slo_ms=slo[0],
              tpot_slo_ms=slo[1])
    if reject:
        log.event(u, "rejected", t_ms=0.0, reason="too_long")
        return u
    log.event(u, "admitted", t_ms=qw, slot=0, queue_wait_ms=qw)
    log.event(u, "first_token", t_ms=ttft, ttft_ms=ttft)
    if cancel:
        log.event(u, "retired", t_ms=ttft + 1.0, reason="cancelled",
                  tokens=1, violation="cancelled")
    elif retire:
        log.event(u, "retired", t_ms=ttft + tpot * tokens, reason="eos",
                  tokens=tokens, ttft_ms=ttft, tpot_ms=tpot,
                  violation="none")
    return u


def test_slo_report_attained_and_goodput_tok_s():
    def ops(log):
        for _ in range(4):
            _timeline(log, ttft=2.0, tpot=1.0, tokens=5, slo=(10.0, 5.0))
    j, log = _both(ops, max_requests=16)
    rep = log.slo_report(wall_s=2.0)
    assert rep == j.slo_report(wall_s=2.0)
    assert rep["requests"] == rep["attained"] == 4
    assert rep["goodput"] == 1.0
    assert rep["attained_tokens"] == 20
    assert rep["goodput_tok_s"] == 10.0
    assert rep["targets_ms"] == {"ttft": 10.0, "tpot": 5.0}
    assert all(v == 0 for v in rep["violations"].values())


def test_slo_violation_attribution_by_cause():
    """One cause a violating request, the same as the JAX log's: a missed
    TTFT splits by the larger segment, a missed TPOT is decode, a
    rejection and a cancel count in the denominator, in flight is
    incomplete."""
    def ops(log):
        slo = (10.0, 5.0)
        _timeline(log, qw=9.0, ttft=12.0, slo=slo)
        _timeline(log, qw=1.0, ttft=12.0, slo=slo)
        _timeline(log, ttft=2.0, tpot=50.0, slo=slo)
        _timeline(log, reject=True, slo=slo)
        _timeline(log, retire=False, slo=slo)
        _timeline(log, cancel=True, slo=slo)
        _timeline(log, ttft=2.0, tpot=1.0, tokens=7, slo=slo)
    j, log = _both(ops, max_requests=16)
    rep = log.slo_report()
    assert rep == j.slo_report()
    assert rep["requests"] == 7
    assert rep["violations"] == {"rejected": 1, "cancelled": 1,
                                 "queue_wait": 1, "prefill": 1,
                                 "decode": 1, "incomplete": 1}
    assert rep["attained"] == 1 and rep["goodput"] == round(1 / 7, 4)
    assert rep["attained_tokens"] == 7


def test_slo_report_explicit_targets_override_recorded():
    def ops(log):
        _timeline(log, ttft=20.0, tpot=9.0, slo=(0.0, 0.0))
    j, log = _both(ops, max_requests=16)
    assert log.slo_report()["attained"] == 1
    rep = log.slo_report(ttft_ms=10.0, tpot_ms=5.0)
    assert rep == j.slo_report(ttft_ms=10.0, tpot_ms=5.0)
    assert rep["attained"] == 0
    assert rep["violations"]["prefill"] == 1
    assert rep["targets_ms"] == {"ttft": 10.0, "tpot": 5.0}


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


def test_chunked_engine_event_order_per_request(pair):
    """Staggered chunked trace: submitted -> admitted -> prefill_chunk+ ->
    first_token -> retired, the chunk cursor rising to the prompt length;
    the same timelines as the JAX engine's."""
    sigs = []
    for model, log in zip(pair, (jobs.get_request_log(),
                                 obs.get_request_log())):
        eng = _engine(model, num_slots=2, max_length=MAXLEN, chunked=True,
                      prefill_chunk=8)
        rids = [eng.submit(_prompt(20, 1), max_new_tokens=3),
                eng.submit(_prompt(11, 2), max_new_tokens=4)]
        eng.step()
        rids.append(eng.submit(_prompt(5, 3), max_new_tokens=3))
        eng.drain()
        sigs.append(log.timeline_signature())
    assert sigs[0] == sigs[1]
    for rid, plen in zip(rids, (20, 11, 5)):
        tl = log.timeline(eng.request_uid(rid))
        names = [e["name"] for e in tl]
        n_chunks = -(-plen // 8)
        assert names == (["submitted", "admitted"]
                         + ["prefill_chunk"] * n_chunks
                         + ["first_token", "retired"])
        cursors = [e["attrs"]["cursor"] for e in tl
                   if e["name"] == "prefill_chunk"]
        assert cursors == sorted(cursors) and cursors[-1] == plen
        assert tl[0]["attrs"]["prompt_len"] == plen
        ret = tl[-1]["attrs"]
        assert ret["reason"] == "max_new_tokens"
        assert ret["tpot_ms"] is not None and ret["violation"] == "none"


def test_wave_engine_event_order_and_queue_wait(pair):
    _, tm = pair
    eng = _engine(tm, num_slots=2, max_length=MAXLEN, prefill_batch=2)
    rids = [eng.submit(_prompt(8, s), max_new_tokens=3) for s in range(3)]
    eng.drain()
    log = obs.get_request_log()
    for rid in rids:
        tl = log.timeline(eng.request_uid(rid))
        assert [e["name"] for e in tl] == \
            ["submitted", "admitted", "prefill", "first_token", "retired"]
        adm = tl[1]["attrs"]
        assert adm["queue_wait_ms"] >= 0.0
        assert tl[3]["attrs"]["ttft_ms"] >= adm["queue_wait_ms"]


def test_rejected_admission_records_and_counts(pair):
    for model, pkg in zip(pair, (jobs, obs)):
        eng = _engine(model, num_slots=2, max_length=32)
        log = pkg.get_request_log()
        mark = log.mark()
        with pytest.raises(ValueError, match="exceeds the engine's"):
            eng.submit(_prompt(40, 0), max_new_tokens=4)
        recs = log.records(since_uid=mark)
        assert len(recs) == 1
        (tl,) = recs.values()
        assert [e["name"] for e in tl] == ["submitted", "rejected"]
        assert tl[1]["attrs"]["reason"] == "too_long"
        assert eng.metrics()["slo_violations"] == {"rejected": 1}
        rep = log.slo_report(since_uid=mark)
        assert rep["requests"] == 1 and rep["goodput"] == 0.0
        assert rep["violations"]["rejected"] == 1
    with pytest.raises(ValueError, match="at least one token"):
        eng.submit([], max_new_tokens=4)
    assert eng.metrics()["slo_violations"] == {"rejected": 2}


def test_live_slo_flags_attribute_decode_violation(pair, monkeypatch):
    """Deadlines from the flags at submit: an impossible TPOT target
    marks the retirement a decode violation in the record and in
    serving.slo_violations; explicit submit() deadlines override the
    flags."""
    _, tm = pair
    monkeypatch.setitem(flags._values, "serving_slo_ttft_ms", 1e9)
    monkeypatch.setitem(flags._values, "serving_slo_tpot_ms", 1e-6)
    eng = _engine(tm, num_slots=2, max_length=MAXLEN)
    rid = eng.submit(_prompt(8, 0), max_new_tokens=4)
    eng.drain()
    log = obs.get_request_log()
    ret = log.timeline(eng.request_uid(rid))[-1]["attrs"]
    assert ret["violation"] == "decode"
    assert eng.metrics()["slo_violations"] == {"decode": 1}
    rep = log.slo_report()
    assert rep["violations"]["decode"] == 1
    assert rep["targets_ms"] == {"ttft": 1e9, "tpot": 1e-6}
    mark = log.mark()
    rid = eng.submit(_prompt(8, 0), max_new_tokens=4, ttft_slo_ms=1e-6,
                     tpot_slo_ms=0.0)
    eng.drain()
    assert log.timeline(eng.request_uid(rid))[-1]["attrs"]["violation"] \
        in ("queue_wait", "prefill")
    assert log.slo_report(since_uid=mark)["targets_ms"] == {
        "ttft": 1e-6, "tpot": 0.0}


# -- the JAX and port engines on one schedule -------------------------------

# the engines the reference's lifecycle covers: (name, options, the
# request count it takes to reach its events)
ENGINES = [
    ("wave", dict(num_slots=2, prefill_batch=2)),
    ("paged", dict(num_slots=2, paged=True, block_len=8, num_blocks=13)),
    ("chunked", dict(num_slots=2, chunked=True, prefill_chunk=8)),
    ("spec", dict(num_slots=2, spec_decode=True, spec_k=3)),
    ("swap", dict(num_slots=4, prefill_batch=2, paged=True, block_len=8,
                  num_blocks=13, preempt="swap", host_blocks=16)),
]


def _schedule(eng, name):
    """Two requests decode, two more arrive (priority 5 in the swap
    engine, whose pool then preempts); the ids in submit order."""
    sys_p = _prompt(16, 9)
    first = [np.concatenate([sys_p, _prompt(4, 10)]), _prompt(10, 1)]
    later = [np.concatenate([sys_p, _prompt(6, 11)]), _prompt(9, 3)]
    if name == "swap":
        first, later = [_prompt(12, 0), _prompt(10, 1)], \
            [_prompt(14, 2), _prompt(9, 3)]
    pri = 5 if name == "swap" else 0
    rids = [eng.submit(p, max_new_tokens=12) for p in first]
    for _ in range(3):
        eng.step()
    rids += [eng.submit(p, max_new_tokens=12, priority=pri)
             for p in later]
    out = dict(eng.drain())
    return [out[r] for r in rids]


class _ScriptedClock:
    """A stand-in for an engine module's ``time``: each ``perf_counter``
    call advances a fixed step, so a tick's measured time is a fixed
    function of the schedule and the cost model's drift detectors see no
    host noise (their finding count is part of ``perf_signature``)."""

    def __init__(self, dt=1e-4):
        self.t = 0.0
        self.dt = dt

    def perf_counter(self):
        self.t += self.dt
        return self.t


@pytest.mark.parametrize("name,kw", ENGINES, ids=[n for n, _ in ENGINES])
def test_engines_match_jax_timelines_series_and_perf(pair, name, kw,
                                                     monkeypatch):
    from paddle_tpu.serving import engine as jax_engine_mod
    from paddle_tpu_torch.serving import engine as engine_mod

    monkeypatch.setattr(jax_engine_mod, "time", _ScriptedClock())
    monkeypatch.setattr(engine_mod, "time", _ScriptedClock())
    jm, tm = pair
    jeng = _engine(jm, max_length=MAXLEN, **kw)
    want = _schedule(jeng, name)
    eng = _engine(tm, max_length=MAXLEN, **kw)
    got = _schedule(eng, name)
    assert got == want
    jlog, log = jobs.get_request_log(), obs.get_request_log()
    sig = log.timeline_signature()
    assert sig == jlog.timeline_signature()
    assert len(sig) == 4 and all(s[-1][0] == "retired" for s in sig)
    pools = (([jeng._eid], [jeng.kv._pid]), ([eng._eid], [eng.kv._pid])) \
        if kw.get("paged") else (([jeng._eid],), ([eng._eid],))
    assert_same_series(jobs.snapshot(), obs.snapshot(), *pools)
    rep = eng.perf_report()
    assert rep["profile"]["name"] == "cpu_smoke"
    assert perf_signature(rep) == jobs.perf_signature(jeng.perf_report())
    names = {e for s in sig for e, _ in s}
    if name == "spec":
        assert "spec_accept" in names
    if name == "chunked":
        assert "prefill_chunk" in names
    if name == "swap":
        assert {"preempted", "swapped_out", "swapped_in",
                "resumed"} <= names
        assert rep["predicted_ms"]["swap_ms"] > 0
    # metrics() reads the registry's series of this engine
    m, snap = eng.metrics(), obs.snapshot()
    row = [r for r in snap["serving.tokens_generated"]["series"]
           if r["labels"] == {"engine": eng._eid}]
    assert row[0]["value"] == m["tokens_generated"] == sum(map(len, got))
