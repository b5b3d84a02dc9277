"""The port's preemptive scheduling (``preempt="swap"`` over the host tier,
``preempt="recompute"``) and ``cancel``, against the JAX package's engine,
on the CPU: every test of ``tests/test_serving_preempt.py`` with the same
submissions through both engines.

One JAX ``tiny_llama_config`` model (float32) is bridged into the port.
Under a pool too small for the working set (13 blocks of 8 tokens), two
priority-0 requests decode, then two priority-5 arrivals find nothing
free.  Tolerance: tokens identical, ``preempt_decisions`` (victim, waiter,
tick, mode, slot, progress, in order) and counters equal.

The router's ``cancel`` (``test_router_cancel_and_priority``) is in
``tests/test_torch_serving_router.py``.  The
request log's lifecycle events of preemption
(``test_preempted_lifecycle_events``) and the cost model's swap term are
held here against the JAX engine's, and so is the
``slo_violations["cancelled"]`` bucket.
"""

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.serving import ServingEngine

MAXLEN = 64
BL = 8


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


PROMPTS = [_prompt(12, 0), _prompt(10, 1), _prompt(14, 2), _prompt(9, 3)]


def _engine(model, **kw):
    """The reference test's engine; a port model gets a CPU port engine,
    a JAX model the JAX engine."""
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_length", MAXLEN)
    kw.setdefault("prefill_batch", 2)
    kw.setdefault("paged", True)
    kw.setdefault("block_len", BL)
    kw.setdefault("num_blocks", 13)
    if isinstance(model, LlamaForCausalLM):
        return ServingEngine(model, device="cpu", **kw)
    return JaxEngine(model, **kw)


def _saturate(eng, steps=3):
    """Two low-priority requests decode first; two high-priority arrivals
    then hit a pool with nothing free."""
    rids = [eng.submit(p, max_new_tokens=12, priority=0)
            for p in PROMPTS[:2]]
    for _ in range(steps):
        eng.step()
    rids += [eng.submit(p, max_new_tokens=12, priority=5)
             for p in PROMPTS[2:]]
    return rids, dict(eng.drain())


@pytest.fixture(scope="module")
def fifo_outputs(pair):
    jm, _ = pair
    eng = _engine(jm, preempt="off")
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=12)
    return dict(eng.drain())


MODES = [("swap", {"host_blocks": 16}), ("recompute", {})]


@pytest.fixture(scope="module")
def jax_saturated(pair):
    """The JAX preempting wave engine's run of ``_saturate``, by mode:
    (outputs, decisions, signature, metrics)."""
    jm, _ = pair
    out = {}
    for mode, extra in MODES:
        eng = _engine(jm, preempt=mode, **extra)
        _, o = _saturate(eng)
        out[mode] = (o, eng.preempt_decisions, eng.preempt_signature(),
                     eng.metrics())
    return out


@pytest.mark.parametrize("mode,extra", MODES)
def test_wave_preempt_token_identical(pair, fifo_outputs, jax_saturated,
                                      mode, extra):
    _, tm = pair
    eng = _engine(tm, preempt=mode, **extra)
    _, out = _saturate(eng)
    want, decisions, sig, jm = jax_saturated[mode]
    assert out == want == fifo_outputs
    assert eng.preempt_decisions == decisions
    assert eng.preempt_signature() == sig
    m = eng.metrics()
    assert sum(m["preempt"]["preemptions"].values()) > 0
    assert m["preempt"]["preemptions"] == m["preempt"]["resumes"]
    assert m["preempt"] == jm["preempt"]
    assert m["step_traces"] == 1
    assert eng.num_preempted == 0
    assert eng.kv.blocks_in_use() == 0
    if mode == "swap":
        ht = m["kv_cache"]["host_tier"]
        assert eng.host_cache_bytes > 0        # host memory, not the pool
        assert ht["swapped_out_blocks"] > 0
        assert ht["swapped_out_blocks"] == ht["swapped_in_blocks"]
        assert ht["swap_out_bytes"] == ht["swap_in_bytes"] > 0
        assert ht["host_blocks_used"] == 0     # everything swapped back
        assert {k: v for k, v in ht.items() if k != "host_cache_bytes"} \
            == jm["kv_cache"]["host_tier"]
        # swap bytes reach the cost model's swap term
        rep = eng.perf_report()
        assert rep["enabled"] and rep["predicted_ms"]["swap_ms"] > 0


@pytest.mark.parametrize("mode,extra", MODES)
def test_chunked_preempt_token_identical(pair, fifo_outputs, mode, extra):
    """The chunked engines (8-token chunks): the port's tokens and
    decisions equal the JAX preempting chunked engine's, whose tokens
    equal the FIFO engine's."""
    jm, tm = pair
    got = []
    for model in (jm, tm):
        eng = _engine(model, chunked=True, prefill_chunk=8, preempt=mode,
                      **extra)
        _, out = _saturate(eng, steps=6)
        got.append((out, eng.preempt_decisions))
        m = eng.metrics()
        assert sum(m["preempt"]["preemptions"].values()) > 0
        assert m["step_traces"] == 1
    assert got[1] == got[0]
    assert got[0][0] == fifo_outputs


def test_preempt_signature_replay_stable(pair, jax_saturated):
    _, tm = pair
    sigs, decs = [], []
    for _ in range(2):
        eng = _engine(tm, preempt="recompute")
        _saturate(eng)
        sigs.append(eng.preempt_signature())
        decs.append(eng.preempt_decisions)
    assert sigs[0] == sigs[1] == jax_saturated["recompute"][2]
    assert decs[0] == decs[1] and len(decs[0]) > 0


def test_victim_selection_lowest_priority_first(pair):
    """The documented victim order: the lowest priority class loses first,
    whatever the submission order; the JAX engine picks the same."""
    got = []
    for model in pair:
        eng = _engine(model, num_blocks=8, preempt="recompute")
        rid_a = eng.submit(PROMPTS[0], max_new_tokens=12, priority=2)
        rid_b = eng.submit(PROMPTS[1], max_new_tokens=12, priority=0)
        for _ in range(3):
            eng.step()
        rid_c = eng.submit(PROMPTS[2], max_new_tokens=12, priority=5)
        out = dict(eng.drain())
        decs = eng.preempt_decisions
        assert decs, "tight pool produced no preemption"
        assert decs[0]["victim_rid"] == rid_b
        assert decs[0]["waiter_rid"] == rid_c
        assert rid_a not in {d["victim_rid"] for d in decs}
        got.append((out, decs))
    assert got[0] == got[1]


def test_admit_selection_spans_queues(pair):
    """With preemption armed, admission picks across BOTH the
    recompute-resume queue and the submit queue by priority class — a
    blocked low-priority resume head does not stall a higher-priority
    fresh submit; within a class the resume entry (older request id)
    keeps precedence.  The JAX engine picks the same."""
    for model in pair:
        eng = _engine(model, preempt="recompute")
        r_lo = eng.submit(PROMPTS[0], max_new_tokens=4, priority=0)
        r_hi = eng.submit(PROMPTS[1], max_new_tokens=4, priority=5)
        req_lo = next(r for r in eng._queue if r.request_id == r_lo)
        eng._queue.remove(req_lo)
        eng._push_resume_q(req_lo)          # a parked recompute-resume head
        src, req = eng._next_admit()
        assert req.request_id == r_hi and src is eng._queue
        # same class: the resume entry's older id wins
        next(r for r in eng._queue if r.request_id == r_hi).priority = 0
        src, req = eng._next_admit()
        assert req.request_id == r_lo and src is eng._resume_q
        eng.drain()


def test_ctor_validation(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="preempt"):
        _engine(tm, preempt="bogus")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(tm, num_slots=2, max_length=MAXLEN,
                      preempt="recompute", device="cpu")
    with pytest.raises(ValueError, match="host_blocks"):
        _engine(tm, preempt="swap")         # swap needs a host tier


# -------------------------------------------------------- cancellation --

def test_preempted_lifecycle_events(pair):
    """A swap victim's request log: preempted < swapped_out < swapped_in
    < resumed < retired, and every request's timeline (names and
    deterministic attrs) equal to the JAX engine's over the same
    submissions."""
    from paddle_tpu import observability as jobs
    from paddle_tpu_torch import observability as obs

    sigs = []
    for model, log in zip(pair, (jobs.get_request_log(),
                                 obs.get_request_log())):
        mark = log.mark()
        eng = _engine(model, preempt="swap", host_blocks=16)
        _saturate(eng)
        sigs.append(log.timeline_signature(since_uid=mark))
    victims = {d["victim_rid"] for d in eng.preempt_decisions}
    assert victims
    rid = sorted(victims)[0]
    names = log.event_names(eng.request_uid(rid))
    for ev in ("preempted", "swapped_out", "swapped_in", "resumed"):
        assert ev in names, names
    assert (names.index("preempted") < names.index("swapped_out")
            < names.index("swapped_in") < names.index("resumed")
            < names.index("retired"))
    assert sigs[0] == sigs[1]


def _cancel_accounting_ok(eng, n_cancelled):
    m = eng.metrics()
    assert m["cancelled"] == n_cancelled
    assert m["retired"].get("cancelled", 0) == n_cancelled
    assert m["slo_violations"].get("cancelled", 0) == n_cancelled


def test_cancel_queued_running_finished(pair):
    got = []
    for model in pair:
        eng = _engine(model, preempt="swap", host_blocks=16)
        r0 = eng.submit(PROMPTS[0], max_new_tokens=12)
        r1 = eng.submit(PROMPTS[1], max_new_tokens=12)
        eng.step()
        assert eng.cancel(r1) is True             # running slot
        assert eng.cancel(r1) is False            # already gone
        r2 = eng.submit(PROMPTS[2], max_new_tokens=12)
        assert eng.cancel(r2) is True             # still queued
        out = dict(eng.drain())
        assert r0 in out and len(out[r0]) == 12   # survivor unaffected
        assert eng.cancel(r0) is False            # finished -> False
        assert eng.kv.blocks_in_use() == 0
        assert eng.metrics()["cancelled"] == 2
        got.append(out)
    assert got[0] == got[1]
    _cancel_accounting_ok(eng, 2)


def test_cancel_mid_chunked_prefill(pair):
    _, tm = pair
    eng = _engine(tm, chunked=True, prefill_chunk=8)
    rid = eng.submit(PROMPTS[2], max_new_tokens=12)   # 14 tokens, chunk 8
    eng.step()
    assert eng._cursor is not None                     # mid-prefill
    assert eng.cancel(rid) is True
    eng.drain()
    assert eng.kv.blocks_in_use() == 0
    assert eng.kv._reserved == 0
    _cancel_accounting_ok(eng, 1)


def test_cancel_awaiting_resume_drops_swap_record(pair):
    got = []
    for model in pair:
        eng = _engine(model, preempt="swap", host_blocks=16)
        for p in PROMPTS[:2]:
            eng.submit(p, max_new_tokens=12, priority=0)
        for _ in range(3):
            eng.step()
        eng.submit(PROMPTS[2], max_new_tokens=12, priority=5)
        eng.submit(PROMPTS[3], max_new_tokens=12, priority=5)
        eng.step()                                # forces the preemption
        victims = {d["victim_rid"] for d in eng.preempt_decisions}
        assert victims
        rid = sorted(victims)[0]
        assert eng.num_preempted > 0
        assert eng.cancel(rid) is True            # swapped out, not resident
        out = dict(eng.drain())
        assert eng.kv.blocks_in_use() == 0
        assert eng.kv.host_blocks_used() == eng.kv.host_trie_blocks()
        assert len(eng.result(rid)) < 12          # partial output readable
        got.append((out, eng.preempt_decisions))
    assert got[0] == got[1]
    _cancel_accounting_ok(eng, 1)


def test_cancel_in_every_state(pair):
    """Five cancels on a chunked preempting engine in each mode: the
    preempted request (swapped out, or awaiting its recompute resume),
    one mid chunked prefill, a queued one and a decoding one; afterwards
    no block is in use and the host tier holds only demoted prefix
    blocks."""
    _, tm = pair
    states = set()
    for mode, extra in MODES:
        eng = _engine(tm, chunked=True, prefill_chunk=8, preempt=mode,
                      **extra)
        for p in PROMPTS[:2]:
            eng.submit(p, max_new_tokens=12, priority=0)
        for _ in range(6):
            eng.step()
        for p in PROMPTS[2:]:
            eng.submit(p, max_new_tokens=12, priority=5)
        while not eng.preempt_decisions:
            eng.step()
        victim = eng.preempt_decisions[0]["victim_rid"]
        assert eng.num_preempted == 1
        assert eng.cancel(victim)
        states.add("swapped" if mode == "swap" else "awaiting resume")
        assert eng.num_preempted == 0
        assert eng._cursor is not None
        assert eng.cancel(eng._cursor.req.request_id)
        assert eng._cursor is None
        late = eng.submit(_prompt(20, 9), max_new_tokens=4)
        assert eng.cancel(late)
        live = [s.rid for s in eng._slots if s is not None]
        assert live and eng.cancel(live[0])
        states |= {"prefill", "queued", "decoding"}
        eng.drain()
        assert eng.kv.blocks_in_use() == 0
        assert eng.kv.host_blocks_used() == eng.kv.host_trie_blocks()
        _cancel_accounting_ok(eng, 4)
    assert states == {"swapped", "awaiting resume", "prefill", "queued",
                      "decoding"}
