"""The port's replica router (``paddle_tpu_torch/serving/router.py``)
against the JAX package's, on the CPU.

The five cases of ``tests/test_serving_router.py`` (the empty-trie cold
start, prefix affinity, failover on an outright rejection, session
affinity across chunked-prefill ticks, round robin), each run on the port
router and on the JAX router over the same model: placements, tokens, the
aggregates of ``metrics()`` and the ``router.*`` series of the registry
equal.  Then ``test_serving_preempt.py::test_router_cancel_and_priority``
and ``test_request_lifecycle.py::
test_router_failover_carries_one_uid_across_replicas``, with the
timelines equal to the reference's.

One JAX ``tiny_llama_config`` model (float32) is bridged into the port
(``models/convert.py``).  Tolerance: exact.
"""

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import observability as jobs
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.serving import ReplicaRouter as JaxRouter
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import one_thread  # noqa: F401
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.serving import ReplicaRouter, ServingEngine

MAXLEN = 64
BL = 8           # block_len: small so short prompts span whole blocks


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Each test on one intra-op thread (``torch_chip_rehearsal``): its
    tensors are tiny, and six parallel workers that each take every core
    make such tests many times slower than alone."""
    yield


@pytest.fixture(scope="module")
def pair():
    pt.seed(7)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    return jm, tm


class Side:
    """One package's router, engine and observability over its model;
    ``engine`` / ``router`` take the reference test's arguments (the
    port's engines on the CPU)."""

    def __init__(self, model, port: bool):
        self.model = model
        self.port = port
        self.obs = tobs if port else jobs
        self._router = ReplicaRouter if port else JaxRouter
        self._engine = ServingEngine if port else JaxEngine
        self._ekw = {"device": "cpu"} if port else {}

    def engine(self, **kw):
        return self._engine(self.model, **self._ekw, **kw)

    def router(self, num_replicas=None, **kw):
        if "engines" in kw:
            return self._router(**kw)
        return self._router(self.model, num_replicas=num_replicas,
                            **self._ekw, **kw)


def _both(pair, scenario):
    """``scenario(side)`` on the JAX side, then on the port's; returns
    both results (each a dict the scenario fills)."""
    jm, tm = pair
    return scenario(Side(jm, False)), scenario(Side(tm, True))


def router_series(snap, router_ids):
    """The ``router.*`` families of a snapshot, ``router`` labels renamed
    by their place in ``router_ids``."""
    ren = {str(r): f"r{i}" for i, r in enumerate(router_ids)}
    out = {}
    for name, fam in snap.items():
        if not name.startswith("router."):
            continue
        rows = []
        for r in fam["series"]:
            labels = dict(r["labels"])
            if "router" in labels:
                labels["router"] = ren.get(labels["router"],
                                           labels["router"])
            rows.append(dict(r, labels=labels))
        rows.sort(key=lambda r: sorted(r["labels"].items()))
        out[name] = {"type": fam["type"], "help": fam["help"],
                     "series": rows}
    return out


def _finish(side, routers, out):
    """A scenario's common record: each router's aggregates and the
    registry's router series."""
    out["aggregates"] = [r.metrics()["aggregate"] for r in routers]
    out["series"] = router_series(side.obs.snapshot(),
                                  [r._router_id for r in routers])
    return out


def _same(jax_out, port_out):
    assert port_out.keys() == jax_out.keys()
    for k in jax_out:
        assert port_out[k] == jax_out[k], k


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


def _paged_router(side, n=2, **kw):
    kw.setdefault("policy", "prefix")
    return side.router(num_replicas=n, paged=True, block_len=BL,
                       num_slots=2, max_length=MAXLEN, **kw)


def test_cold_start_empty_trie_falls_back_to_least_loaded(pair):
    """Every trie empty: the prefix policy degenerates to least-loaded and
    spreads requests over the replicas."""
    def scenario(side):
        router = _paged_router(side)
        r0 = router.submit(_prompt(6, 1), max_new_tokens=4)
        r1 = router.submit(_prompt(7, 2), max_new_tokens=4)
        out = dict(router.drain())
        return _finish(side, [router], {
            "placed": [router.replica_of(r) for r in (r0, r1)],
            "tokens": [out[r0], out[r1]]})

    want, got = _both(pair, scenario)
    _same(want, got)
    assert got["placed"][0] != got["placed"][1]
    assert all(len(t) == 4 for t in got["tokens"])


def test_prefix_affinity_routes_to_warm_replica_and_beats_parity(pair):
    """A prompt sharing a cached full-block prefix lands on the replica
    that computed it, even where least-loaded would steer away, and every
    output equals a single engine's."""
    def scenario(side):
        router = _paged_router(side)
        shared = _prompt(2 * BL, 3)
        first = np.concatenate([shared, _prompt(3, 4)])
        r0 = router.submit(first, max_new_tokens=4)
        router.drain()
        other = router.submit(_prompt(5, 5), max_new_tokens=6)
        follow = np.concatenate([shared, _prompt(4, 6)])
        r1 = router.submit(follow, max_new_tokens=4)
        out = dict(router.drain())
        eng = side.engine(num_slots=2, max_length=MAXLEN, paged=True,
                          block_len=BL)
        rids = [eng.submit(p, max_new_tokens=n)
                for p, n in ((first, 4), (_prompt(5, 5), 6), (follow, 4))]
        ref = dict(eng.drain())
        return _finish(side, [router], {
            "placed": [router.replica_of(r) for r in (r0, other, r1)],
            "tokens": [out[r0], out[other], out[r1]],
            "single_engine": [ref[r] for r in rids]})

    want, got = _both(pair, scenario)
    _same(want, got)
    home = got["placed"][0]
    assert got["placed"] == [home, home, home]
    assert got["tokens"] == got["single_engine"]
    agg = got["aggregates"][0]
    assert agg["prefix_routed_tokens"] >= BL
    assert agg["prefix_hit_rate_pooled"] > 0


def test_submit_failover_on_replica_rejection(pair):
    """A replica rejecting admission outright fails over to the next
    candidate, even when it held the warm prefix; only when every replica
    rejects does the error propagate."""
    def scenario(side):
        tiny = side.engine(num_slots=2, max_length=MAXLEN, paged=True,
                           block_len=BL, num_blocks=4)
        big = side.engine(num_slots=2, max_length=MAXLEN, paged=True,
                          block_len=BL)
        router = side.router(engines=[tiny, big], policy="prefix")
        shared = _prompt(BL, 7)
        r0 = router.submit(np.concatenate([shared, _prompt(2, 8)]),
                           max_new_tokens=2)
        router.drain()
        r1 = router.submit(np.concatenate([shared, _prompt(2, 9)]),
                           max_new_tokens=30)
        out = dict(router.drain())
        lone = side.router(engines=[tiny], policy="prefix")
        with pytest.raises(ValueError):
            lone.submit(_prompt(4, 10), max_new_tokens=MAXLEN - 4)
        return _finish(side, [router, lone], {
            "placed": [router.replica_of(r) for r in (r0, r1)],
            "tokens": [out[r0], out[r1]]})

    want, got = _both(pair, scenario)
    _same(want, got)
    assert got["placed"] == [0, 1]
    assert got["aggregates"][0]["submit_failovers"] >= 1
    assert len(got["tokens"][1]) == 30


def test_session_affinity_survives_chunked_prefill_ticks(pair):
    """A session's requests stay on one replica while an earlier request
    of the session is still chunk-prefilling there."""
    def scenario(side):
        router = side.router(num_replicas=2, policy="prefix", paged=True,
                             block_len=BL, num_slots=2, max_length=MAXLEN,
                             chunked=True, prefill_chunk=8)
        r0 = router.submit(_prompt(33, 11), max_new_tokens=3,
                           session="tenant-a")
        home = router.replica_of(r0)
        router.step()
        eng = router.engines[home]
        mid = (eng.num_pending, eng.pending_chunks)
        r1 = router.submit(_prompt(5, 12), max_new_tokens=3,
                           session="tenant-a")
        r2 = router.submit(_prompt(5, 13), max_new_tokens=3)
        out = dict(router.drain())
        return _finish(side, [router], {
            "mid_prefill": mid,
            "placed": [router.replica_of(r) for r in (r0, r1, r2)],
            "tokens": [out[r] for r in (r0, r1, r2)]})

    want, got = _both(pair, scenario)
    _same(want, got)
    assert got["mid_prefill"][0] == 1 and got["mid_prefill"][1] >= 1
    home = got["placed"][0]
    assert got["placed"][1] == home and got["placed"][2] != home
    assert all(len(t) == 3 for t in got["tokens"])


def test_round_robin_policy_and_aggregated_metrics(pair):
    def scenario(side):
        router = side.router(num_replicas=2, policy="round_robin",
                             num_slots=2, max_length=MAXLEN)
        rids = [router.submit(_prompt(4 + i, 20 + i), max_new_tokens=3)
                for i in range(4)]
        out = dict(router.drain())
        with pytest.raises(ValueError):
            side.router(num_replicas=2, policy="bogus")
        return _finish(side, [router], {
            "placed": [router.replica_of(r) for r in rids],
            "tokens": [out[r] for r in rids],
            "replicas": len(router.metrics()["per_replica"])})

    want, got = _both(pair, scenario)
    _same(want, got)
    assert got["placed"] == [0, 1, 0, 1]
    agg = got["aggregates"][0]
    assert agg["tokens_generated"] == sum(map(len, got["tokens"])) == 12
    assert agg["requests_finished"] == 4
    assert got["replicas"] == 2


# -- the router tests of the preemption and lifecycle files ----------------

def _lifecycle(side, uid):
    """A timeline as (event, deterministic attrs): engine / router ids
    and ``*_ms`` timings left out."""
    out = []
    for ev in side.obs.get_request_log().timeline(uid):
        attrs = {k: v for k, v in ev["attrs"].items()
                 if k not in ("engine", "router") and not k.endswith("_ms")}
        out.append((ev["name"], attrs))
    return out


def test_router_cancel_and_priority(pair):
    prompts = [_prompt(12, 0), _prompt(10, 1)]

    def scenario(side):
        router = side.router(num_replicas=2, paged=True, block_len=BL,
                             num_blocks=13, num_slots=4, max_length=MAXLEN,
                             preempt="recompute")
        r0 = router.submit(prompts[0], max_new_tokens=8, priority=3)
        r1 = router.submit(prompts[1], max_new_tokens=8)
        # the priority rides through to the replica's scheduler
        i, erid = router._placed[r0]
        prio = [r.priority for r in router.engines[i]._queue
                if r.request_id == erid]
        router.step()
        cancels = [router.cancel(r1), router.cancel(r1)]
        with pytest.raises(KeyError):
            router.cancel(10_000)
        out = dict(router.drain())
        cancels.append(router.cancel(r0))
        return _finish(side, [router], {
            "cancels": cancels, "tokens": out[r0], "priority": prio,
            "blocks_in_use": [e.kv.blocks_in_use()
                              for e in router.engines],
            "timelines": [_lifecycle(side, router.request_uid(r))
                          for r in (r0, r1)]})

    want, got = _both(pair, scenario)
    _same(want, got)
    assert got["cancels"] == [True, False, False]
    assert got["priority"] == [3]
    assert len(got["tokens"]) == 8
    assert got["blocks_in_use"] == [0, 0]


def test_router_failover_carries_one_uid_across_replicas(pair):
    """The replica rejecting admission outright and the one then serving
    the request write to ONE timeline: the router mints the uid and
    threads it through both attempts."""
    def scenario(side):
        router = side.router(
            engines=[side.engine(num_slots=2, max_length=32),
                     side.engine(num_slots=2, max_length=MAXLEN)],
            policy="least_loaded")
        rid = router.submit(_prompt(40, 0), max_new_tokens=3)
        router.drain()
        uid = router.request_uid(rid)
        tl = side.obs.get_request_log().timeline(uid)
        return _finish(side, [router], {
            "replica": router.replica_of(rid),
            "timeline": _lifecycle(side, uid),
            "router_attr_is_id": tl[0]["attrs"]["router"]
            == router._router_id,
            "two_engines": tl[1]["attrs"]["engine"]
            != tl[3]["attrs"]["engine"],
            "engine_uid_agrees": router.engines[1].request_uid(
                router._placed[rid][1]) == uid})

    want, got = _both(pair, scenario)
    _same(want, got)
    assert got["replica"] == 1
    assert [n for n, _ in got["timeline"]] == [
        "submitted", "rejected", "placed", "admitted", "prefill",
        "first_token", "retired"]
    assert got["timeline"][1][1]["reason"] == "too_long"
    assert got["timeline"][2][1]["replica"] == "1"
    assert got["router_attr_is_id"] and got["two_engines"]
    assert got["engine_uid_agrees"]


# -- the router's probe ----------------------------------------------------

def test_prefix_probe_is_read_only_and_equal_to_jax():
    """``BlockManager.prefix_probe`` on the port's manager and the JAX
    package's after the same admissions and releases: the same cached
    tokens for every probe (capped as ``admit`` caps: one token left), and
    the probe changes no refcount, no LRU order and no counter."""
    from paddle_tpu.serving.kv_cache import BlockManager as JaxManager
    from paddle_tpu_torch.serving.kv_cache import BlockManager

    shared = _prompt(3 * BL, 50)
    prompts = [np.concatenate([shared, _prompt(n, 51 + n)])
               for n in (2, 5)]
    probes = [shared, shared[:2 * BL], shared[:2 * BL + 1],
              np.concatenate([shared, _prompt(1, 60)]),
              np.concatenate([shared[:BL], _prompt(2 * BL, 61)]),
              _prompt(4 * BL, 62), shared[:1]]
    got = []
    for mgr in (JaxManager(16, BL), BlockManager(16, BL)):
        for slot, p in enumerate(prompts):
            assert mgr.admit(slot, p, p.size, 4) is not None
        mgr.release(0)                  # its private tail goes, the
        seen = []                       # registered blocks stay cached
        for p in probes:
            before = (dict(mgr._ref) if isinstance(mgr._ref, dict)
                      else np.asarray(mgr._ref).tolist(),
                      list(mgr._lru), mgr.stats)
            seen.append(mgr.prefix_probe(p))
            after = (dict(mgr._ref) if isinstance(mgr._ref, dict)
                     else np.asarray(mgr._ref).tolist(),
                     list(mgr._lru), mgr.stats)
            assert after == before
        got.append(seen)
    assert got[1] == got[0]
    assert got[1][:4] == [2 * BL, BL, 2 * BL, 3 * BL]
    assert BlockManager(16, BL, prefix_cache=False).prefix_probe(
        shared) == 0
