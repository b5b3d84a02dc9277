"""The port's control plane (``paddle_tpu_torch/serving/admission.py``,
``autoscaler.py``, ``fleet_sim.py`` and the router's predictive gate)
against the JAX package's, on the CPU.

The thirteen cases of ``tests/test_control_plane.py``, each with the JAX
package's run as the oracle where the case has one: the hold queue's pop
orders, ``place_verdict``'s verdicts, the placements and timelines of the
fallback contracts, the autoscaler's action traces, the fleet simulator's
outputs, decisions and signatures.  Then ``run_fleet`` on the
``cpu_smoke`` profile (3000 requests, 4 replicas, predictive admission)
gives the reference's ``fleet_signature``: every decision, token and
timeline, and the replicas' simulated clocks, which both packages sum
tick by tick in one order (the signature rounds them to 1e-6 ms; the
clocks are compared at 1e-9 relative beside it).  ``SimEngine`` agrees
with the port's real engine tick for tick.

One JAX ``tiny_llama_config`` model (float32) is bridged into the port
(``models/convert.py``).  Tolerance: exact unless stated.
"""

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import flags as jflags
from paddle_tpu import observability as jobs
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.serving import ReplicaRouter as JaxRouter
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import admission as jadm
from paddle_tpu.serving import autoscaler as jas
from paddle_tpu.serving import fleet_sim as jfs
from paddle_tpu.serving import loadgen as jlg

from torch_obs_guard import fresh_observability  # noqa: F401
from torch_chip_rehearsal import one_thread  # noqa: F401
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.serving import ReplicaRouter, ServingEngine
from paddle_tpu_torch.serving import admission as tadm
from paddle_tpu_torch.serving import autoscaler as tas
from paddle_tpu_torch.serving import fleet_sim as tfs
from paddle_tpu_torch.serving import loadgen as tlg

MAXLEN = 64
BL = 8

_CP_KEYS = ("serving_admission", "serving_admission_slack",
            "serving_admission_calib", "serving_admission_max_defer_ticks",
            "serving_slo_ttft_ms", "serving_slo_tpot_ms",
            "serving_autoscale_min_ticks", "serving_autoscale_cooldown",
            "perf_model", "serving_chunked_prefill")


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Each test on one intra-op thread (``torch_chip_rehearsal``): its
    tensors are tiny, and six parallel workers that each take every core
    make such tests many times slower than alone."""
    yield


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = ({k: jflags.flag(k) for k in _CP_KEYS},
             {k: tflags.flag(k) for k in _CP_KEYS})
    yield
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


def set_flags(values):
    """The same flags in both packages."""
    jflags.set_flags(values)
    tflags.set_flags(values)


class Side:
    """One package's control plane over its model."""

    def __init__(self, model, port: bool):
        self.model = model
        self.port = port
        self.obs = tobs if port else jobs
        self.fs = tfs if port else jfs
        self.lg = tlg if port else jlg
        self.adm = tadm if port else jadm
        self.autoscaler = tas.ReplicaAutoscaler if port \
            else jas.ReplicaAutoscaler
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


@pytest.fixture(scope="module")
def sides():
    pt.seed(7)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    return Side(jm, False), Side(tm, True)


def _both(sides, scenario):
    jax_side, port_side = sides
    return scenario(jax_side), scenario(port_side)


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


def _trace(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return [(_prompt(int(rng.randint(4, 12)), seed * 100 + i),
             int(rng.randint(3, 7))) for i in range(n)]


def _replay_router(side, trace, **router_kw):
    router = side.router(num_replicas=2, paged=True, block_len=BL,
                         num_slots=2, max_length=MAXLEN,
                         policy="least_loaded", **router_kw)
    log = side.obs.get_request_log()
    mark = log.mark()
    rids = [router.submit(p, max_new_tokens=n) for p, n in trace]
    out = dict(router.drain())
    end = log.mark()
    return ([out[r] for r in rids],
            [router.replica_of(r) for r in rids],
            log.timeline_signature(since_uid=mark, until_uid=end))


# -- the hold queue's order ------------------------------------------------

def _pops(q):
    return [e.payload for e in q.ordered()]


def test_hold_queue_pops_priority_then_price_then_arrival():
    def scenario(adm):
        q = adm.HoldQueue(max_defer_ticks=0)          # aging off
        a = q.push("batch_cheap", priority=0, price=1.0)
        b = q.push("batch_dear", priority=0, price=9.0)
        c = q.push("interactive_dear", priority=5, price=9.0)
        d = q.push("interactive_cheap", priority=5, price=1.0)
        first = _pops(q)
        q.remove(d)
        return first, _pops(q), [a.seq, b.seq, c.seq], q.snapshot()

    got, want = scenario(tadm), scenario(jadm)
    assert got == want
    assert got[0] == ["interactive_cheap", "interactive_dear",
                      "batch_cheap", "batch_dear"]
    assert got[1] == ["interactive_dear", "batch_cheap", "batch_dear"]
    assert got[2] == sorted(got[2])


def test_hold_queue_aging_beats_priority_and_price():
    """An entry past the starvation bound jumps the whole line (FIFO among
    the aged)."""
    def scenario(adm):
        q = adm.HoldQueue(max_defer_ticks=3)
        old = q.push("old_batch", priority=0, price=99.0)
        for t in range(3):
            q.tick()
            q.push(f"fresh_hi_{t}", priority=5, price=0.0)
        q2 = adm.HoldQueue(max_defer_ticks=1)
        first = q2.push("first_dear", priority=0, price=50.0)
        second = q2.push("second_cheap", priority=5, price=0.0)
        q2.tick()
        return (q.aged(old), _pops(q), q2.aged(first), q2.aged(second),
                _pops(q2))

    got, want = scenario(tadm), scenario(jadm)
    assert got == want
    assert got[0] and got[1][0] == "old_batch"
    assert got[2] and got[3] and got[4] == ["first_dear", "second_cheap"]


# -- the fallback contracts ------------------------------------------------

def test_perf_model_off_is_byte_identical_legacy_placement(sides):
    """FLAGS_perf_model off: "predictive" admission degrades to the
    reactive policy, the same outputs, placements and timeline."""
    trace = _trace(n=8, seed=1)

    def scenario(side):
        set_flags({"perf_model": "off", "serving_slo_ttft_ms": 1.0,
                   "serving_slo_tpot_ms": 1.0,
                   "serving_admission": "queue_depth"})
        legacy = _replay_router(side, trace)
        set_flags({"serving_admission": "predictive"})
        return legacy, _replay_router(side, trace)

    want, got = _both(sides, scenario)
    assert got == want
    legacy, pred = got
    assert pred == legacy


def test_drift_finding_disarms_gate_conservatively(sides):
    """A drift finding disarms the gate on its engine, and one drifting
    replica disarms the router; the fallback still serves."""
    def scenario(side):
        set_flags({"serving_admission": "predictive", "perf_model": "on",
                   "serving_slo_tpot_ms": 50.0})
        eng = side.engine(num_slots=2, max_length=MAXLEN, paged=True,
                          block_len=BL)
        armed = [eng._perf is not None, eng.admission_armed()]
        router = side.router(engines=[
            eng, side.engine(num_slots=2, max_length=MAXLEN, paged=True,
                             block_len=BL)], policy="least_loaded")
        armed.append(router._predictive_armed())
        with eng._perf._lock:                 # inject a drift finding
            eng._perf._drift["weight"] = {
                "bound": "weight", "tick": 1, "ewma": 9.0,
                "baseline": 1.0, "lo": 0.5, "hi": 1.5}
        armed += [eng.admission_armed(), router._predictive_armed()]
        rid = router.submit(_prompt(6, 3), max_new_tokens=4)
        out = dict(router.drain())
        return armed, out[rid], router.replica_of(rid)

    want, got = _both(sides, scenario)
    assert got == want
    assert got[0] == [True, True, True, False, False]
    assert len(got[1]) == 4


def test_place_verdict_admits_without_deadline_or_model(sides):
    def scenario(side):
        set_flags({"perf_model": "on", "serving_slo_ttft_ms": 0.0,
                   "serving_slo_tpot_ms": 0.0})
        eng = side.engine(num_slots=2, max_length=MAXLEN, paged=True,
                          block_len=BL)
        v = side.adm.place_verdict(eng, 8)
        priced = side.adm.place_verdict(eng, 8, ttft_slo_ms=1e-6,
                                        tpot_slo_ms=1e-6)
        set_flags({"perf_model": "off"})
        e2 = side.engine(num_slots=2, max_length=MAXLEN, paged=True,
                         block_len=BL)
        v2 = side.adm.place_verdict(e2, 8, ttft_slo_ms=1.0,
                                    tpot_slo_ms=1.0)
        return [(x.verdict, x.reason, x.predicted_tpot_ms,
                 x.predicted_ttft_ms, x.price) for x in (v, priced, v2)]

    want, got = _both(sides, scenario)
    assert got == want
    assert got[0][:2] == ("admit", "no_deadline")
    assert got[1][:2] == ("defer", "predicted_slo") and got[1][4] > 0
    assert got[2][:2] == ("admit", "no_model")


# -- deferral liveness -----------------------------------------------------

def test_predictive_deferral_never_starves_and_finishes_all(sides):
    """An impossibly tight TPOT SLO prices every placement over the
    deadline: requests defer, age past the bound and are placed anyway;
    everything finishes."""
    def scenario(side):
        set_flags({"serving_admission": "predictive", "perf_model": "on",
                   "serving_admission_max_defer_ticks": 4,
                   "serving_slo_ttft_ms": 0.0,
                   "serving_slo_tpot_ms": 1e-6})
        fleet = side.fs.FleetSim(2, side.fs.SimSpec.default(), seed=0,
                                 num_slots=2, max_length=MAXLEN,
                                 block_len=BL)
        rids = [fleet.submit(_prompt(6, 10 + i), max_new_tokens=3,
                             priority=5 if i % 3 == 0 else 0)
                for i in range(6)]
        before = dict(fleet.router.metrics()["aggregate"]
                      ["control_plane"]["decisions"])
        out = dict(fleet.drain())
        return (rids, before, [out[r] for r in rids],
                [fleet.router.replica_of(r) for r in rids],
                fleet.router.pending_held,
                fleet.router.metrics()["aggregate"]["control_plane"])

    want, got = _both(sides, scenario)
    assert got == want
    rids, before, outs, _, held, _ = got
    assert before.get("defer", 0) > 0
    assert all(len(o) == 3 for o in outs) and held == 0


# -- the autoscaler --------------------------------------------------------

def _autoscale_run(side):
    set_flags({"serving_admission": "predictive", "perf_model": "on",
               "serving_slo_ttft_ms": 0.0, "serving_slo_tpot_ms": 40.0,
               "serving_autoscale_min_ticks": 3,
               "serving_autoscale_cooldown": 5})
    fs = side.fs
    spec = fs.SimSpec.default()
    fleet = fs.FleetSim(2, spec, seed=0, num_slots=4, max_length=512)
    scaler = side.autoscaler(
        fleet.router, min_replicas=2, max_replicas=5,
        engine_factory=lambda: fs.SimEngine(spec, num_slots=4,
                                            max_length=512, seed=99))
    trace = side.lg.generate_load(
        fs.fleet_load_spec(150, replicas=2, num_slots=4), seed=3)
    it = iter(trace)
    nxt, t = next(it, None), 0.0
    while (nxt is not None or fleet.router.pending_held
           or any(not fleet.router.replica_empty(i)
                  for i in fleet.router.live_replicas)):
        while nxt is not None and nxt.arrival <= t:
            fleet.submit(nxt.prompt, max_new_tokens=nxt.max_new_tokens)
            nxt = next(it, None)
        fleet.step()
        scaler.observe()
        t += 1.0
    for _ in range(200):                      # idle tail: drain + retire
        fleet.step()
        scaler.observe()
    return scaler.report()


@pytest.fixture(scope="module")
def autoscale_reports(sides):
    """The autoscaler run on each side: (JAX report, port report)."""
    saved = ({k: jflags.flag(k) for k in _CP_KEYS},
             {k: tflags.flag(k) for k in _CP_KEYS})
    try:
        return _both(sides, _autoscale_run)
    finally:
        jflags.set_flags(saved[0])
        tflags.set_flags(saved[1])


def test_autoscaler_grows_then_drains_then_retires(autoscale_reports):
    want, rep = autoscale_reports
    assert rep == want
    kinds = [a["action"] for a in rep["actions"]]
    assert "add" in kinds
    assert "drain" in kinds and "retire" in kinds
    drained = set()
    for a in rep["actions"]:
        if a["action"] == "drain":
            drained.add(a["replica"])
        elif a["action"] == "retire":
            assert a["replica"] in drained
    assert rep["live_replicas"] >= 2


def test_autoscaler_action_trace_is_deterministic(sides, autoscale_reports):
    _, port = sides
    assert _autoscale_run(port)["actions"] == \
        autoscale_reports[1]["actions"]


def test_autoscaler_never_retires_below_min(sides):
    def scenario(side):
        set_flags({"serving_autoscale_min_ticks": 1,
                   "serving_autoscale_cooldown": 0, "perf_model": "on"})
        fleet = side.fs.FleetSim(2, side.fs.SimSpec.default(), seed=0,
                                 num_slots=4, max_length=128)
        scaler = side.autoscaler(fleet.router, min_replicas=2)
        for _ in range(50):                   # pure slack, no work
            fleet.step()
            scaler.observe()
        return (len(fleet.router.live_replicas),
                sorted(fleet.router._draining), scaler.report())

    want, got = _both(sides, scenario)
    assert got == want
    assert got[0] == 2 and got[1] == []


# -- the fleet simulator ---------------------------------------------------

def test_fleet_sim_replays_byte_stable():
    r1 = tfs.run_fleet(requests=300, replicas=4, num_slots=4,
                       admission="predictive", seed=5)
    r2 = tfs.run_fleet(requests=300, replicas=4, num_slots=4,
                       admission="predictive", seed=5)
    assert r1["signature"] == r2["signature"]
    assert r1["ticks"] == r2["ticks"]
    assert r1["goodput"] is not None
    assert r1["profile"] == "h100"


def test_sim_engine_agrees_with_real_engine(sides):
    """SimEngine runs the real scheduler: on one trace the port's real
    paged engine and the sim agree tick for tick (ticks, token counts,
    timeline), and both equal the JAX package's pair."""
    trace = _trace(n=6, seed=2)

    def scenario(side):
        set_flags({"serving_admission": "queue_depth", "perf_model": "on"})
        log = side.obs.get_request_log()

        def replay(eng):
            mark = log.mark()
            rids = [eng.submit(p, max_new_tokens=n) for p, n in trace]
            out = dict(eng.drain())
            end = log.mark()
            return ([len(out[r]) for r in rids], eng._ticks,
                    log.timeline_signature(since_uid=mark, until_uid=end))

        eng = side.engine(num_slots=2, max_length=MAXLEN, paged=True,
                          block_len=BL)
        sim = side.fs.SimEngine(side.fs.SimSpec.from_engine(eng),
                                num_slots=2, max_length=MAXLEN,
                                block_len=BL)
        spec = side.fs.SimSpec.from_engine(eng)
        return replay(eng), replay(sim), (spec.weight_bytes,
                                          spec.n_params,
                                          spec.kv_token_bytes)

    want, got = _both(sides, scenario)
    real, sim, spec = got
    assert sim == real
    assert (real, sim) == want[:2]
    assert spec == want[2]


def test_sim_engine_rejects_unsupported_modes():
    tflags.set_flags({"serving_chunked_prefill": True})
    with pytest.raises(NotImplementedError):
        tfs.SimEngine(tfs.SimSpec.default())
    tflags.set_flags({"serving_chunked_prefill": False})


def test_admission_telemetry_reaches_metrics_registry(sides):
    """The router's decision counters and predicted-TPOT gauges land on
    the shared registry, as the JAX package's do."""
    def scenario(side):
        set_flags({"serving_admission": "predictive", "perf_model": "on",
                   "serving_slo_ttft_ms": 0.0,
                   "serving_slo_tpot_ms": 1e-6})   # defer everything
        fleet = side.fs.FleetSim(2, side.fs.SimSpec.default(), seed=0,
                                 num_slots=2, max_length=MAXLEN,
                                 block_len=BL)
        rid = fleet.submit(_prompt(6, 40), max_new_tokens=3, priority=1)
        fleet.submit(_prompt(7, 41), max_new_tokens=3)
        fleet.drain()
        text = side.obs.default_registry().prometheus_text()
        decisions = (fleet.router.metrics()["aggregate"]["control_plane"]
                     ["decisions"])
        names = sorted({ln.split("{")[0].split(" ")[0]
                        for ln in text.splitlines()
                        if ln.startswith(("router_", "serving_admission"))})
        return text, names, decisions, fleet.result(rid)

    want, got = _both(sides, scenario)
    text, names, decisions, out = got
    assert names == want[1] and decisions == want[2] and out == want[3]
    assert "router_admission_decision" in text
    assert 'verdict="defer"' in text and 'verdict="admit"' in text
    assert "router_predicted_tpot_ms" in text
    assert "serving_admission_deferred" in text
    assert decisions.get("defer", 0) >= 1
    assert decisions.get("admit", 0) >= 2
    assert len(out) == 3


# -- run_fleet at scale: the reference's signature --------------------------

def test_run_fleet_signature_equals_reference():
    """3000 requests over 4 replicas on ``cpu_smoke`` under a 400 ms TTFT
    deadline (the gate defers once a replica's backlog would take two
    waves; seed 2 makes it defer 42 times): the port's fleet_signature is
    the reference's, and every decision and clock beside it."""
    set_flags({"serving_slo_ttft_ms": 400.0})
    kw = dict(requests=3000, replicas=4, num_slots=8,
              admission="predictive", seed=2, profile="cpu_smoke")
    got = tfs.run_fleet(**kw)
    want = jfs.run_fleet(**kw)
    for k in ("ticks", "generated_tokens", "rejected", "goodput",
              "slo_by_worker"):
        assert got[k] == want[k], k
    assert got["fleet"]["router"] == want["fleet"]["router"]
    assert got["fleet"]["per_replica"] == want["fleet"]["per_replica"]
    for name, ms in want["worker_clocks_ms"].items():
        assert got["worker_clocks_ms"][name] == pytest.approx(ms,
                                                              rel=1e-9)
    assert got["signature"] == want["signature"]
    assert got["fleet"]["router"]["decisions"].get("defer", 0) > 0
    assert got["generated_tokens"] > 0


SIM_MODES = {
    # a pool too tight for the trace: the scheduler swaps victims out
    # through the host tier and back
    "swap": ({"serving_admission": "queue_depth"},
             dict(num_blocks=7, preempt="swap", host_blocks=16)),
    # the predictive gate holds requests back (a TPOT deadline the
    # post-admission tick of a busy engine prices over)
    "predictive": ({"serving_admission": "predictive",
                    "serving_slo_tpot_ms": "busy"}, {}),
}


@pytest.mark.parametrize("mode", list(SIM_MODES))
def test_sim_engine_agrees_on_swap_and_predictive_paths(sides, mode):
    """The sim beside the port's real engine on the swap path and through
    the predictive gate: the same ticks, tokens, timelines and preemption
    decisions, and the port's sim equal to the JAX package's sim."""
    fl, kw = SIM_MODES[mode]
    trace = [(_prompt(10 + (i % 3), 300 + i), 6 + (i % 4))
             for i in range(8)]

    def scenario(side):
        set_flags({"perf_model": "on", "serving_admission": "queue_depth"})
        eng = side.engine(num_slots=3, max_length=MAXLEN, paged=True,
                          block_len=BL, prefill_batch=2, **kw)
        spec = side.fs.SimSpec.from_engine(eng)
        flags = dict(fl)
        if flags.get("serving_slo_tpot_ms") == "busy":
            # between the predicted tick of 1 and of 3 busy slots
            m = eng._perf.model
            flags["serving_slo_tpot_ms"] = (
                m.predicted_tick_ms(1, 16) + m.predicted_tick_ms(3, 48)) \
                / 2 / float(jflags.flag("serving_admission_slack"))
        set_flags(flags)
        sim = side.fs.SimEngine(spec, num_slots=3, max_length=MAXLEN,
                                block_len=BL, prefill_batch=2,
                                **{k: v for k, v in kw.items()})
        log = side.obs.get_request_log()
        runs = []
        for e in (eng, sim):
            mark = log.mark()
            rids = [e.submit(p, max_new_tokens=n) for p, n in trace]
            out = dict(e.drain())
            end = log.mark()
            runs.append(([len(out[r]) for r in rids], e._ticks,
                         log.timeline_signature(since_uid=mark,
                                                until_uid=end),
                         e.preempt_decisions if side.port
                         else e._preempt_log,
                         int(e._m_deferred.value())))
        return runs

    want, got = _both(sides, scenario)
    real, sim = got
    assert sim == real
    assert sim == want[1]
    if mode == "swap":
        assert real[3], "the tight pool preempted nothing"
    else:
        assert real[4] > 0, "the gate deferred nothing"
