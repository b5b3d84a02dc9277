"""Trace-driven load harness: seeded arrival processes and length mixes
replayed against a ServingEngine or a ReplicaRouter (mirrors
``paddle_tpu/serving/loadgen.py``).

Raw tok/s on a batch drained until empty says nothing about production
serving, which is judged on goodput under SLO: requests finishing within
their TTFT / TPOT deadlines under realistic traffic.  This module is the
traffic half of that judgment:

  * **arrival processes**: seeded Poisson (exponential gaps) and bursty
    on / off (dense arrivals inside ``burst_on``-tick windows separated by
    silent ``burst_off`` gaps), in scheduler-tick time, so a replay does
    not depend on the device's speed;
  * **length mixes**: heavy-tailed prompt / output lengths, lognormal
    (median x e^{sigma Z}, clamped) or Zipf-bucketed (a fixed ladder of
    lengths with rank-``a`` power-law mass);
  * **tenants**: Zipf-popular tenants, each with a shared prompt prefix
    (its system prompt), so prefix caching and prefix-affinity routing see
    the traffic they were built for.

``generate_load(spec, seed)`` is a pure function of its arguments (numpy's
``RandomState`` only, drawn in the reference's order, so a (spec, seed)
gives the reference's trace byte for byte), and :func:`replay` drives a
trace through ``submit()`` / ``step()`` ticks, brackets the request log
with ``mark()`` and returns the outputs, the goodput report and the run's
structural ``timeline_signature``.  Two identical-seed replays on
identically configured engines give the same signature and the same
tokens; ``python -m paddle_tpu_torch.serving.loadgen --smoke`` checks
exactly that, and the step's build budget, in four engine modes, the
fleet simulator and the multihost plane (over loopback transports: a
worker killed mid-trace, federated metrics and clocks, draft-model
speculation): the CI hook.  It runs on the card unless the caller asks
for the CPU (``--device cpu``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import observability as _obs

__all__ = ["LoadRequest", "LoadSpec", "generate_load", "replay"]


@dataclasses.dataclass
class LoadRequest:
    """One request of a generated trace."""

    index: int                  # position in the trace (stable id)
    arrival: float              # arrival time, in scheduler ticks
    tenant: int                 # which shared-prefix population
    prompt: np.ndarray          # (plen,) int32, the tenant prefix included
    max_new_tokens: int


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Everything that shapes a trace; with the seed, it IS the trace."""

    n_requests: int = 16
    vocab: int = 256

    # arrival process (tick time)
    arrival: str = "poisson"            # "poisson" | "bursty"
    mean_gap: float = 1.0               # poisson: mean inter-arrival gap
    burst_on: float = 4.0               # bursty: window of dense arrivals
    burst_off: float = 16.0             # bursty: silent gap between windows
    burst_gap: float = 0.25             # bursty: mean gap inside a window

    # prompt length mix
    prompt_dist: str = "lognormal"      # "lognormal" | "zipf"
    prompt_median: float = 32.0         # lognormal median
    prompt_sigma: float = 0.6           # lognormal log-space sigma
    prompt_buckets: Tuple[int, ...] = (8, 16, 32, 64, 128)
    prompt_zipf_a: float = 1.2          # bucket rank exponent
    prompt_min: int = 2
    prompt_max: int = 128

    # output length mix (the same knobs, values of its own)
    output_dist: str = "lognormal"
    output_median: float = 16.0
    output_sigma: float = 0.6
    output_buckets: Tuple[int, ...] = (4, 8, 16, 32, 64)
    output_zipf_a: float = 1.2
    output_min: int = 2
    output_max: int = 64

    # tenant population: Zipf-popular tenants sharing a prompt prefix
    tenants: int = 1
    tenant_zipf_a: float = 1.2
    shared_prefix_len: int = 0


def _lengths(rng: np.random.RandomState, n: int, dist: str,
             median: float, sigma: float, buckets: Sequence[int],
             zipf_a: float, lo: int, hi: int) -> np.ndarray:
    if dist == "lognormal":
        vals = np.exp(rng.normal(np.log(median), sigma, n))
    elif dist == "zipf":
        ranks = np.arange(1, len(buckets) + 1, dtype=np.float64)
        p = ranks ** -zipf_a
        p /= p.sum()
        vals = np.asarray(buckets)[rng.choice(len(buckets), n, p=p)]
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.clip(np.round(vals).astype(np.int64), lo, hi)


def _arrivals(rng: np.random.RandomState, spec: LoadSpec) -> np.ndarray:
    n = spec.n_requests
    if spec.arrival == "poisson":
        return np.cumsum(rng.exponential(spec.mean_gap, n))
    if spec.arrival != "bursty":
        raise ValueError(f"unknown arrival process {spec.arrival!r}")
    # on / off: fill each window with exponential gaps until its
    # ``burst_on`` budget is spent, then jump ``burst_off``
    out = np.empty((n,))
    t = window_start = 0.0
    for i in range(n):
        t += float(rng.exponential(spec.burst_gap))
        if t - window_start > spec.burst_on:
            window_start = window_start + spec.burst_on + spec.burst_off
            t = window_start + float(rng.exponential(spec.burst_gap))
        out[i] = t
    return out


def generate_load(spec: LoadSpec, seed: int = 0) -> List[LoadRequest]:
    """Materialise a trace: deterministic in (spec, seed), independent of
    any engine or device state."""
    rng = np.random.RandomState(seed)
    arrivals = _arrivals(rng, spec)
    plens = _lengths(rng, spec.n_requests, spec.prompt_dist,
                     spec.prompt_median, spec.prompt_sigma,
                     spec.prompt_buckets, spec.prompt_zipf_a,
                     spec.prompt_min, spec.prompt_max)
    olens = _lengths(rng, spec.n_requests, spec.output_dist,
                     spec.output_median, spec.output_sigma,
                     spec.output_buckets, spec.output_zipf_a,
                     spec.output_min, spec.output_max)
    ranks = np.arange(1, max(1, spec.tenants) + 1, dtype=np.float64)
    tp = ranks ** -spec.tenant_zipf_a
    tp /= tp.sum()
    tenants = rng.choice(len(ranks), spec.n_requests, p=tp)
    prefixes = rng.randint(0, spec.vocab,
                           (max(1, spec.tenants),
                            max(0, spec.shared_prefix_len))
                           ).astype(np.int32)
    load: List[LoadRequest] = []
    for i in range(spec.n_requests):
        body = rng.randint(0, spec.vocab, int(plens[i])).astype(np.int32)
        prompt = np.concatenate([prefixes[int(tenants[i])], body])
        load.append(LoadRequest(index=i, arrival=float(arrivals[i]),
                                tenant=int(tenants[i]), prompt=prompt,
                                max_new_tokens=int(olens[i])))
    return load


def replay(target, load: Sequence[LoadRequest],
           max_ticks: Optional[int] = None) -> Dict[str, Any]:
    """Drive a trace through ``target`` (a ServingEngine, a ReplicaRouter
    or a FleetSim): each loop iteration submits every request whose
    arrival tick has come, then runs one ``step()``, until the trace is
    exhausted and the target is idle.  Arrival time is tick time, so the
    schedule is the same however fast the device steps.

    Returns the outputs (trace order; None = rejected: ``submit`` raised
    ``ValueError``), the segment's goodput report against the deadlines
    recorded at submit, the structural timeline signature, the engines'
    step builds (``step_traces``) and cost-model reports, and the request
    log's ``(mark, end_mark]`` bracket of the run."""
    log = _obs.get_request_log()
    mark = log.mark()
    engines = list(getattr(target, "engines", [target]))

    def busy() -> bool:
        # pending_held: requests parked in a router's hold queue, which
        # no engine sees
        return bool(getattr(target, "pending_held", 0)) or any(
            e.queue_depth or e.num_active or e.num_pending
            or getattr(e, "num_preempted", 0) for e in engines)

    order = sorted(range(len(load)),
                   key=lambda i: (load[i].arrival, load[i].index))
    rids: Dict[int, int] = {}           # trace index -> target rid
    rejected = 0
    tick = 0
    nxt = 0
    t0 = time.perf_counter()
    while nxt < len(order) or busy():
        while nxt < len(order) and load[order[nxt]].arrival <= tick:
            r = load[order[nxt]]
            try:
                rids[r.index] = target.submit(
                    r.prompt, max_new_tokens=r.max_new_tokens)
            except ValueError:
                rejected += 1
            nxt += 1
        target.step()
        tick += 1
        if max_ticks is not None and tick >= max_ticks:
            break
    wall = time.perf_counter() - t0
    end_mark = log.mark()
    outputs = [target.result(rids[r.index]) if r.index in rids else None
               for r in load]
    generated = sum(len(o) for o in outputs if o)
    return {
        "requests": len(load),
        "rejected": rejected,
        "ticks": tick,
        "wall_s": wall,
        "outputs": outputs,
        "generated_tokens": generated,
        "step_traces": [int(getattr(e, "step_traces", 0))
                        for e in engines],
        "slo": log.slo_report(since_uid=mark, until_uid=end_mark,
                              wall_s=wall),
        "signature": log.timeline_signature(since_uid=mark,
                                            until_uid=end_mark),
        "perf": [e.perf_report() for e in engines
                 if hasattr(e, "perf_report")],
        "mark": mark,
        "end_mark": end_mark,
    }


# -- the CI smoke -----------------------------------------------------------

#: the smoke's engine modes, as the reference's: the wave engine, the
#: chunked one, a paged int8-KV pool, and a pool too tight for the trace
#: to stay resident, so the preemptive scheduler swaps through the host
#: tier
SMOKE_MODES = {
    "wave": {},
    "chunked": {"chunked": True, "prefill_chunk": 8},
    "int8_paged": {"paged": True, "block_len": 16,
                   "kv_cache_dtype": "int8"},
    "saturated": {"paged": True, "block_len": 8, "num_blocks": 12,
                  "preempt": "swap", "host_blocks": 32},
}


def smoke_spec() -> LoadSpec:
    """The smoke's trace: 8 requests, Zipf prompts of 8-48 tokens behind
    two tenants' 4-token prefixes, 3-10 new tokens."""
    return LoadSpec(n_requests=8, arrival="poisson", mean_gap=1.5,
                    prompt_dist="zipf", prompt_buckets=(8, 16, 32, 48),
                    prompt_zipf_a=1.1, prompt_max=48,
                    output_dist="lognormal", output_median=6.0,
                    output_sigma=0.4, output_min=3, output_max=10,
                    tenants=2, shared_prefix_len=4)


def _smoke(device=None, clock_gates: bool = True) -> int:
    """The tiny seeded trace against the four engine modes, each replayed
    twice on fresh engines on ``device`` (default: the card), then the
    fleet simulator's, multihost, federated and draft-model legs: a
    non-zero exit on a step build past budget 1, on any drift (signature,
    outputs, the cost model's predicted side or, saturated, the
    preemption decisions) between the identical-seed runs, on a drift
    finding or perf anomaly, or on a saturated pool that preempted
    nothing.  The reference's lint and kernel pre-flight gates wait for
    ROADMAP A11 (the port has no static analysis); the summary says so.

    ``clock_gates=False`` reports the gates that read the host's wall
    clock (drift findings and perf anomalies, which come from measured /
    predicted tick times) without failing on them, and compares the
    perf signatures without their drift count: a run beside other work
    on the host's cores sees its ticks slow down and speed up as that
    work comes and goes, so those gates say nothing there.  The command
    line keeps them (``main``)."""
    import json

    from .. import default_device
    from ..models import LlamaForCausalLM, tiny_llama_config
    from .engine import ServingEngine

    device = default_device(device)
    model = LlamaForCausalLM(tiny_llama_config(), device=device, seed=7)
    model.eval()
    load = generate_load(smoke_spec(), seed=11)
    failures: List[str] = []
    summary: Dict[str, Any] = {
        "device": str(device), "requests": len(load),
        "lint": "waits for ROADMAP A11 (the port has no static analysis)",
        "clock_gates": "held" if clock_gates else "reported, not gated"}
    for mode, kw in SMOKE_MODES.items():
        runs = []
        preempt_sigs: List[str] = []
        preemptions: List[int] = []
        for _ in range(2):
            eng = ServingEngine(model, num_slots=4, max_length=128,
                                prefill_batch=2, device=device, **kw)
            runs.append(replay(eng, load))
            if mode == "saturated":
                preempt_sigs.append(eng.preempt_signature())
                preemptions.append(sum(
                    eng.metrics()["preempt"]["preemptions"].values()))
        a, b = runs
        traces = max(max(r["step_traces"]) for r in runs)
        if traces > 1:
            failures.append(f"{mode}: step rebuilt (traces={traces})")
        if a["signature"] != b["signature"]:
            failures.append(f"{mode}: timeline signature drift between "
                            f"identical-seed runs")
        if a["outputs"] != b["outputs"]:
            failures.append(f"{mode}: sampled-output drift between "
                            f"identical-seed runs")
        perf_sigs = []
        drift_findings = 0
        anomalies = 0
        for r in (a, b):
            for rep in r.get("perf", []):
                if not rep.get("enabled", False):
                    continue
                perf_sigs.append(_obs.perf_signature(
                    rep if clock_gates else dict(rep, drift=[])))
                drift_findings += len(rep.get("drift", []))
                anomalies += sum(rep.get("anomalies", {}).values())
        if drift_findings and clock_gates:
            failures.append(f"{mode}: {drift_findings} cost-model drift "
                            f"finding(s) on a deterministic trace")
        if anomalies and clock_gates:
            failures.append(f"{mode}: {anomalies} serving.perf_anomalies "
                            f"detection(s) on a deterministic trace")
        if len(set(perf_sigs)) > 1:
            failures.append(f"{mode}: perf_report predicted-side drift "
                            f"between identical-seed runs")
        if mode == "saturated":
            if not all(preemptions):
                failures.append(
                    "saturated: the tight pool preempted nothing: the "
                    "mode is not exercising the scheduler")
            if len(set(preempt_sigs)) > 1:
                failures.append(
                    "saturated: preemption-decision signature drift "
                    "between identical-seed runs")
        summary[mode] = {
            "ticks": a["ticks"],
            "generated_tokens": a["generated_tokens"],
            "step_traces": traces,
            "goodput": a["slo"]["goodput"],
            "perf_drift_findings": drift_findings,
            "perf_anomalies": anomalies,
            "perf_deterministic": len(set(perf_sigs)) <= 1,
            "deterministic": (a["signature"] == b["signature"]
                              and a["outputs"] == b["outputs"])}
        if mode == "saturated":
            summary[mode]["preemptions"] = preemptions
            summary[mode]["preempt_signature_stable"] = (
                len(set(preempt_sigs)) <= 1)
    summary["fleet_sim"] = _smoke_fleet_sim(model, load, failures, device)
    summary["multihost"] = _smoke_multihost(model, load, failures, device)
    summary["federated"] = _smoke_federated(model, load, failures, device)
    summary["spec_model"] = _smoke_spec_model(model, load, failures, device)
    summary["failures"] = failures
    print(json.dumps(summary, indent=2))
    return 1 if failures else 0


def _smoke_fleet_sim(model, load: Sequence[LoadRequest],
                     failures: List[str], device) -> Dict[str, Any]:
    """The fleet simulator's two gates: the same trace through a real
    paged engine and a SimEngine cloned from its cost model gives the
    SAME schedule (ticks, token counts, timeline signature, goodput:
    exact, since the scheduler is shared code and a pure function of its
    state); and a small multi-replica heavy-tail scenario replayed twice
    gives the same fleet signature."""
    from . import fleet_sim as _fs
    from .engine import ServingEngine

    kw = dict(num_slots=4, max_length=128, prefill_batch=2,
              block_len=16)
    eng = ServingEngine(model, paged=True, device=device, **kw)
    spec = _fs.SimSpec.from_engine(eng)
    er = replay(eng, load)
    sr = replay(_fs.SimEngine(spec, **kw), load)
    agree = {
        "ticks": (er["ticks"], sr["ticks"]),
        "token_counts_equal": (
            [len(o) if o else 0 for o in er["outputs"]]
            == [len(o) if o else 0 for o in sr["outputs"]]),
        "signature_equal": er["signature"] == sr["signature"],
        "goodput": (er["slo"]["goodput"], sr["slo"]["goodput"]),
    }
    if er["ticks"] != sr["ticks"]:
        failures.append(
            f"fleet_sim: tick-count disagreement with the real engine "
            f"({er['ticks']} vs {sr['ticks']})")
    if not agree["token_counts_equal"]:
        failures.append(
            "fleet_sim: per-request token counts disagree with the "
            "real engine on the shared trace")
    if not agree["signature_equal"]:
        failures.append(
            "fleet_sim: structural timeline disagrees with the real "
            "engine on the shared trace")
    if er["slo"]["goodput"] != sr["slo"]["goodput"]:
        failures.append(
            f"fleet_sim: goodput disagreement with the real engine "
            f"({er['slo']['goodput']} vs {sr['slo']['goodput']})")
    sigs = [
        _fs.run_fleet(requests=300, replicas=4, num_slots=4,
                      admission="predictive", seed=5)["signature"]
        for _ in range(2)]
    if len(set(sigs)) != 1:
        failures.append("fleet_sim: fleet signature drift between "
                        "identical-seed replays")
    return dict(agree, fleet_signature_stable=len(set(sigs)) == 1)


def _loopback_plane(workers_kw, device, clock=None, server_clocks=None):
    """A prefix-routed loopback plane over fresh port engines on
    ``device``: one
    ``(name, model, engine kwargs)`` a worker.  ``clock`` replaces each
    engine's SLO clock, ``server_clocks`` (name -> clock in ms) each
    transport's worker clock.  Returns (plane, engines)."""
    from collections import OrderedDict

    from .engine import ServingEngine
    from .multihost import EngineWorker, LoopbackTransport, MultiHostRouter

    workers = OrderedDict()
    engines = []
    for name, model, kw in workers_kw:
        eng = ServingEngine(model, device=device, **kw)
        if clock is not None:
            eng._clock = clock
        engines.append(eng)
        w = EngineWorker(eng, name=name)
        workers[name] = LoopbackTransport(
            w.handle, name=name,
            server_clock=(server_clocks or {}).get(name))
    return MultiHostRouter(workers, policy="prefix"), engines


#: the multihost legs' engines: paged, 8-token blocks
_MH_KW = dict(num_slots=4, max_length=128, prefill_batch=2, paged=True,
              block_len=8)


def _smoke_multihost(model, load: Sequence[LoadRequest],
                     failures: List[str], device) -> Dict[str, Any]:
    """The multihost plane over ``LoopbackTransport`` (the whole RPC
    serialisation, no processes), as the reference's leg (:437):

    * the trace replayed twice through a plane over two engine workers
      keeps the build budget (``step_traces`` <= 1) and replays stably
      (timeline signature and sampled outputs);
    * a worker killed mid-trace neither hangs nor drops work: every
      request finishes, token-identical to the replay without the kill,
      each under its one lifecycle uid.

    The reference's lint gate waits for ROADMAP A11."""
    # the modes above built about a dozen engines, whose per-engine
    # children sit near the metrics_max_children cap; a coalesced
    # {overflow} child would merge build counts across engines, so this
    # leg starts on a clean registry (replay brackets the request log with
    # mark(); nothing above reads the registry later)
    _obs.reset()
    spec = [(f"w{i}", model, _MH_KW) for i in range(2)]
    runs = []
    for _ in range(2):
        plane, _ = _loopback_plane(spec, device)
        runs.append(replay(plane, load))
    a, b = runs
    traces = max(max(r["step_traces"]) for r in runs)
    if traces > 1:
        failures.append(f"multihost: step rebuilt (traces={traces})")
    if a["signature"] != b["signature"]:
        failures.append("multihost: timeline signature drift between "
                        "identical-seed runs")
    if a["outputs"] != b["outputs"]:
        failures.append("multihost: sampled-output drift between "
                        "identical-seed runs")

    # the kill leg: the same trace, one transport killed mid-flight
    plane, _ = _loopback_plane(spec, device)
    order = sorted(range(len(load)),
                   key=lambda i: (load[i].arrival, load[i].index))
    rids: Dict[int, int] = {}
    tick = 0
    nxt = 0
    killed = False
    while nxt < len(order) or any(not r.done
                                  for r in plane._reqs.values()):
        while nxt < len(order) and load[order[nxt]].arrival <= tick:
            r = load[order[nxt]]
            rids[r.index] = plane.submit(
                r.prompt, max_new_tokens=r.max_new_tokens)
            nxt += 1
        plane.step()
        tick += 1
        if not killed and tick >= 3:
            victim = next((plane.worker_of(rid) for rid in rids.values()
                           if plane.worker_of(rid) is not None), None)
            if victim is not None:
                plane._workers[victim].kill()
                killed = True
    if not killed:
        failures.append("multihost: kill leg never found a placed "
                        "request to orphan")
    kill_outputs = [plane.result(rids[r.index])
                    if r.index in rids else None for r in load]
    finished_all = all(o is not None and len(o) > 0 for o in kill_outputs)
    if not finished_all:
        failures.append("multihost: killed worker left unfinished "
                        "requests (failover hang)")
    if kill_outputs != a["outputs"]:
        failures.append("multihost: post-kill outputs drifted from the "
                        "no-kill replay (recompute from the prefix broke "
                        "token identity)")
    one_timeline = all(
        _obs.get_request_log().event_names(
            plane.request_uid(rid)).count("submitted") == 1
        for rid in rids.values())
    if not one_timeline:
        failures.append("multihost: a failed-over request forked its "
                        "lifecycle timeline (uid not threaded)")
    return {
        "ticks": a["ticks"],
        "generated_tokens": a["generated_tokens"],
        "step_traces": traces,
        "deterministic": (a["signature"] == b["signature"]
                          and a["outputs"] == b["outputs"]),
        "kill": {"fired": killed,
                 "lost_workers": len(plane.lost_workers),
                 "failovers": int(
                     plane.metrics()["aggregate"]["failovers"]),
                 "finished_all": finished_all,
                 "outputs_match_no_kill": kill_outputs == a["outputs"],
                 "one_timeline_per_uid": one_timeline},
    }


def _smoke_federated(model, load: Sequence[LoadRequest],
                     failures: List[str], device) -> Dict[str, Any]:
    """The federated observability layer over a two-worker loopback plane
    under injected clocks, as the reference's leg (:556): every time
    source (the request log, the engines, the transports' worker clocks)
    reads one virtual counter, the worker side at a fixed skew each, so
    the NTP-style estimator has work to do:

    * the federated ``/metrics`` counter totals equal the sum of the
      workers' (engine-scoped) registry series exactly;
    * each transport's recovered clock offset lies within the least-RTT
      bound of its injected skew;
    * the merged timeline is Perfetto JSON with the plane's track, both
      workers' process tracks, ``rpc.call`` slices split into wire and
      in-worker time, and request hop tracks;
    * the fleet-obs signature is stable across two identical-seed runs;
    * one HTTP GET each of ``/metrics`` and ``/fleet`` serves the
      federated exposition and a healthy roster with heartbeat ages
      exact to the tick."""
    import json
    import urllib.request

    from ..observability.http_exposition import ExpositionServer

    # as the multihost leg: engines near the cardinality cap would
    # coalesce, and a coalesced registry breaks the exact federated totals
    _obs.reset()
    log = _obs.get_request_log()
    skews = {"w0": 37.0, "w1": -53.0}       # ms the worker clock leads
    out: Dict[str, Any] = {"skews_ms": dict(skews)}

    def run_once(http_leg: bool) -> Dict[str, Any]:
        saved_clock, saved_t0 = log._clock, log._t0
        cell = {"t": 0.0}

        def vclock() -> float:              # virtual seconds; each read
            cell["t"] += 1e-4               # advances 0.1 ms
            return cell["t"]

        log._clock, log._t0 = vclock, 0.0
        try:
            plane, engines = _loopback_plane(
                [(f"w{i}", model, _MH_KW) for i in range(2)], device,
                clock=vclock,
                server_clocks={n: (lambda s=s: log.now_ms() + s)
                               for n, s in skews.items()})
            rep = replay(plane, load)
            r: Dict[str, Any] = {"ticks": rep["ticks"]}

            # federated totals == the sum of the workers' registry series
            merged = plane.federation().merged()
            eids = {str(e._eid) for e in engines}
            proc = _obs.snapshot()
            bad = []
            n_counters = 0
            for name, fam in merged.items():
                if name in ("schema_version", "workers") \
                        or fam["type"] != "counter":
                    continue
                n_counters += 1
                want = sum(float(row["value"])
                           for row in proc[name]["series"]
                           if str(row["labels"].get("engine", ""))
                           in eids)
                got = float(fam["pooled"]["value"])
                if got != want:
                    bad.append(f"{name}: federated {got} != sum of "
                               f"worker registries {want}")
            if not n_counters:
                bad.append("no counter families federated at all")
            if bad:
                failures.append("federated: " + "; ".join(bad))
            r["counter_families"] = n_counters
            r["counter_totals_equal"] = not bad

            # recovered offsets within the least-RTT bound of the skew
            offs = {}
            for n, t in plane._workers.items():
                est = t.stitch.estimator
                err = abs(est.offset_ms - skews[n])
                offs[n] = {"offset_ms": round(est.offset_ms, 6),
                           "error_ms": round(err, 6),
                           "bound_ms": round(est.error_bound_ms, 6)}
                if not est.ready or err > est.error_bound_ms + 1e-9:
                    failures.append(
                        f"federated: {n} recovered offset "
                        f"{est.offset_ms} is outside the min-RTT bound "
                        f"of the injected skew {skews[n]}")
            r["offsets"] = offs

            # one merged, valid Perfetto timeline with every track kind
            trace = plane.export_merged_perfetto(
                since_uid=rep["mark"], until_uid=rep["end_mark"])
            json.dumps(trace)
            evs = trace["traceEvents"]
            procs = {e["args"]["name"] for e in evs
                     if e.get("name") == "process_name"}
            structure = {
                "worker_tracks": {"paddle_tpu worker w0",
                                  "paddle_tpu worker w1"} <= procs,
                "plane_track": "paddle_tpu plane" in procs,
                "rpc_split": (
                    any(str(e.get("name", "")).startswith("rpc.call:")
                        for e in evs)
                    and any(e.get("name") == "wire" for e in evs)
                    and any(e.get("name") == "in_worker" for e in evs)),
                "request_tracks": any(
                    str(e.get("name", "")).startswith("on w")
                    for e in evs)}
            if not all(structure.values()):
                failures.append(
                    f"federated: merged timeline is missing tracks: "
                    f"{[k for k, v in structure.items() if not v]}")
            r["merged_timeline"] = structure

            # heartbeat ages exact to the tick, and a live roster
            fleet = plane.fleet_report()
            hb = plane._hb_every
            exp_age = plane._ticks - hb * ((plane._ticks - 1) // hb)
            ages = {n: w["heartbeat_age_ticks"]
                    for n, w in fleet["workers"].items()}
            if not all(w["alive"] for w in fleet["workers"].values()):
                failures.append("federated: a loopback worker reported "
                                "dead on a clean run")
            if any(a != exp_age for a in ages.values()):
                failures.append(
                    f"federated: heartbeat ages {ages} are not exact to "
                    f"the tick (expected {exp_age} after "
                    f"{plane._ticks} ticks, heartbeat_every={hb})")
            r["heartbeat_age_ticks"] = ages

            r["signature"] = plane.fleet_obs_signature(
                since_uid=rep["mark"], until_uid=rep["end_mark"])

            if http_leg:
                with ExpositionServer(port=-1, engines=[plane]) as srv:
                    base = f"http://127.0.0.1:{srv.port}"
                    text = urllib.request.urlopen(
                        base + "/metrics", timeout=10).read().decode()
                    fl = json.loads(urllib.request.urlopen(
                        base + "/fleet", timeout=10).read().decode())
                http_ok = {
                    "metrics_has_fleet_prefix":
                        "paddle_tpu_fleet_" in text,
                    "metrics_has_worker_labels":
                        'worker="w0"' in text and 'worker="w1"' in text,
                    "fleet_reports_both_workers": all(
                        fl["workers"].get(n, {}).get("alive")
                        for n in ("w0", "w1"))}
                if not all(http_ok.values()):
                    failures.append(
                        f"federated: HTTP exposition gaps: "
                        f"{[k for k, v in http_ok.items() if not v]}")
                r["http"] = http_ok
            return r
        finally:
            log._clock, log._t0 = saved_clock, saved_t0

    a = run_once(http_leg=True)
    b = run_once(http_leg=False)
    if a["signature"] != b["signature"]:
        failures.append("federated: fleet-obs signature drift between "
                        "identical-seed replays")
    out.update(a)
    out["signature_stable"] = a["signature"] == b["signature"]
    return out


def _smoke_spec_model(model, load: Sequence[LoadRequest],
                      failures: List[str], device) -> Dict[str, Any]:
    """Draft-model speculation, as the reference's leg (:739): the trace
    replayed twice through a two-worker loopback plane with mixed
    drafters (worker w0 a one-layer draft model, w1 the n-gram drafter)
    keeps both build budgets (the verify step and the draft step, one
    build each), replays stably (timeline signature and sampled outputs),
    and the draft-model worker proposes tokens.  The reference's lint and
    per-shard kernel pre-flight gates wait for ROADMAP A11."""
    from ..models import draft_model_from

    # a fresh registry: this leg reads its own engines' build budgets
    # (as the multihost leg)
    _obs.reset()
    dm = draft_model_from(model, num_layers=1)
    kw = dict(num_slots=4, max_length=128, prefill_batch=2,
              spec_decode=True, spec_k=3)
    spec = [("w0", model, dict(kw, drafter="model", draft_model=dm)),
            ("w1", model, dict(kw, drafter="ngram"))]
    runs = []
    draft_traces = 0
    drafted: Dict[str, int] = {}
    for _ in range(2):
        plane, engines = _loopback_plane(spec, device)
        runs.append(replay(plane, load))
        for e in engines:
            by = e.metrics().get("spec", {}).get("by_drafter", {})
            for kind, m in by.items():
                drafted[kind] = (drafted.get(kind, 0)
                                 + m["drafted_tokens"])
            d = e._drafter
            if getattr(d, "uses_device", False):
                draft_traces = max(draft_traces, d.draft_traces)
    a, b = runs
    traces = max(max(r["step_traces"]) for r in runs)
    if traces > 1:
        failures.append(f"spec_model: verify step rebuilt "
                        f"(traces={traces})")
    if draft_traces > 1:
        failures.append(f"spec_model: draft step rebuilt "
                        f"(traces={draft_traces})")
    if a["signature"] != b["signature"]:
        failures.append("spec_model: timeline signature drift between "
                        "identical-seed runs")
    if a["outputs"] != b["outputs"]:
        failures.append("spec_model: sampled-output drift between "
                        "identical-seed runs")
    if drafted.get("model", 0) <= 0:
        failures.append("spec_model: the draft-model replica proposed "
                        "nothing: the mode is not exercising the drafter")
    return {
        "ticks": a["ticks"],
        "generated_tokens": a["generated_tokens"],
        "step_traces": traces,
        "draft_step_traces": draft_traces,
        "drafted_tokens_by_kind": dict(sorted(drafted.items())),
        "deterministic": (a["signature"] == b["signature"]
                          and a["outputs"] == b["outputs"]),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.loadgen",
        description="trace-driven serving load harness")
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny seeded trace against four engine modes, "
                         "the fleet simulator and the multihost plane; "
                         "exits non-zero on a "
                         "step rebuild or any drift between identical-"
                         "seed runs (the CI hook)")
    ap.add_argument("--device", default=None,
                    help="where the smoke's engines run (default: the "
                         "card; 'cpu' to run without one)")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.device)
    ap.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
