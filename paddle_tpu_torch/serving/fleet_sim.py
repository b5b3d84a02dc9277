"""Device-free fleet simulator: the REAL control plane on a cost-model
clock (mirrors ``paddle_tpu/serving/fleet_sim.py``).

:class:`SimEngine` is a :class:`~paddle_tpu_torch.serving.engine.
ServingEngine` with the device taken out and nothing else replaced: the
same ``submit`` / ``step`` / ``drain`` scheduler, paged admission
(``_admit_paged``), :class:`~paddle_tpu_torch.serving.kv_cache.
BlockManager` pool (prefix trie, reservations, host tier), preemption and
predictive admission gate.  Each step the engine would run is replaced by
the roofline cost model's prediction for that tick, and the engine's
``_clock`` (the one time source every SLO stamp reads) returns a
simulated clock the predictions advance.  Tokens are a deterministic
hash, so a trace replays identically however fast the host runs it.

:class:`FleetSim` puts N SimEngines behind the REAL :class:`~
paddle_tpu_torch.serving.router.ReplicaRouter` (predictive admission, the
priced hold queue, elastic add / drain / retire all run the production
code), so a heavy-tail scenario of many thousands of requests over many
replicas replays in seconds of host time and answers capacity questions
(replica counts, admission policies, SLO settings) without a card.

Not modelled: build time, host-swap jitter and any measured / predicted
residual (measured IS predicted here: ratio 1.0 everywhere, the drift
detectors quiet by construction).  Sim milliseconds are the cost model's
domain: compare them with wall milliseconds only through
``FLAGS_serving_admission_calib``.  The default profile of
:func:`run_fleet` and the CLI is ``h100`` (the card the port runs on;
the reference's is its TPU's).

Unsupported engine modes raise at construction: chunked prefill and
speculative decoding change the tick structure the simulator replaces;
quantized caches change only the device bytes the spec's
``kv_token_bytes`` already captures.

CLI::

    python -m paddle_tpu_torch.serving.fleet_sim --requests 100000 \\
        --replicas 16 --admission predictive

runs the heavy-tail scenario twice and fails unless the two runs'
signatures are identical.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import flags as _flags
from ..observability import costmodel as _cm
from ..observability import tracing as _tracing
from . import loadgen as _loadgen
from .engine import ServingEngine
from .router import ReplicaRouter

__all__ = ["SimSpec", "SimEngine", "FleetSim", "fleet_load_spec",
           "run_fleet", "fleet_signature", "main"]

#: the synthesized tokens' alphabet (the reference's)
_SIM_VOCAB = 50257


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """The simulated model: the static byte / FLOP inputs of the roofline
    :class:`~paddle_tpu_torch.observability.costmodel.CostModel`, all the
    scheduler needs to know of a model."""

    name: str
    weight_bytes: int           # parameter bytes streamed a tick
    n_params: int               # dense FLOP model: 2 * N a token
    kv_token_bytes: float       # device bytes a live context token costs

    @classmethod
    def default(cls) -> "SimSpec":
        """The reference's ~940M-parameter bf16 decoder: 24 layers x 2
        (K, V) x 4 KV heads x head_dim 64 cache elements a token, 2 bytes
        each."""
        return cls(name="sim_940m", weight_bytes=1_880_000_000,
                   n_params=940_000_000,
                   kv_token_bytes=float(24 * 2 * 4 * 64 * 2))

    @classmethod
    def from_engine(cls, engine: ServingEngine) -> "SimSpec":
        """A live engine's cost-model inputs, so a SimEngine predicts what
        the engine's perf layer predicts (the sim-vs-engine gate builds
        its twin this way)."""
        if engine._perf is None:
            raise ValueError(
                "SimSpec.from_engine needs the engine's cost model: "
                "construct the engine with FLAGS_perf_model='on'")
        m = engine._perf.model
        return cls(name=f"from_engine_{engine._eid}",
                   weight_bytes=m.weight_bytes, n_params=m.n_params,
                   kv_token_bytes=m.kv_token_bytes)


class _NoStep:
    """The step a SimEngine does not have: no build, no graph, no
    replay (``step_traces`` 0, as the reference's sim counts)."""

    traces = 0
    replays = 0
    graphed = False


class SimEngine(ServingEngine):
    """ServingEngine minus the device (see the module docstring).

    The constructor does not chain to ``ServingEngine.__init__`` (there
    is no model and no step to build): it calls the engine's own
    ``_init_host_state``, so every inherited scheduler method
    (``submit``, ``step``, ``_admit_paged``, preemption, ``cancel``,
    ``metrics``, the predictive gate) finds the state it reads, and adds
    what the device would have held: numpy mirrors of the step's inputs,
    an empty cache and the cost-model clock.  Four methods are
    overridden: ``_step_inner`` and ``_prefill_wave_paged`` swap the
    dispatch for a cost-model prediction and a clock advance, and the two
    host-tier hooks count swap bytes without moving payloads."""

    def __init__(self, spec: SimSpec, *, num_slots: int = 8,
                 max_length: int = 1024, prefill_batch: int = 4,
                 seed: int = 0, block_len: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 preempt: Optional[str] = None,
                 host_blocks: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: int = 0,
                 profile: Optional[_cm.HardwareProfile] = None):
        if bool(_flags.flag("serving_chunked_prefill")):
            raise NotImplementedError(
                "SimEngine does not model chunked prefill (the mixed "
                "step's chunk cursor is a dispatch-structure feature)")
        if bool(_flags.flag("serving_spec_decode")):
            raise NotImplementedError(
                "SimEngine does not model speculative decoding (accept "
                "rates depend on real logits)")
        self.sim_spec = spec
        self.int8_weights = False
        self.device = None
        self.model = None
        self.config = None
        # the simulator is paged only: the BlockManager is the part of
        # the memory system worth simulating (blocking, prefix hits,
        # preemption, the host tier)
        self._init_host_state(
            num_slots, max_length, eos_token_id, pad_token_id,
            prefill_batch, paged=True, block_len=block_len,
            num_blocks=num_blocks, prefix_cache=prefix_cache,
            kv_cache_dtype="bf16", preempt=preempt,
            host_blocks=host_blocks, chunked=False, prefill_chunk=None,
            chunk_policy="prefill", spec_decode=False, spec_k=None)
        self._sim_block_nbytes = int(round(spec.kv_token_bytes
                                           * self.block_len))
        self.kv.set_block_nbytes({"bf16": self._sim_block_nbytes})
        # no device tensors: _leaves() is empty, so the engine's block
        # copies (copy-on-write) are pool bookkeeping alone
        self._cache: Dict[str, Any] = {}
        self._gen = None
        self._step = _NoStep()
        s = self.num_slots
        self._tokens = np.zeros((s,), np.int32)
        self._positions = np.zeros((s,), np.int32)
        self._tables = np.zeros((s, self.max_blocks), np.int32)
        self._idle_pos = 0
        self._seed = int(seed)
        # the simulated clock: every SLO stamp reads _clock(), and the
        # overridden tick bodies advance _now_s by the model's prediction
        # (sim seconds are predicted milliseconds / 1e3)
        self._now_s = 0.0
        self._clock = lambda: self._now_s
        self._cost = _cm.CostModel(
            profile or _cm.resolve_profile(),
            weight_bytes=spec.weight_bytes, n_params=spec.n_params,
            kv_token_bytes=spec.kv_token_bytes,
            num_slots=self.num_slots)
        self._perf = (_cm.TickAttribution(self._cost,
                                          engine_id=self._eid)
                      if _flags.flag("perf_model") == "on" else None)

    # -- simulated time ------------------------------------------------------

    @property
    def sim_time_s(self) -> float:
        """This replica's simulated clock (cost-model seconds)."""
        return self._now_s

    def _sim_token(self, rid: int, pos: int) -> int:
        """A pure hash of (request id, position, seed), steered off the
        EOS id, so the trace's ``max_new_tokens`` decides every length."""
        tok = (rid * 1_000_003 + pos * 10_007 + self._seed * 7_919) \
            % _SIM_VOCAB
        if self.eos_token_id is not None and tok == self.eos_token_id:
            tok = (tok + 1) % _SIM_VOCAB
        return tok

    # -- the overridden tick bodies ------------------------------------------

    def _step_inner(self) -> List[int]:
        """The engine's ``_step_inner`` with the decode step replaced by a
        prediction: the same admission, paged bookkeeping (chain growth,
        tables) and retirement; the clock advances by the tick's predicted
        milliseconds, which the perf layer records as measured (ratio
        1.0)."""
        finished = self._admit()
        occ = int(self._active.sum())
        self._set_occupancy(occ)
        if not occ:
            return finished
        self._ticks += 1
        self._n_decode_ticks += 1
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._grow_row_for_writes(i, int(self._positions[i]))
        # idle rows hold position 0, so the sum is the live depth
        live = int(self._positions.sum())
        swap_bytes, self._tick_swap_bytes = self._tick_swap_bytes, 0
        pred = self._cost.predicted_tick_ms(occ, live,
                                            swap_bytes=swap_bytes)
        self._now_s += pred / 1e3
        now = self._clock()
        self._m_step_ms.observe(pred)
        if self._perf is not None:
            self._perf.on_tick(pred, occ=occ, live_tokens=live,
                               swap_bytes=swap_bytes)
        nxt = np.full((self.num_slots,), self.pad_token_id, np.int32)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                nxt[i] = self._sim_token(slot.rid, int(self._positions[i]))
        finished.extend(self._advance_decode(nxt, now))
        return finished

    def _prefill_wave_paged(self, wave) -> List[int]:
        """The engine's paged wave minus the device: the same accounting
        and lifecycle events (``_wave_sampling``, ``_start_wave``), first
        tokens synthesized, the clock advanced by the wave priced as one
        tick whose chunk term carries the computed suffix tokens (prefix
        hits ride free, as the real wave computes suffixes only)."""
        t_adm = self._clock()
        bucket = min(max(self._bucket(req.prompt.size - m)
                         for req, _, m in wave), self.max_length)
        reqs = [req for req, _, _ in wave]
        slots = [si for _, si, _ in wave]
        computed = [int(req.prompt.size) - int(m) for req, _, m in wave]
        self._wave_sampling(reqs, slots, [m for _, _, m in wave], computed,
                            bucket, t_adm)
        suffix_tokens = sum(computed)
        pred = self._cost.predicted_tick_ms(
            len(wave), suffix_tokens, chunk_tokens=suffix_tokens)
        self._now_s += pred / 1e3
        tok = np.asarray([self._sim_token(req.request_id,
                                          int(req.prompt.size))
                          for req in reqs], np.int32)
        return self._start_wave(reqs, slots,
                                [int(req.prompt.size) for req in reqs],
                                tok, t_adm)

    # -- the host-tier hooks (byte accounting only) --------------------------

    def _host_swap_out(self, pairs) -> None:
        tier = self.kv.host_tier
        for bid, hid in pairs:
            tier.put(hid, None)          # the payload is virtual
            self._tick_swap_bytes += self._sim_block_nbytes
            self._m_swap_out_bytes.inc(self._sim_block_nbytes)

    def _host_swap_in(self, pairs) -> None:
        for hid, bid in pairs:
            self._tick_swap_bytes += self._sim_block_nbytes
            self._m_swap_in_bytes.inc(self._sim_block_nbytes)


class FleetSim:
    """N SimEngine replicas behind the real ReplicaRouter (the router's
    ``submit`` / ``step`` / ``drain`` / ``result`` surface, so
    ``loadgen.replay`` drives it unchanged).  Each replica's clock
    advances on its own (replicas tick in lockstep, a loaded replica's
    tick costs more); the fleet's simulated wall is the slowest clock."""

    def __init__(self, num_replicas: int = 16,
                 spec: Optional[SimSpec] = None, *,
                 policy: Optional[str] = None, seed: int = 0,
                 **engine_kwargs: Any):
        self.spec = spec or SimSpec.default()
        self.engines = [SimEngine(self.spec, seed=seed + i,
                                  **engine_kwargs)
                        for i in range(int(num_replicas))]
        self.router = ReplicaRouter(engines=self.engines, policy=policy)

    def submit(self, *a: Any, **kw: Any) -> int:
        return self.router.submit(*a, **kw)

    def step(self) -> List[int]:
        return self.router.step()

    def drain(self):
        return self.router.drain()

    def result(self, rid: int) -> List[int]:
        return self.router.result(rid)

    @property
    def pending_held(self) -> int:
        return self.router.pending_held

    @property
    def sim_wall_s(self) -> float:
        """The fleet's simulated wall: the slowest replica's clock."""
        return max(e.sim_time_s for e in self.engines)

    def worker_clocks(self) -> Dict[str, float]:
        """Each replica's simulated clock in ms, keyed ``replica<i>``."""
        return {f"replica{i}": round(e.sim_time_s * 1e3, 6)
                for i, e in enumerate(self.engines)}

    def slo_by_worker(self, slo: Dict[str, Any]) -> Dict[str, Any]:
        """A replay report's ``by_worker`` SLO attribution re-keyed from
        ``engine:<id>`` onto the run-stable ``replica<i>``."""
        eid_to_replica = {f"engine:{e._eid}": f"replica{i}"
                          for i, e in enumerate(self.engines)}
        byw = slo.get("by_worker") or {}
        return {eid_to_replica.get(k, k): v
                for k, v in sorted(byw.items())}

    def report(self) -> Dict[str, Any]:
        return {
            "spec": dataclasses.asdict(self.spec),
            "replicas": len(self.engines),
            "sim_wall_s": round(self.sim_wall_s, 6),
            "per_replica": [
                {"ticks": e._ticks,
                 "sim_time_s": round(e.sim_time_s, 6),
                 "requests_finished": int(e._m_finished.value()),
                 "tokens_generated": int(e._m_tokens.value())}
                for e in self.engines],
            "router": self.router.metrics()["aggregate"]["control_plane"],
        }


def fleet_signature(fleet: FleetSim,
                    replay_report: Dict[str, Any]) -> str:
    """SHA-256 over the deterministic state of one fleet replay: the
    structural request timeline, each replica's ticks, simulated clock,
    preemption decisions and perf signature, the router's decisions and
    the outputs.  Engine / router ids and host wall times are left out,
    so two identical-seed runs in one process give the same digest."""
    body = {
        "timeline": replay_report["signature"],
        "outputs": [o if o is None else list(map(int, o))
                    for o in replay_report["outputs"]],
        "per_replica": [
            {"ticks": e._ticks,
             "clock_ms": round(e.sim_time_s * 1e3, 6),
             "preempt": e.preempt_signature(),
             "perf": (_cm.perf_signature(e._perf.report())
                      if e._perf is not None else None)}
            for e in fleet.engines],
        "decisions": fleet.router.metrics()["aggregate"]["control_plane"][
            "decisions"],
    }
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def fleet_load_spec(requests: int, *, seed_gap: float = 0.13,
                    replicas: int = 16,
                    num_slots: int = 8) -> _loadgen.LoadSpec:
    """The heavy-tail scenario: Zipf prompt / output lengths (many short
    requests, a tail out to 8x the median), Poisson arrivals just under
    the fleet's token service rate (queues loaded but bounded) and a Zipf
    tenant mix sharing prompt prefixes."""
    # service ~= replicas * num_slots tokens a fleet tick; the mean Zipf
    # output is ~14 tokens, so a gap of 0.13 ticks at 16 x 8 lands near
    # 85 % decode utilization before prefill waves take their ticks
    gap = seed_gap * (16 * 8) / max(1, replicas * num_slots)
    return _loadgen.LoadSpec(
        n_requests=int(requests), vocab=256,
        arrival="poisson", mean_gap=gap,
        prompt_dist="zipf", prompt_buckets=(8, 16, 32, 64, 224),
        prompt_zipf_a=1.1, prompt_max=224,
        output_dist="zipf", output_buckets=(4, 8, 16, 32, 64),
        output_zipf_a=1.1, output_max=64,
        tenants=8, tenant_zipf_a=1.2, shared_prefix_len=8)


def run_fleet(*, requests: int = 100_000, replicas: int = 16,
              num_slots: int = 8, max_length: int = 512,
              admission: str = "predictive", policy: str = "least_loaded",
              preempt: str = "off", host_blocks: int = 0,
              seed: int = 0, spec: Optional[SimSpec] = None,
              profile: str = "h100",
              max_ticks: Optional[int] = None) -> Dict[str, Any]:
    """One deterministic fleet replay of the heavy-tail scenario: the
    loadgen replay report's counts, the fleet report and the run's
    :func:`fleet_signature`.  The flags it sets are restored on exit."""
    saved = {k: _flags.flag(k) for k in
             ("serving_admission", "perf_model", "request_log_max_requests",
              "serving_chunked_prefill", "serving_spec_decode")}
    # a bounded request log: the rolling window covers the trace's tail
    _flags.set_flags({
        "serving_admission": admission,
        "perf_model": "on",
        "serving_chunked_prefill": False,
        "serving_spec_decode": False,
        "request_log_max_requests": min(8192, max(4096, requests // 8))})
    tracer = _tracing.get_tracer()
    saved_trace = tracer.enabled
    # spans at this scale are host overhead alone (the artifact is the
    # signature); the request log keeps its timeline either way
    tracer.enabled = False
    try:
        fleet = FleetSim(replicas, spec, policy=policy, seed=seed,
                         num_slots=num_slots, max_length=max_length,
                         preempt=preempt, host_blocks=host_blocks,
                         profile=_cm.PROFILES[profile])
        load = _loadgen.generate_load(
            fleet_load_spec(requests, replicas=replicas,
                            num_slots=num_slots), seed=seed)
        t0 = time.perf_counter()
        rep = _loadgen.replay(fleet, load, max_ticks=max_ticks)
        wall = time.perf_counter() - t0
        return {
            "requests": requests,
            "replicas": replicas,
            "admission": admission,
            "profile": profile,
            "ticks": rep["ticks"],
            "generated_tokens": rep["generated_tokens"],
            "rejected": rep["rejected"],
            "host_wall_s": round(wall, 3),
            "sim_wall_s": round(fleet.sim_wall_s, 3),
            "sim_tok_per_s": round(
                rep["generated_tokens"] / max(fleet.sim_wall_s, 1e-9), 3),
            "goodput": rep["slo"].get("goodput"),
            "slo_by_worker": fleet.slo_by_worker(rep["slo"]),
            "worker_clocks_ms": fleet.worker_clocks(),
            "fleet": fleet.report(),
            "signature": fleet_signature(fleet, rep),
        }
    finally:
        tracer.enabled = saved_trace
        _flags.set_flags(saved)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.fleet_sim",
        description="device-free serving fleet simulator (cost-model "
                    "clock; see the module docstring)")
    p.add_argument("--requests", type=int, default=100_000)
    p.add_argument("--replicas", type=int, default=16)
    p.add_argument("--num-slots", type=int, default=8)
    p.add_argument("--max-length", type=int, default=512)
    p.add_argument("--admission", default="predictive",
                   choices=("queue_depth", "predictive"))
    p.add_argument("--policy", default="least_loaded",
                   choices=("prefix", "least_loaded", "round_robin"))
    p.add_argument("--preempt", default="off",
                   choices=("off", "swap", "recompute"))
    p.add_argument("--host-blocks", type=int, default=0)
    p.add_argument("--profile", default="h100",
                   choices=sorted(_cm.PROFILES),
                   help="roofline profile the simulated replicas run on "
                        "(the sim clock's time domain)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--runs", type=int, default=2,
                   help="replays to run; more than 1 fails unless every "
                        "run's signature is the same")
    args = p.parse_args(argv)
    sigs: List[str] = []
    for run in range(max(1, args.runs)):
        rep = run_fleet(requests=args.requests, replicas=args.replicas,
                        num_slots=args.num_slots,
                        max_length=args.max_length,
                        admission=args.admission, policy=args.policy,
                        preempt=args.preempt, profile=args.profile,
                        host_blocks=args.host_blocks, seed=args.seed)
        sigs.append(rep["signature"])
        slim = {k: v for k, v in rep.items() if k != "fleet"}
        print(json.dumps({"run": run, **slim}, indent=2, default=str))
    if len(set(sigs)) != 1:
        print("FLEET SIM NON-DETERMINISTIC: signatures differ across "
              "identical-seed runs")
        return 1
    print(f"signature stable across {len(sigs)} run(s): {sigs[0][:16]}…")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
