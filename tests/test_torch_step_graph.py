"""The port's once-built decode step (``serving/step_graph.py``) and its
build watchdog (``observability/watchdog.py``), on the CPU.

  * the watchdog counts, warns and raises as the reference's
    ``track_retraces`` does over the same sequence of builds, under every
    ``FLAGS_retrace_watchdog`` action;
  * every engine layout builds its step once: ``step_traces`` equals the
    JAX engine's (1) after a trace with slot churn, tokens identical;
  * the replay accounting (``ops.ReplayCounts``) credits n replays with n
    times what the recorded region counted;
  * the static-buffer step computes exactly what ``model.decode_step``
    computes on fresh tensors (float32, tolerance 0);
  * a second build is a watchdog violation; a step on the card builds a
    graph or raises, and runs eagerly only inside ``disable_graphs()``.

The CUDA-graph capture itself runs only on the card: ``chip_smoke.py``
holds the graphed engines against their eager twins and the CPU engines.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import flags as jax_flags
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.observability import watchdog as jax_watchdog
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch import flags, ops
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict, quantize_for_decode)
from paddle_tpu_torch.observability import watchdog
from paddle_tpu_torch.ops import _dispatch
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import step_graph

MAXLEN = 64
BL = 8
MIN_ELEMS = 2048      # every tiny projection, not the RoPE tables


@pytest.fixture
def watchdog_action():
    """Set both packages' FLAGS_retrace_watchdog; restored after."""
    old = flags.flag("retrace_watchdog"), jax_flags.flag("retrace_watchdog")

    def set_action(action):
        flags.set_flags({"retrace_watchdog": action})
        jax_flags.set_flags({"retrace_watchdog": action})

    yield set_action
    flags.set_flags({"retrace_watchdog": old[0]})
    jax_flags.set_flags({"retrace_watchdog": old[1]})


def _outcomes(fn, error, warning, ran, n=4):
    """What each of ``n`` calls of ``fn`` did: ran the body, warned,
    raised; with the message of each warning or error."""
    out = []
    for _ in range(n):
        before = len(ran)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                fn(np.zeros((2, 3), np.float32))
                kind, msg = "built", None
            except error as e:
                kind, msg = "raised", str(e)
        warned = [str(w.message) for w in caught
                  if issubclass(w.category, warning)]
        if warned:
            kind, msg = kind + "+warned", warned[0]
        out.append((kind, len(ran) > before,
                    msg and msg.split(".  A ")[0]))
    return out


@pytest.mark.parametrize("budget", [1, 2])
@pytest.mark.parametrize("action", ["raise", "warn", "off"])
def test_watchdog_matches_reference(watchdog_action, action, budget):
    """The same build sequence through both watchdogs: the same outcome
    at every call (the body skipped exactly when raising), the same
    message head (site, build number, budget, call signature) and the
    same count."""
    watchdog_action(action)
    ran_jax, ran_port = [], []
    label = {"engine": f"parity-{action}-{budget}"}
    ref = jax_watchdog.track_retraces(lambda x: ran_jax.append(1),
                                      "serving.step", budget=budget,
                                      labels=label, jit=False)
    port = watchdog.track_retraces(lambda x: ran_port.append(1),
                                   "serving.step", budget=budget,
                                   labels=label)
    want = _outcomes(ref, jax_watchdog.RetraceError,
                     jax_watchdog.RetraceWarning, ran_jax)
    got = _outcomes(port, watchdog.RetraceError, watchdog.RetraceWarning,
                    ran_port)
    assert got == want
    assert port.traces == ref.traces == 4
    assert [k for k, _, _ in got][:budget] == ["built"] * budget
    assert len(ran_port) == len(ran_jax) == (budget if action == "raise"
                                             else 4)


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


_SYS = _prompt(9, 300)
# three requests through two slots: the third is admitted into a slot a
# retired request left (the paged ones share a 9-token prompt: one block)
_CHURN = [np.concatenate([_SYS, _prompt(3, 301)]), _prompt(6, 302),
          np.concatenate([_SYS, _prompt(5, 303)])]
LAYOUTS = {
    "contiguous": dict(),
    "paged": dict(paged=True, block_len=BL),
    "int8": dict(kv_cache_dtype="int8"),
    "int8_paged": dict(kv_cache_dtype="int8", paged=True, block_len=BL),
}


def _churn(engine):
    rids = [engine.submit(p, max_new_tokens=n)
            for p, n in zip(_CHURN, (3, 6, 4))]
    out = dict(engine.drain())
    return [out[r] for r in rids]


def _engine(tm, layout, **kw):
    return ServingEngine(tm, num_slots=2, max_length=MAXLEN,
                         prefill_batch=2, device="cpu", **LAYOUTS[layout],
                         **kw)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_step_traces_equal_jax_after_slot_churn(pair, layout):
    jm, tm = pair
    jeng = JaxEngine(jm, num_slots=2, max_length=MAXLEN, prefill_batch=2,
                     **LAYOUTS[layout])
    want = _churn(jeng)
    teng = _engine(tm, layout)
    got = _churn(teng)
    assert got == want
    m = teng.metrics()
    assert m["decode_ticks"] > 3 and m["prefill_waves"] >= 2
    assert teng.step_traces == m["step_traces"] == jeng.step_traces == 1
    assert not teng.graphed and m["graph_replays"] == 0


@pytest.mark.parametrize("replays", [1, 3])
def test_replay_counts_credit_each_replay(pair, replays):
    """A region recorded once and credited n times counts what n eager
    runs of it count — launches and routes — and the recording itself
    leaves the live counters as they were."""
    _, tm = pair

    def region():
        for name in ("decode_attention", "rms_norm", "rms_norm"):
            ops.KERNELS[name].launches += 1
        tm.decode_step(torch.zeros((2, 1), dtype=torch.int32),
                       torch.zeros((2, 2, 2, MAXLEN, 2, 16)),
                       torch.tensor([3, 5], dtype=torch.int32))

    def counts():
        return ops.launch_counts(), dict(_dispatch.kernel_paths)

    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    ops.KERNELS["int8_matmul"].launches = 7
    _dispatch.count_kernel_path("int8_matmul", "kernel")
    start = counts()
    with ops.ReplayCounts.record() as rc:
        region()
    assert counts() == start
    assert rc.launches == {"decode_attention": 1, "rms_norm": 2}
    assert rc.paths[("decode_attention", "plain")] == 2
    rc.add(replays)
    credited = counts()
    ops.reset_launch_counts()
    _dispatch.reset_kernel_paths()
    ops.KERNELS["int8_matmul"].launches = 7
    _dispatch.count_kernel_path("int8_matmul", "kernel")
    for _ in range(replays):
        region()
    assert credited == counts()


@pytest.fixture(scope="module")
def qpair(pair):
    _, tm = pair
    return quantize_for_decode(tm, min_elems=MIN_ELEMS)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_static_step_equals_decode_step(pair, qpair, layout):
    """Mid-trace (live rows at different depths, an idle row in the
    contiguous engine), one tick of the static-buffer step equals
    ``decode_step`` on fresh tensors of the same inputs over a copy of
    the cache: logits, argmax and the written cache, exactly."""
    _, tm = pair
    model = qpair if layout.startswith("int8") else tm
    eng = _engine(model, layout, int8_weights=layout.startswith("int8"))
    eng.submit(_CHURN[0], max_new_tokens=8)
    eng.submit(_CHURN[1], max_new_tokens=2)
    for _ in range(3):
        eng.step()
    assert eng.num_active >= 1
    cache = eng._cache
    copy = ({k: t.clone() for k, t in cache.items()}
            if isinstance(cache, dict) else cache.clone())
    tokens = torch.from_numpy(eng._tokens.copy())[:, None]
    positions = torch.from_numpy(eng._positions.copy())
    tables = (torch.from_numpy(eng._tables.copy()) if eng.paged else None)
    logits, greedy = eng._step.run()
    with torch.no_grad():
        want, copy = eng.model.decode_step(tokens, copy, positions,
                                           block_tables=tables)
    want = want[:, -1]
    assert logits.dtype == torch.float32
    assert torch.equal(logits, want)
    assert torch.equal(greedy, want.argmax(dim=-1))
    pairs = ([(cache[k], copy[k]) for k in cache]
             if isinstance(cache, dict) else [(cache, copy)])
    for a, b in pairs:
        assert torch.equal(a, b)


@pytest.mark.parametrize("action", ["raise", "warn", "off"])
def test_second_build_is_a_watchdog_violation(pair, watchdog_action,
                                              action):
    _, tm = pair
    watchdog_action(action)
    eng = _engine(tm, "paged")
    assert eng.step_traces == 1
    if action == "raise":
        with pytest.raises(watchdog.RetraceError, match="budget of 1"):
            eng._step.build()
    elif action == "warn":
        with pytest.warns(watchdog.RetraceWarning, match="trace #2"):
            eng._step.build()
    else:
        eng._step.build()
    assert eng.step_traces == 2
    assert _churn(eng) == _churn(_engine(tm, "paged"))


def test_card_step_captures_or_raises(pair):
    """A step on a CUDA device builds its graph or raises — here, with no
    card, the capture's first CUDA call raises and no eager step is left
    in its place — and inside ``disable_graphs()`` it builds the eager
    step without touching CUDA.  The mode is read at the build."""
    _, tm = pair
    eng = _engine(tm, "contiguous")
    step = step_graph.DecodeStep(tm, eng._cache, 2, None,
                                 torch.device("cpu"), "card-test")
    step.device = torch.device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        step.build()
    assert not step.graphed and step.traces == 1
    step = step_graph.DecodeStep(tm, eng._cache, 2, None,
                                 torch.device("cpu"), "card-test-eager")
    step.device = torch.device("cuda")
    with step_graph.disable_graphs():
        step.build()
        assert step_graph._disabled
    assert not step_graph._disabled
    assert not step.graphed and step.traces == 1
