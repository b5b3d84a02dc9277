"""The port's once-built prefill waves (``serving/step_graph.py``
``PrefillStep``) and ``prefill_traces``, on the CPU.

  * the engines are token-identical to the JAX engines (int8 KV + int8
    weights to the JAX int8 engine) on traces whose waves of one bucket
    all have the same row count, where ``prefill_traces`` — one build a
    (bucket, rows) key — equals the reference's one compilation a bucket;
  * the reference's own ``prefill_traces`` traffic
    (``tests/test_serving.py:127``) builds what the JAX engine compiles,
    at most 2; the chunked engines build none (:238, :400);
  * the static-buffer wave computes exactly what the eager wave body
    computes on fresh tensors (float32, tolerance 0): logits, argmax and
    every cache byte and scale, both layouts, bf16 and int8;
  * a repeated key is not rebuilt, and a forced rebuild is a watchdog
    violation; a wave step on the card builds a graph or raises, and a
    failed paged build leaves the staged wave as it was.

The CUDA-graph capture itself runs only on the card: ``chip_smoke.py``
holds the graphed waves against the eager twin's and the CPU engines'.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import flags as jax_flags
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.models.quantized import (
    quantize_for_decode as jax_quantize_for_decode)
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch import flags
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict, quantize_for_decode,
                                     tiny_llama_config)
from paddle_tpu_torch.models.generation import init_kv_cache
from paddle_tpu_torch.observability import watchdog
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import step_graph

MAXLEN = 64
BL = 8
MIN_ELEMS = 2048      # every tiny projection, not the RoPE tables


@pytest.fixture(scope="module")
def pair():
    pt.seed(7)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    return jm, tm


@pytest.fixture(scope="module")
def qpair(pair):
    jm, tm = pair
    return (jax_quantize_for_decode(jm, min_elems=MIN_ELEMS),
            quantize_for_decode(tm, min_elems=MIN_ELEMS))


@pytest.fixture(scope="module")
def long_models():
    """A tiny port model of 256 positions (two 128-token int8 granules a
    contiguous row) and its int8 wrapper."""
    m = LlamaForCausalLM(tiny_llama_config(max_position_embeddings=256),
                         device="cpu", seed=3)
    return m, quantize_for_decode(m, min_elems=MIN_ELEMS)


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


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


def _serve(engine, reqs):
    rids = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
    out = dict(engine.drain())
    return [out[r] for r in rids]


# four slots, two-row waves: A (bucket 8) and B (16) fill the slots; A
# retires after 3 tokens and C (8) takes its two slots; C retires before
# B and D (16) takes C's.  Every bucket's waves have two rows, so each key
# replays once.  Paged, C's first prompt opens with B's first block, so
# its suffix (3 tokens) keeps bucket 8.
_B = (_prompt(12, 402), _prompt(14, 403))
_PAIRS = {
    "A": ((_prompt(5, 400), _prompt(6, 401)), 3),
    "B": (_B, 9),
    "C": ((_prompt(7, 404), _prompt(3, 405)), 4),
    "D": ((_prompt(10, 406), _prompt(16, 407)), 6),
}
_PAGED_C = (np.concatenate([_B[0][:BL], _prompt(3, 408)]), _prompt(7, 404))


def _trace(paged):
    reqs = []
    for name in "ABCD":
        prompts, n = _PAIRS[name]
        if paged and name == "C":
            prompts = _PAGED_C
        reqs += [(p, n) for p in prompts]
    return reqs


LAYOUTS = {
    "contiguous": dict(),
    "paged": dict(paged=True, block_len=BL),
    "int8": dict(kv_cache_dtype="int8", int8_weights=True),
    "int8_paged": dict(kv_cache_dtype="int8", int8_weights=True,
                       paged=True, block_len=BL),
}


def _models(pair, qpair, layout):
    return qpair if layout.startswith("int8") else pair


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_waves_token_identical_and_traces_equal_jax(pair, qpair, layout):
    jm, tm = _models(pair, qpair, layout)
    kw = dict(num_slots=4, max_length=MAXLEN, prefill_batch=2,
              **LAYOUTS[layout])
    reqs = _trace(kw.get("paged", False))
    jeng = JaxEngine(jm, **kw)
    want = _serve(jeng, reqs)
    teng = ServingEngine(tm, device="cpu", **kw)
    got = _serve(teng, reqs)
    assert got == want
    m = teng.metrics()
    assert m["prefill_waves"] == 4
    assert sorted(teng._prefill_steps) == [(8, 2), (16, 2)]
    assert teng.prefill_traces == m["prefill_traces"] == 2
    assert teng.prefill_traces == jeng.prefill_traces
    assert m["prefill_graph_replays"] == 0       # eager on the CPU
    if teng.paged:
        assert teng.kv.stats["prefix_hit_tokens"] == BL


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_reference_mixed_length_traffic(pair, layout):
    """``tests/test_serving.py:127``'s traffic: prompts of 3, 15, 8 and
    13 tokens, four slots, ``prefill_batch=4`` — buckets 8 and 16, so at
    most two builds, and exactly the JAX engine's count."""
    jm, tm = pair
    reqs = [(_prompt(n, 40 + i), 6) for i, n in enumerate((3, 15, 8, 13))]
    kw = dict(num_slots=4, max_length=MAXLEN, prefill_batch=4,
              **LAYOUTS[layout])
    jeng = JaxEngine(jm, **kw)
    want = _serve(jeng, reqs)
    teng = ServingEngine(tm, device="cpu", **kw)
    assert _serve(teng, reqs) == want
    assert teng.prefill_traces == jeng.prefill_traces <= 2


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chunked_engine_builds_no_wave(pair, layout):
    jm, tm = pair
    kw = dict(num_slots=3, max_length=MAXLEN, chunked=True,
              prefill_chunk=8, **LAYOUTS[layout])
    reqs = [(_prompt(n, 50 + n), 5) for n in (20, 5, 9, 30)]
    jeng = JaxEngine(jm, **kw)
    want = _serve(jeng, reqs)
    teng = ServingEngine(tm, device="cpu", **kw)
    assert _serve(teng, reqs) == want
    m = teng.metrics()
    assert teng.prefill_traces == m["prefill_traces"] == 0
    assert jeng.prefill_traces == 0
    assert m["prefill_graph_replays"] == 0 and m["prefill_waves"] == 0


def _copy(cache):
    return ({k: t.clone() for k, t in cache.items()}
            if isinstance(cache, dict) else cache.clone())


def _eager_wave(model, cache, ids, last, slots=None, prefix=None,
                tables=None):
    """The eager wave body on fresh tensors: the ``pos = 0`` pass over a
    fresh scratch cache copied into the slots (contiguous; int8: whole
    granules after the slots' scales are zeroed), or the suffix pass over
    the pool (paged).  Returns the logits at ``last``."""
    n, bucket = ids.shape
    ids_t = torch.from_numpy(ids)
    if tables is not None:
        hidden, _ = model.model.decode(ids_t, cache, torch.from_numpy(prefix),
                                       block_tables=torch.from_numpy(tables))
    else:
        slots_t = torch.tensor(slots)
        if isinstance(cache, dict):
            gr = cache["kv"].shape[3] // cache["scale"].shape[3]
            ng = -(-bucket // gr)
            sub = init_kv_cache(model.config, n, ng * gr, quantized=True,
                                device="cpu")
        else:
            sub = init_kv_cache(model.config, n, bucket, device="cpu")
        hidden, sub = model.model.decode(ids_t, sub, 0)
        if isinstance(cache, dict):
            cache["scale"][:, :, slots_t] = 0.0
            cache["scale"][:, :, slots_t, :ng] = sub["scale"]
            cache["kv"][:, :, slots_t, :ng * gr] = sub["kv"]
        else:
            cache[:, :, slots_t, :bucket] = sub
    return model.logits(hidden[torch.arange(n),
                               torch.from_numpy(last).long()])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_static_wave_equals_eager_body(long_models, layout):
    """Mid-trace (two live rows holding cache, a third slot left by a
    retired 200-token prompt), one wave of two rows through its
    static-buffer step equals the eager body on fresh tensors over a copy
    of the cache: logits, argmax and the whole cache after, exactly.
    Contiguous, one row lands in the retired slot (int8: its stale second
    granule, whose scales the wave must zero).  Paged, one row adopts a
    live row's first block (prefix 8), and the other's second block of
    tokens lies past its table's one block, in the null block."""
    tm = long_models[1 if layout.startswith("int8") else 0]
    kw = dict(LAYOUTS[layout])
    eng = ServingEngine(tm, num_slots=4, max_length=256, prefill_batch=2,
                        device="cpu", **kw)
    eng.submit(_B[0], max_new_tokens=8)
    eng.submit(_B[1], max_new_tokens=8)
    eng.submit(_prompt(200, 409), max_new_tokens=1)
    for _ in range(3):
        eng.step()
    assert eng.num_active == 2 and eng._slots[2] is None
    rng = np.random.RandomState(9)
    ids = rng.randint(0, 256, (2, 16)).astype(np.int32)
    last = np.array([15, 6], np.int32)
    if eng.paged:
        nb = (eng._cache["kv"] if eng.quantized else eng._cache).shape[2]
        tables = np.zeros((2, eng.max_blocks), np.int32)
        tables[0, :3] = (eng._tables[0, 0], nb - 1, nb - 2)
        tables[1, 0] = nb - 3          # one block for 16 tokens
        inputs = dict(prefix=np.array([BL, 0], np.int32), tables=tables)
    else:
        inputs = dict(slots=np.array([3, 2], np.int32))
    copy = _copy(eng._cache)
    logits, greedy = eng._run_wave(ids, last, **inputs)
    want = _eager_wave(eng.model, copy, ids, last, **inputs)
    assert logits.dtype == torch.float32
    assert torch.equal(logits, want)
    assert torch.equal(greedy, want.argmax(dim=-1))
    pairs = ([(eng._cache[k], copy[k]) for k in copy]
             if isinstance(copy, dict) else [(eng._cache, copy)])
    for a, b in pairs:
        assert torch.equal(a, b)
    # the wave ran on the (16, 2) key the first wave built
    assert sorted(eng._prefill_steps) == [(16, 2), (256, 1)]
    assert eng.prefill_traces == 2


@pytest.mark.parametrize("action", ["raise", "warn", "off"])
def test_repeated_key_is_not_rebuilt(pair, watchdog_action, action):
    """The same lengths again on the same engine build nothing and give
    the same tokens; building a key again is a watchdog violation."""
    _, tm = pair
    watchdog_action(action)
    eng = ServingEngine(tm, num_slots=4, max_length=MAXLEN, prefill_batch=2,
                        device="cpu")
    reqs = _trace(paged=False)
    first = _serve(eng, reqs)
    assert eng.prefill_traces == 2
    assert _serve(eng, reqs) == first
    m = eng.metrics()
    assert eng.prefill_traces == 2 and m["prefill_waves"] == 8
    step = eng._prefill_steps[(8, 2)]
    if action == "raise":
        with pytest.raises(watchdog.RetraceError, match="budget of 1"):
            step.build()
    elif action == "warn":
        with pytest.warns(watchdog.RetraceWarning, match="trace #2"):
            step.build()
    else:
        step.build()
    assert step.traces == 2 and eng.prefill_traces == 3
    assert eng._prefill_steps[(16, 2)].traces == 1


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_card_wave_captures_or_raises(pair, layout):
    """A wave step on a CUDA device builds its graph or raises — here,
    with no card, the capture's first CUDA call raises and no eager step
    is left in its place; the failed paged build (warmed up on null
    tables) leaves the staged wave as it was.  With ``eager`` it builds
    without touching CUDA."""
    _, tm = pair
    eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, device="cpu",
                        **LAYOUTS[layout])
    mb = eng.max_blocks if eng.paged else None
    ids = np.arange(16, dtype=np.int32).reshape(2, 8)
    last = np.array([7, 3], np.int32)
    inputs = (dict(prefix=np.array([0, 8], np.int32),
                   tables=np.arange(1, 1 + 2 * mb, dtype=np.int32)
                   .reshape(2, mb)) if mb
              else dict(slots=np.array([1, 0], np.int32)))
    for eager in (False, True):
        st = step_graph.PrefillStep(tm, eng._cache, 8, 2, mb,
                                    torch.device("cpu"),
                                    f"card-test-{layout}-{eager}",
                                    eager=eager)
        st.device = torch.device("cuda")
        st.stage(ids, last, **inputs)
        held = st._stage.clone()
        if eager:
            st.build()
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                st.build()
        assert not st.graphed and st.traces == 1
        assert torch.equal(st._stage, held)
