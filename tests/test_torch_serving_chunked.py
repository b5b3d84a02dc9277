"""The PyTorch port's chunked-prefill ServingEngine against the JAX
package's chunked engine, on the CPU.

One JAX ``tiny_llama_config`` model (float32) is bridged into the port;
the same staggered trace goes through the JAX ``ServingEngine(chunked=True)``
and the port's, greedy, in both cache layouts and under both
``chunk_policy`` values.  Outputs must be TOKEN-IDENTICAL, and so must the
schedule: ticks, ``step_traces``, ``prefill_chunks``,
``prefill_chunk_tokens`` and (paged) the prefix and pool counters.

The trace (3 slots, ``max_length`` 64, 12-token chunks, paged
``block_len`` 8 over a 14-block pool):

  * two short requests decode when a 40-token prompt arrives — it streams
    in over four chunks while they decode;
  * that prompt and a later one open with one 17-token system prompt: the
    paged engine adopts its two full blocks once the chunks that write
    them are dispatched;
  * a 62-token prompt: its last chunk starts at 60, so its pad tail runs
    to 71, past ``max_length`` (contiguous: dropped writes; paged: past
    the table, the null block); the pool is too small for it beside the
    others, so its admission waits (paged ``admission_blocked``);
  * a 6-token prompt, one chunk, whose first token is the EOS token.

int8 KV (with int8 weights at ``min_elems`` 2048) is held against the JAX
**int8** chunked engine, never against bf16 (ROADMAP §C).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.models.quantized import (
    quantize_for_decode as jax_quantize_for_decode)
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch import flags
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict, quantize_for_decode)
from paddle_tpu_torch.ops import _dispatch
from paddle_tpu_torch.serving import ServingEngine

MAXLEN = 64
BL = 8
CHUNK = 12
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


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


_SYS = _prompt(17, 400)
SHORTS = [_prompt(5, 401), _prompt(7, 402)]
LONG = np.concatenate([_SYS, _prompt(23, 403)])          # 40: four chunks
SHARED = np.concatenate([_SYS, _prompt(5, 404)])          # adopts 2 blocks
TAIL = _prompt(62, 405)                                   # pad tail past 64
EOS_PROMPT = _prompt(6, 406)                              # one chunk


def _trace(eng):
    """The staggered trace; returns the outputs in submit order."""
    rids = [eng.submit(SHORTS[0], max_new_tokens=10),
            eng.submit(SHORTS[1], max_new_tokens=10)]
    eng.step()
    eng.step()
    rids.append(eng.submit(LONG, max_new_tokens=6))
    eng.step()
    rids += [eng.submit(SHARED, max_new_tokens=8),
             eng.submit(TAIL, max_new_tokens=2),
             eng.submit(EOS_PROMPT, max_new_tokens=4)]
    out = dict(eng.drain())
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def eos(pair):
    """The EOS token: the JAX model's greedy first token of EOS_PROMPT."""
    jm, _ = pair
    logits = jm(jnp.asarray(EOS_PROMPT[None], jnp.int32))
    return int(np.asarray(logits)[0, -1].argmax())


LAYOUTS = {"contiguous": dict(),
           "paged": dict(paged=True, block_len=BL, num_blocks=14)}


def _kw(layout, eos, **extra):
    return dict(num_slots=3, max_length=MAXLEN, eos_token_id=eos,
                chunked=True, prefill_chunk=CHUNK, **LAYOUTS[layout], **extra)


def _counters(jeng, teng):
    """The schedule and accounting both engines keep, side by side."""
    jm, tm = jeng.metrics(), teng.metrics()
    got = {"ticks": teng._ticks, "step_traces": teng.step_traces,
           "prefill_tokens_computed": teng.prefill_tokens_computed,
           "prefill_tokens_total": teng.prefill_tokens_total,
           "requests_finished": tm["requests_finished"],
           "tokens_generated": tm["tokens_generated"],
           **{k: tm["chunked"][k] for k in
              ("prefill_chunk", "chunk_policy", "prefill_chunks",
               "prefill_chunk_tokens")}}
    want = {"ticks": jeng._ticks, "step_traces": jeng.step_traces,
            "prefill_tokens_computed": jeng.prefill_tokens_computed,
            "prefill_tokens_total": jeng.prefill_tokens_total,
            "requests_finished": jm["requests_finished"],
            "tokens_generated": jm["tokens_generated"],
            **{k: jm["chunked"][k] for k in
               ("prefill_chunk", "chunk_policy", "prefill_chunks",
                "prefill_chunk_tokens")}}
    if teng.paged:
        for k in ("prefix_lookups", "prefix_hit_blocks", "prefix_hit_tokens",
                  "evictions", "peak_blocks_in_use", "quantized_blocks"):
            got[k], want[k] = teng.kv.stats[k], jeng.kv.stats[k]
        got["admission_blocked"] = tm["kv_cache"]["admission_blocked"]
        want["admission_blocked"] = int(jeng._m_blocked.value())
    return got, want


@pytest.mark.parametrize("policy", ["prefill", "decode"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chunked_token_identical_to_jax(pair, eos, layout, policy):
    jm, tm = pair
    kw = _kw(layout, eos, chunk_policy=policy)
    jeng = JaxEngine(jm, **kw)
    want = _trace(jeng)
    _dispatch.reset_kernel_paths()
    teng = ServingEngine(tm, device="cpu", **kw)
    got = _trace(teng)
    assert got == want
    got_c, want_c = _counters(jeng, teng)
    assert got_c == want_c
    assert teng.step_traces == jeng.step_traces == 1
    m = teng.metrics()
    assert m["prefill_waves"] == 0 and m["decode_step_traces"] == 1
    assert m["ticks"] == m["mixed_ticks"] + m["decode_ticks"]
    assert m["chunked"]["prefill_chunks"] >= 4 + 5     # LONG: 4, TAIL: 6
    assert got[-1] == [eos] and m["retired"]["eos"] >= 1
    assert len(got[4]) == 2                            # the pad-tail prompt
    # every chunk ran the paged prefill route (contiguous: through the
    # identity view), every decode row the decode route
    paths = dict(_dispatch.kernel_paths)
    assert not any(p == "kernel" for _, p in paths)
    assert paths[("paged_prefill", "plain")] == (
        tm.config.num_hidden_layers * m["mixed_ticks"])
    if layout == "paged":
        assert got_c["prefix_hit_tokens"] >= 16
        assert got_c["admission_blocked"] >= 1
        assert teng.kv.blocks_in_use() == 0
    if policy == "decode":
        assert m["decode_ticks"] > 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chunked_int8_token_identical_to_jax_int8(pair, eos, layout):
    """int8 KV and int8 weights (both models wrapped by their
    ``quantize_for_decode`` at one ``min_elems``) against the JAX int8
    chunked engine: tokens and schedule; contiguous int8 rows reused by a
    later prompt have their granule scales zeroed at admission."""
    jm, tm = pair
    kw = _kw(layout, eos, kv_cache_dtype="int8", int8_weights=True)
    jeng = JaxEngine(jax_quantize_for_decode(jm, min_elems=MIN_ELEMS), **kw)
    want = _trace(jeng)
    teng = ServingEngine(quantize_for_decode(tm, min_elems=MIN_ELEMS),
                         device="cpu", **kw)
    got = _trace(teng)
    assert got == want
    got_c, want_c = _counters(jeng, teng)
    assert got_c == want_c
    assert teng.quantized and teng.step_traces == 1


def test_chunked_flag_selects_the_chunked_engine(pair):
    _, tm = pair
    old = {k: flags.flag(k) for k in ("serving_chunked_prefill",
                                      "serving_prefill_chunk",
                                      "serving_chunk_policy")}
    flags.set_flags({"serving_chunked_prefill": True,
                     "serving_prefill_chunk": 16,
                     "serving_chunk_policy": "decode"})
    try:
        eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, device="cpu")
    finally:
        flags.set_flags(old)
    assert eng.chunked and eng.prefill_chunk == 16
    assert eng.metrics()["chunked"]["chunk_policy"] == "decode"
    rid = eng.submit(LONG, max_new_tokens=3)
    out = dict(eng.drain())
    assert len(out[rid]) == 3
    assert eng.metrics()["chunked"]["prefill_chunks"] == 3   # 40 / 16


def test_idle_tick_dispatches_nothing(pair):
    """No queue, no decoding slot, no cursor: the tick returns at once
    and runs neither step (the reference's tests/test_serving.py:318);
    the engine serves normally afterwards."""
    _, tm = pair
    eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, chunked=True,
                        prefill_chunk=8, device="cpu")

    def boom():
        raise AssertionError("an idle tick dispatched a step")

    runs = eng._step.run, eng._mixed.run
    eng._step.run = eng._mixed.run = boom
    for _ in range(3):
        assert eng.step() == []
    assert eng._ticks == 0
    eng._step.run, eng._mixed.run = runs
    wave = ServingEngine(tm, num_slots=2, max_length=MAXLEN, device="cpu")
    want = wave.submit(SHORTS[1], max_new_tokens=4)
    rid = eng.submit(SHORTS[1], max_new_tokens=4)
    assert dict(eng.drain())[rid] == dict(wave.drain())[want]


def test_queue_wait_observed_once_per_request(pair):
    """A request queued across many chunk ticks has its queue wait
    observed once, at admission, as in the reference."""
    _, tm = pair
    eng = ServingEngine(tm, num_slots=1, max_length=MAXLEN, chunked=True,
                        prefill_chunk=4, device="cpu")
    eng.submit(_prompt(18, 407), max_new_tokens=2)
    eng.submit(_prompt(6, 408), max_new_tokens=2)
    assert eng.queue_depth == 2
    eng.step()
    assert eng.queue_depth == 1
    assert eng.metrics()["queue_wait_ms"]["count"] == 1
    for _ in range(4):
        eng.step()
    assert eng.metrics()["queue_wait_ms"]["count"] == 1
    eng.drain()
    assert eng.metrics()["queue_wait_ms"]["count"] == 2
