"""The PyTorch port's speculative ServingEngine against the JAX package's
``ServingEngine(spec_decode=True)``, on the CPU.

One JAX ``tiny_llama_config`` model (float32) is bridged into the port;
each trace goes through the JAX spec engine and the port's, greedy unless
named.  Outputs must be TOKEN-IDENTICAL, and so must the schedule and the
accounting: ticks, ``step_traces`` (1), tokens, finished requests and the
``metrics()["spec"]`` counters (``drafted_tokens``, ``draft_hit_tokens``,
``draft_miss_tokens``, ``draft_hit_rate``, ``rollbacks``, the
``accepted_per_step`` count and mean, each ``by_drafter`` kind's); paged
adds the prefix and pool counters, and a drained pool holds no block.
Exact equality throughout: greedy tokens are integers and every counter
is a count.

The traces are the reference's (``tests/test_serving.py:364-505``,
``tests/test_serving_paged.py:260-340``): a staggered trace (a long
prompt arriving mid-decode) under the n-gram drafter, wave and chunked; a
scripted drafter that proposes the known continuation with its third
draft corrupted (a rejection inside every window, rollback); EOS inside
an accepted window; multi-token accounting; a sampled row riding along
(greedy rows identical, the sampled row by its length); a shared system
prompt (prefix adoption under spec admission); int8 KV + int8 weights
against the JAX int8 spec engine; the draft-model drafter (a 1-layer
``draft_model_from``), wave and chunked.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import draft_model_from as jax_draft_model_from
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.models.quantized import (
    quantize_for_decode as jax_quantize_for_decode)
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch import flags
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     draft_model_from, load_jax_state_dict,
                                     quantize_for_decode)
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

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


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


LONG = _prompt(40, seed=70)
SHORTS = [_prompt(n, seed=71 + i) for i, n in enumerate((5, 7, 6, 9))]


def _staggered(eng):
    """Two short decodes in flight, a long prompt arrives mid-decode, two
    more shorts queue behind it; outputs in submit order."""
    rids = [eng.submit(SHORTS[0], max_new_tokens=10),
            eng.submit(SHORTS[1], max_new_tokens=10)]
    eng.step()
    eng.step()
    rids.append(eng.submit(LONG, max_new_tokens=6))
    eng.step()
    rids += [eng.submit(SHORTS[2], max_new_tokens=8),
             eng.submit(SHORTS[3], max_new_tokens=8)]
    out = dict(eng.drain())
    return [out[r] for r in rids]


class _Scripted:
    """Proposes each request's known greedy continuation, optionally with
    the draft at ``corrupt_at`` changed (a rejection inside every window
    at a fixed offset).  ``refs``: [(prompt, stream)].  Pure numpy, so
    both engines call the same object."""

    def __init__(self, refs, k, corrupt_at=None, vocab=256):
        self.refs = sorted(refs, key=lambda pr: -len(pr[0]))
        self.k, self.corrupt_at, self.vocab = k, corrupt_at, vocab

    def propose(self, history):
        hist = [int(t) for t in history]
        for p, ref in self.refs:
            if hist[:len(p)] == [int(t) for t in p]:
                g = len(hist) - len(p)
                prop = list(ref[g:g + self.k])
                if self.corrupt_at is not None \
                        and self.corrupt_at < len(prop):
                    prop[self.corrupt_at] = (prop[self.corrupt_at] + 1) \
                        % self.vocab
                return np.asarray(prop, np.int32)
        return np.zeros((0,), np.int32)

    def reset_slot(self, i):
        pass


def _spec_block(sp):
    keys = ("spec_k", "default_drafter", "drafted_tokens",
            "draft_hit_tokens", "draft_miss_tokens", "draft_hit_rate",
            "rollbacks")

    def one(d):
        acc = d["accepted_per_step"]
        return {**{k: d[k] for k in keys if k in d},
                "accepted_count": acc["count"],
                "accepted_mean": acc.get("mean")}
    out = one(sp)
    out["by_drafter"] = {k: one(v) for k, v in
                         sorted(sp.get("by_drafter", {}).items())}
    return out


def _counters(eng, jax_side: bool):
    m = eng.metrics()
    got = {"ticks": eng._ticks, "step_traces": eng.step_traces,
           "tokens_generated": m["tokens_generated"],
           "requests_finished": m["requests_finished"],
           "spec": _spec_block(m["spec"])}
    if eng.paged:
        for k in ("prefix_lookups", "prefix_hit_blocks", "prefix_hit_tokens",
                  "evictions", "peak_blocks_in_use", "quantized_blocks"):
            got[k] = eng.kv.stats[k]
        got["blocks_in_use"] = eng.kv.blocks_in_use()
    return got


def _both(pair, trace, jkw=None, tkw=None, jmodel=None, tmodel=None,
          scripted=None, **kw):
    """Run ``trace`` through the JAX and the port spec engines built with
    ``kw`` (plus ``jkw`` / ``tkw`` for one side); ``scripted``: a
    :class:`_Scripted` drafter set as both engines' default."""
    jm, tm = pair
    jeng = JaxEngine(jmodel if jmodel is not None else jm,
                     **kw, **(jkw or {}))
    teng = ServingEngine(tmodel if tmodel is not None else tm,
                         device="cpu", **kw, **(tkw or {}))
    if scripted is not None:
        jeng._drafter = teng._drafter = scripted
    want, got = trace(jeng), trace(teng)
    return jeng, teng, want, got


def _check_same(jeng, teng, want, got):
    assert got == want
    assert _counters(teng, False) == _counters(jeng, True)
    assert teng.step_traces == jeng.step_traces == 1
    if teng.paged:
        assert teng.kv.blocks_in_use() == 0


LAYOUTS = {"contiguous": dict(),
           "paged": dict(paged=True, block_len=BL)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spec_staggered_identical_to_jax(pair, layout):
    """The n-gram drafter on the staggered trace: real proposals and real
    rejections, the verify step built once."""
    jeng, teng, want, got = _both(pair, _staggered, num_slots=3,
                                  max_length=MAXLEN, spec_decode=True,
                                  spec_k=4, **LAYOUTS[layout])
    _check_same(jeng, teng, want, got)
    sp = teng.metrics()["spec"]
    assert sp["drafted_tokens"] > 0 and sp["rollbacks"] > 0
    # a verify step's window is one decode tick
    m = teng.metrics()
    assert m["decode_ticks"] == teng._ticks - m["prefill_waves"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spec_chunked_identical_to_jax(pair, layout):
    """chunked x spec: the mixed step's decode half is the verify window;
    a prompt streaming in chunks drafts nothing until it completes."""
    jeng, teng, want, got = _both(pair, _staggered, num_slots=3,
                                  max_length=MAXLEN, chunked=True,
                                  prefill_chunk=8, spec_decode=True,
                                  spec_k=3, **LAYOUTS[layout])
    _check_same(jeng, teng, want, got)
    m = teng.metrics()
    assert m["spec"]["drafted_tokens"] > 0
    assert m["prefill_waves"] == 0 and m["mixed_ticks"] > 0
    assert m["decode_step_traces"] == 1 and teng.prefill_traces == 0


def _jax_stream(jm, prompt, n, eos=None):
    eng = JaxEngine(jm, num_slots=1, max_length=MAXLEN, eos_token_id=eos)
    rid = eng.submit(prompt, max_new_tokens=n)
    return dict(eng.drain())[rid]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spec_forced_midwindow_rejection(pair, layout):
    """Every window's third draft is wrong: each verify step commits the
    two verified drafts and one token, then rolls back (paged: the blocks
    past the accept point go back to the pool)."""
    jm, _ = pair
    p = _prompt(6, seed=140)
    ref = _jax_stream(jm, p, 12)
    drafter = _Scripted([(p, ref)], k=4, corrupt_at=2)

    def trace(eng):
        rid = eng.submit(p, max_new_tokens=12)
        return dict(eng.drain())[rid]
    jeng, teng, want, got = _both(pair, trace, num_slots=2,
                                  max_length=MAXLEN, spec_decode=True,
                                  spec_k=4, scripted=drafter,
                                  **LAYOUTS[layout])
    _check_same(jeng, teng, want, got)
    assert got == ref
    sp = teng.metrics()["spec"]
    assert sp["rollbacks"] >= 2 and sp["draft_miss_tokens"] >= 2
    cum = teng._m_spec_accept.bucket_counts()    # a 3-token accept
    assert cum["3"] > cum["2"]


def _eos_probe(jm):
    """A prompt whose greedy stream's token at 2..4 appears there first:
    that token is the EOS, so the window that holds it is cut."""
    for seed in range(31, 80):
        cand = _prompt(5, seed=seed)
        ref = _jax_stream(jm, cand, 10)
        firsts = [j for j, t in enumerate(ref) if ref.index(t) == j]
        mid = [j for j in firsts if 2 <= j <= 4]
        if mid:
            return cand, ref, ref[mid[0]], mid[0]
    raise AssertionError("no probe prompt produced a mid-stream token")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spec_eos_inside_window(pair, layout):
    jm, _ = pair
    p0, full, eos, cut = _eos_probe(jm)
    drafter = _Scripted([(p0, full)], k=4)

    def trace(eng):
        rid = eng.submit(p0, max_new_tokens=10)
        return dict(eng.drain())[rid]
    jeng, teng, want, got = _both(pair, trace, num_slots=1,
                                  max_length=MAXLEN, eos_token_id=eos,
                                  spec_decode=True, spec_k=4,
                                  scripted=drafter, **LAYOUTS[layout])
    _check_same(jeng, teng, want, got)
    assert got[-1] == eos and len(got) == cut + 1
    assert teng.metrics()["retired"] == {"eos": 1}
    acc = teng._m_spec_accept
    assert acc.sum >= acc.count + 1          # a multi-token accept


def test_spec_multi_token_accounting(pair):
    """An N-token accept is N tokens in ONE step: tokens_generated moves
    by N, the accept histogram takes one observation of N (its sum is the
    tokens after the first), TPOT and queue wait once a request."""
    jm, _ = pair
    prompts = [_prompt(5, seed=160), _prompt(8, seed=161)]
    drafter = _Scripted([(p, _jax_stream(jm, p, 6)) for p in prompts], k=4)

    def trace(eng):
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        out = dict(eng.drain())
        return [out[r] for r in rids]
    jeng, teng, want, got = _both(pair, trace, num_slots=2,
                                  max_length=MAXLEN, spec_decode=True,
                                  spec_k=4, scripted=drafter)
    _check_same(jeng, teng, want, got)
    total = sum(len(o) for o in got)
    m = teng.metrics()
    acc = teng._m_spec_accept
    assert total == 12 and m["tokens_generated"] == total
    assert acc.sum == total - 2 and acc.count < total - 2
    assert m["tpot_ms"]["count"] == 2 and m["queue_wait_ms"]["count"] == 2
    assert m["decode_step_ms"]["count"] == teng._ticks - m["prefill_waves"]


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_sampled_row_rides_along(pair, drafter):
    """A sampled request beside a greedy one: the greedy row keeps its
    tokens (the JAX spec engine's); the sampled row draws from the port's
    generator (compared by length and range only), one seed one output.
    With the draft model the sampled row's drafts are draws from its q
    (Gumbel noise from the engine's generator) and its acceptance runs
    against that q."""
    jm, tm = pair
    g0, s0 = _prompt(5, seed=51), _prompt(6, seed=53)

    def trace(eng, sampling):
        rg = eng.submit(g0, max_new_tokens=6)
        rs = eng.submit(s0, max_new_tokens=6, sampling=sampling(
            temperature=0.9, top_k=8, top_p=0.95))
        out = dict(eng.drain())
        return out[rg], out[rs]

    jeng = JaxEngine(jm, num_slots=2, max_length=MAXLEN, seed=3,
                     spec_decode=True, spec_k=4)
    want_g, _ = trace(jeng, JaxSampling)
    runs = []
    for _ in range(2):
        teng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, seed=3,
                             spec_decode=True, spec_k=4, drafter=drafter,
                             device="cpu")
        runs.append(trace(teng, SamplingParams))
        assert teng.step_traces == 1
    (got_g, got_s), again = runs
    assert got_g == want_g
    assert again == runs[0]
    assert len(got_s) == 6 and all(0 <= t < 256 for t in got_s)
    if drafter == "model":
        # self-drafting: the greedy row's drafts all verify
        sp = teng.metrics()["spec"]
        assert sp["drafted_tokens"] > 0 and sp["draft_hit_tokens"] > 0


def test_paged_spec_shared_prompt_identical_to_jax(pair):
    """Prefix adoption under spec admission, draft-window block growth and
    rollback truncation on one pool (the reference's paged acceptance
    trace)."""
    sys_p = _prompt(17, seed=100)
    prompts = [np.concatenate([sys_p, _prompt(4, 101)]), _prompt(9, 102),
               np.concatenate([sys_p, _prompt(6, 103)]), _prompt(12, 104)]

    def trace(eng):
        rids = [eng.submit(prompts[0], max_new_tokens=12),
                eng.submit(prompts[1], max_new_tokens=12)]
        eng.step()
        eng.step()
        rids.append(eng.submit(prompts[2], max_new_tokens=12))
        eng.step()
        rids.append(eng.submit(prompts[3], max_new_tokens=8))
        out = dict(eng.drain())
        return [out[r] for r in rids]
    jeng, teng, want, got = _both(pair, trace, num_slots=3,
                                  max_length=MAXLEN, paged=True,
                                  block_len=BL, spec_decode=True, spec_k=4)
    _check_same(jeng, teng, want, got)
    assert teng.kv.stats["prefix_hit_tokens"] == 16
    assert teng.metrics()["spec"]["drafted_tokens"] > 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spec_int8_identical_to_jax_int8(pair, layout):
    """int8 KV and int8 weights (both models wrapped by their
    ``quantize_for_decode`` at one ``min_elems``) against the JAX int8
    spec engine: rejected-suffix and pad-column writes grow the scales as
    the reference's do, so the tokens and counters are its."""
    jm, tm = pair
    jeng, teng, want, got = _both(
        pair, _staggered,
        jmodel=jax_quantize_for_decode(jm, min_elems=MIN_ELEMS),
        tmodel=quantize_for_decode(tm, min_elems=MIN_ELEMS), num_slots=3,
        max_length=MAXLEN, kv_cache_dtype="int8", int8_weights=True,
        spec_decode=True, spec_k=4, **LAYOUTS[layout])
    _check_same(jeng, teng, want, got)
    assert teng.quantized and teng.metrics()["spec"]["rollbacks"] > 0


MODEL_LAYOUTS = {
    "contiguous-wave": dict(),
    "paged-chunked": dict(paged=True, block_len=16, chunked=True,
                          prefill_chunk=8)}


@pytest.mark.parametrize("layout", sorted(MODEL_LAYOUTS))
def test_model_drafter_identical_to_jax(pair, layout):
    """The draft-model drafter (a 1-layer ``draft_model_from`` of the
    target) beside the JAX engine's: tokens and counters identical, the
    draft step built once; a second request in the same engine picks the
    n-gram drafter by ``submit(drafter=...)``."""
    jm, tm = pair
    jdm = jax_draft_model_from(jm, num_layers=1)
    tdm = draft_model_from(tm, num_layers=1)
    prompts = [np.random.RandomState(40 + i).randint(0, 256, n)
               .astype(np.int32) for i, n in enumerate((5, 9, 7))]

    def trace(eng):
        rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
        rids.append(eng.submit(np.asarray([5, 6, 5, 6, 5, 6], np.int32),
                               max_new_tokens=8, drafter="ngram"))
        out = dict(eng.drain())
        return [out[r] for r in rids]
    jeng, teng, want, got = _both(
        pair, trace, jkw=dict(draft_model=jdm), tkw=dict(draft_model=tdm),
        num_slots=3, max_length=MAXLEN, spec_decode=True, spec_k=3,
        drafter="model", **MODEL_LAYOUTS[layout])
    _check_same(jeng, teng, want, got)
    m = teng.metrics()
    by = m["spec"]["by_drafter"]
    assert by["model"]["drafted_tokens"] > 0
    assert by["model"]["draft_hit_tokens"] > 0
    assert sorted(teng._drafters) == ["model", "ngram"]   # the override
    assert m["draft_traces"] == 1
    assert teng._drafters["model"].ingest_traces == 1


def test_spec_flag_selects_the_spec_engine(pair):
    """``FLAGS_serving_spec_decode`` / ``_spec_k`` / ``_spec_drafter`` /
    ``_spec_ngram`` are the constructor's defaults."""
    _, tm = pair
    names = ("serving_spec_decode", "serving_spec_k", "serving_spec_drafter",
             "serving_spec_ngram")
    old = {k: flags.flag(k) for k in names}
    assert old == {"serving_spec_decode": False, "serving_spec_k": 4,
                   "serving_spec_drafter": "ngram", "serving_spec_ngram": 3}
    flags.set_flags({"serving_spec_decode": True, "serving_spec_k": 2,
                     "serving_spec_ngram": 2})
    try:
        eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, device="cpu")
    finally:
        flags.set_flags(old)
    assert eng.spec and eng.spec_k == 2
    assert eng._drafter.kind == "ngram" and eng._drafter.max_ngram == 2
    assert eng.metrics()["spec"]["spec_k"] == 2
    with pytest.raises(ValueError, match="drafter must be"):
        ServingEngine(tm, num_slots=2, max_length=MAXLEN, device="cpu",
                      spec_decode=True, drafter="oracle")
