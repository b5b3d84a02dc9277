"""The port's host KV tier and request migration against the JAX
package's engine, on the CPU.

One JAX ``tiny_llama_config`` model (float32) bridged into the port
(``MAXLEN`` 64, 8-token blocks).

1. Host tier (``host_blocks``): a one-slot engine over a 6-block pool
   serves a request with a 16-token system prompt, two unique requests
   that evict its blocks (demoted to the host instead of dropped), then a
   second request with the system prompt, whose admission promotes them
   back.  Tokens equal the JAX engine's with the same tier and the port's
   without a tier; the tier's counters equal the JAX engine's.
2. Migration: ``export_request`` of a decoding request from one engine and
   ``import_request`` into a second over the same model, on a bf16, int8
   and mixed pool.  The continued tokens equal the exporter's own
   (``release=False``: it keeps decoding) and the JAX engines' doing the
   same migration; the record's slot state equals the JAX record's.
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


def _engine(model, **kw):
    kw = dict(dict(max_length=MAXLEN, paged=True, block_len=BL), **kw)
    if isinstance(model, LlamaForCausalLM):
        return ServingEngine(model, device="cpu", **kw)
    return JaxEngine(model, **kw)


SYS = _prompt(16, 30)
TIER_PROMPTS = [np.concatenate([SYS, _prompt(3, 31)]), _prompt(20, 32),
                _prompt(22, 33), np.concatenate([SYS, _prompt(5, 34)])]
TIER_KEYS = ("host_demotions", "host_promotions", "evictions",
             "prefix_hit_tokens", "quantized_blocks")


def _tier_run(model, **kw):
    eng = _engine(model, num_slots=1, prefill_batch=1, num_blocks=7, **kw)
    rids = [eng.submit(p, max_new_tokens=4) for p in TIER_PROMPTS]
    out = dict(eng.drain())
    return [out[r] for r in rids], eng


@pytest.mark.parametrize("kv_dtype", ["bf16", "mixed"])
def test_host_tier_demotes_evicted_prefix_and_promotes_it(pair, kv_dtype):
    jm, tm = pair
    got, eng = _tier_run(tm, host_blocks=4, kv_cache_dtype=kv_dtype)
    want, jeng = _tier_run(jm, host_blocks=4, kv_cache_dtype=kv_dtype)
    plain, _ = _tier_run(tm, kv_cache_dtype=kv_dtype)
    assert got == want == plain
    st, jst = eng.kv.stats, jeng.kv.stats
    assert {k: st[k] for k in TIER_KEYS} == {k: jst[k] for k in TIER_KEYS}
    assert st["host_demotions"] > 0 and st["host_promotions"] > 0
    ht = eng.metrics()["kv_cache"]["host_tier"]
    assert ht["swap_out_bytes"] > 0 and ht["swap_in_bytes"] > 0
    assert ht["host_blocks_used"] == ht["host_trie_blocks"]
    assert eng.kv.blocks_in_use() == 0 and eng.step_traces == 1


MIGRATION_PROMPTS = [_prompt(19, 40), _prompt(11, 41)]
RECORD_KEYS = ("prompt", "generated", "max_new_tokens", "remaining",
               "position", "last_token", "had_first", "priority")


def _migrate(model, kv_dtype):
    """Serve both prompts on an exporter, export request 0 while it decodes
    (keeping it there), import it into a second engine and drain both:
    (the exporter's tokens for it, the importer's, the record's slot
    state, the importer's dtype tags of the imported chain)."""
    kw = dict(num_slots=2, prefill_batch=2, kv_cache_dtype=kv_dtype)
    src = _engine(model, **kw)
    rids = [src.submit(p, max_new_tokens=10) for p in MIGRATION_PROMPTS]
    for _ in range(4):
        src.step()
    record = src.export_request(rids[0], release=False)
    dst = _engine(model, **kw)
    rid = dst.import_request(record)
    assert rid is not None
    tags = [dst.kv.block_dtype(b) for b in dst.kv.chain(0)]
    dst.drain()
    src.drain()
    assert dst.kv.blocks_in_use() == 0
    return (src.result(rids[0]), dst.result(rid),
            {k: record[k] for k in RECORD_KEYS}, tags,
            len(record["blocks"]["entries"]))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "mixed"])
def test_export_import_continues_token_identically(pair, kv_dtype):
    jm, tm = pair
    got = _migrate(tm, kv_dtype)
    want = _migrate(jm, kv_dtype)
    assert got[0] == got[1] and len(got[1]) == 10
    assert got == want
    if kv_dtype == "mixed":
        assert got[3][:2] == ["int8", "int8"]     # 19 tokens: 2 full blocks
    assert got[4] == 3


def test_export_needs_a_decoding_request(pair):
    _, tm = pair
    eng = _engine(tm, num_slots=1)
    r0 = eng.submit(MIGRATION_PROMPTS[0], max_new_tokens=4)
    r1 = eng.submit(MIGRATION_PROMPTS[1], max_new_tokens=4)
    eng.step()
    assert eng.export_request(r1) is None         # still queued
    rec = eng.export_request(r0)                  # released after the copy
    assert eng.kv.blocks_in_use() == 0 and eng.num_active == 0
    assert eng.metrics()["migration"]["requests_out"] == 1
    assert eng.metrics()["migration"]["bytes_out"] == rec["payload_bytes"]
    with pytest.raises(RuntimeError, match="paged"):
        ServingEngine(tm, num_slots=1, max_length=MAXLEN,
                      device="cpu").export_request(0)
