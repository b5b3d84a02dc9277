"""The PyTorch port's int8 ServingEngine against the JAX package's int8
engine, on the CPU.

One JAX ``tiny_llama_config`` model (float32, the model of
``tests/test_serving_int8.py``) is bridged into the port; the reference's
pinned prompts go through the JAX engine and the port's with
``kv_cache_dtype="int8"`` (``block_len=8``, ``max_length=64``), greedy.
Outputs must be TOKEN-IDENTICAL to the reference's int8 outputs (never to
bf16: the reference's own int8 path is not token-identical to its bf16
path on every trace, ROADMAP §C), and the paged prefix counters and
``quantized_blocks`` equal.  Three configurations: the contiguous int8
cache, the paged int8 pool, and the paged int8 pool with int8 weights (both
models pre-wrapped by their ``quantize_for_decode`` with one small
``min_elems``, so every tiny projection, the embedding and the LM head are
int8).
"""

import numpy as np
import pytest
import torch

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
from paddle_tpu_torch.nn.quant import Int8Weight
from paddle_tpu_torch.ops import _dispatch
from paddle_tpu_torch.serving import ServingEngine

MAXLEN = 64
BL = 8
MIN_ELEMS = 2048      # every tiny projection, not the 128 x 8 RoPE tables


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


def _serve(engine, prompts, n_new=8):
    rids = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    out = dict(engine.drain())
    return [out[r] for r in rids]


def _counters(engine):
    return {"prefill_tokens_computed": engine.prefill_tokens_computed,
            "prefill_tokens_total": engine.prefill_tokens_total,
            **{k: engine.kv.stats[k] for k in
               ("prefix_hit_tokens", "prefix_hit_blocks", "evictions",
                "peak_blocks_in_use", "quantized_blocks")}}


# the reference's pinned traces: tests/test_serving_int8.py:311 (layouts)
# and :384 (int8 weights), with a shared 17-token prompt added to the
# paged ones so the prefix cache adopts int8 blocks
_SYS = _prompt(17, 200)
CASES = {
    "contiguous": (dict(), False,
                   [_prompt(n, 120 + n) for n in (5, 12, 3, 20)]),
    "paged": (dict(paged=True, block_len=BL), False,
              [_prompt(n, 120 + n) for n in (5, 12, 3, 20)]
              + [np.concatenate([_SYS, _prompt(4, 201)]),
                 np.concatenate([_SYS, _prompt(6, 202)])]),
    "paged+int8_weights": (dict(paged=True, block_len=BL), True,
                           [_prompt(n, 80 + n) for n in (5, 9)]
                           + [np.concatenate([_SYS, _prompt(3, 203)]),
                              np.concatenate([_SYS, _prompt(7, 204)])]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_engine_token_identical_to_jax_int8(pair, case):
    jm, tm = pair
    kw, int8_weights, prompts = CASES[case]
    kw = dict(num_slots=3, max_length=MAXLEN, prefill_batch=2,
              kv_cache_dtype="int8", **kw)
    jmodel, tmodel = jm, tm
    if int8_weights:
        jmodel = jax_quantize_for_decode(jm, min_elems=MIN_ELEMS)
        tmodel = quantize_for_decode(tm, min_elems=MIN_ELEMS)
        kw["int8_weights"] = True
    jeng = JaxEngine(jmodel, **kw)
    want = _serve(jeng, prompts)
    _dispatch.reset_kernel_paths()
    teng = ServingEngine(tmodel, device="cpu", **kw)
    got = _serve(teng, prompts)
    assert got == want
    assert teng.quantized and teng.kv_dtype == "int8"
    paths = dict(_dispatch.kernel_paths)
    assert not any(p == "kernel" for _, p in paths)
    if teng.paged:
        assert _counters(teng) == _counters(jeng)
        m = teng.metrics()["kv_cache"]
        assert m["kv_dtype"] == "int8"
        assert m["quantized_blocks"] == jeng.kv.stats["quantized_blocks"] > 0
        assert m["bytes_by_dtype"]["bf16"] == 0
        assert m["bytes_by_dtype"]["int8"] == (
            m["quantized_blocks"] * teng.kv._block_nbytes["int8"])
        assert teng.kv.stats["prefix_hit_tokens"] == 16
        assert paths[("decode_attention_paged_int8", "plain")] > 0
        assert paths[("paged_prefill_int8", "plain")] > 0
    else:
        assert paths[("decode_attention_int8", "plain")] > 0
    assert teng.cache_hbm_bytes == int(jeng.cache_hbm_bytes)
    if int8_weights:
        assert teng.model is tmodel
        assert isinstance(tmodel.unwrapped.lm_head, Int8Weight)
        assert paths[("int8_matmul", "plain")] > 0


def test_int8_block_reuse_matches_fresh_pool(pair):
    """Requests landing on REUSED physical blocks are served exactly as on
    a fresh int8 pool (the port-side twin of the reference's slow
    ``test_int8_block_reuse_matches_fresh_pool_exactly``): the engine zeroes
    the scale rows of blocks new to a chain before each dispatch, so a
    previous tenant's scale never joins the running max.  Each wave needs
    all 6 usable blocks of the pool, so the second wave reuses every one;
    after its prefill and first decode tick, every block of its chains
    holds the same payload and scales as on the fresh pool, and the tokens
    agree."""
    _, tm = pair
    first = [_prompt(n, 40 + n) for n in (12, 9)]
    second = [_prompt(n, 50 + n) for n in (17, 6)]

    def run(warm):
        eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN,
                            prefill_batch=2, prefix_cache=False, paged=True,
                            block_len=BL, num_blocks=7, kv_cache_dtype="int8",
                            device="cpu")
        if warm:
            _serve(eng, first, n_new=10)
        rids = [eng.submit(p, max_new_tokens=10) for p in second]
        eng.step()
        state = [{k: t[:, :, eng.kv.chain(i)].clone()
                  for k, t in eng._cache.items()} for i in range(2)]
        out = dict(eng.drain())
        return [out[r] for r in rids], state, eng

    want, want_state, _ = run(False)
    got, got_state, eng = run(True)
    for a, b in zip(got_state, want_state):
        assert torch.equal(a["scale"], b["scale"])
        assert torch.equal(a["kv"], b["kv"])
    assert got == want
    assert eng.kv.blocks_in_use() == 0


def test_int8_cache_bytes_and_dequant_error_hook(pair):
    _, tm = pair
    kw = dict(num_slots=3, max_length=MAXLEN, device="cpu")
    for paged in (False, True):
        extra = dict(paged=True, block_len=BL) if paged else {}
        e32 = ServingEngine(tm, **kw, **extra)
        e8 = ServingEngine(tm, kv_cache_dtype="int8", **kw, **extra)
        # f32 payload -> int8 payload plus the float32 scale rows
        assert e8.cache_hbm_bytes < 0.3 * e32.cache_hbm_bytes
    e8.observe_dequant_error(0.125)
    assert e8.metrics()["kv_dequant_error"]["count"] == 1


def test_int8_flags_select_the_int8_engine(pair):
    _, tm = pair
    flags.set_flags({"serving_kv_cache_dtype": "int8",
                     "serving_int8_weights": True})
    try:
        eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, device="cpu")
    finally:
        flags.set_flags({"serving_kv_cache_dtype": "bf16",
                         "serving_int8_weights": False})
    assert eng.quantized and eng.int8_weights
    assert hasattr(eng.model, "unwrapped") and eng.model.unwrapped is not tm
    assert eng._cache["kv"].dtype == torch.int8


def test_mixed_and_unknown_dtypes_raise(pair):
    """The mixed pool builds on the paged cache (a model-dtype pool, the
    demote op built once); contiguous it raises the reference's
    ``ValueError``, as an unknown dtype does."""
    _, tm = pair
    eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, paged=True,
                        block_len=BL, kv_cache_dtype="mixed", device="cpu")
    assert eng.kv.kv_dtype == "mixed" and eng.demote_traces == 1
    assert eng._cache.dtype == tm.config.torch_dtype
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(tm, num_slots=2, max_length=MAXLEN,
                      kv_cache_dtype="mixed", device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(tm, num_slots=2, max_length=MAXLEN,
                      kv_cache_dtype="fp8", device="cpu")
