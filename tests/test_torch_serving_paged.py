"""The PyTorch port's PAGED ServingEngine against the JAX package's, on the
CPU.

One JAX ``tiny_llama_config`` model (float32) is bridged into the port; the
same traces go through the JAX paged engine and the port's (``paged=True``,
``block_len=8``, ``max_length=64``, the shapes of
``tests/test_serving_paged.py``), greedy.  Outputs must be TOKEN-IDENTICAL
and the prefix-cache counters equal: the two engines admit the same
requests into the same waves, adopt the same prefix blocks and evict the
same cached blocks, because their ``BlockManager``s are the same logic
(``tests/test_torch_kv_cache.py`` replays them against each other).
"""

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch import flags
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.ops import _dispatch
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


def _staggered(engine):
    """Three admission waves, mixed lengths, fewer slots than requests,
    two requests opening with one 17-token system prompt (2 full blocks +
    1 token), submitted between ticks."""
    sys_p = _prompt(17, seed=100)
    prompts = [np.concatenate([sys_p, _prompt(4, 101)]), _prompt(9, 102),
               np.concatenate([sys_p, _prompt(6, 103)]), _prompt(12, 104),
               _prompt(6, 105)]
    rids = [engine.submit(prompts[0], max_new_tokens=8),
            engine.submit(prompts[1], max_new_tokens=8)]
    engine.step()
    engine.step()
    rids.append(engine.submit(prompts[2], max_new_tokens=8))
    engine.step()
    rids += [engine.submit(prompts[3], max_new_tokens=8),
             engine.submit(prompts[4], max_new_tokens=8)]
    out = dict(engine.drain())
    return [out[r] for r in rids]


def _tight(engine):
    """5 requests of 10 + 6 tokens (2 blocks each) through 5 usable
    blocks and 3 slots: admission waits for space and retired blocks are
    evicted."""
    prompts = [_prompt(10, seed=120 + i) for i in range(5)]
    rids = [engine.submit(p, max_new_tokens=6) for p in prompts]
    out = dict(engine.drain())
    return [out[r] for r in rids]


def _no_prefix(engine):
    sys_p = _prompt(16, seed=150)
    prompts = [np.concatenate([sys_p, _prompt(4, 151)]),
               np.concatenate([sys_p, _prompt(6, 152)])]
    rids = [engine.submit(p, max_new_tokens=5) for p in prompts]
    out = dict(engine.drain())
    return [out[r] for r in rids]


TRACES = {
    "shared_prompt": (_staggered, dict(num_slots=3)),
    "tight_pool": (_tight, dict(num_slots=3, num_blocks=6)),
    "no_prefix_cache": (_no_prefix, dict(num_slots=3, prefix_cache=False)),
}


def _counters(engine):
    return {"prefill_tokens_computed": engine.prefill_tokens_computed,
            "prefill_tokens_total": engine.prefill_tokens_total,
            "admission_blocked":
                engine.metrics()["kv_cache"]["admission_blocked"],
            **{k: engine.kv.stats[k] for k in
               ("prefix_hit_tokens", "prefix_hit_blocks", "evictions",
                "peak_blocks_in_use")}}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_paged_engine_token_identical_to_jax(pair, trace):
    jm, tm = pair
    run, kw = TRACES[trace]
    jeng = JaxEngine(jm, max_length=MAXLEN, paged=True, block_len=BL, **kw)
    want = run(jeng)
    teng = ServingEngine(tm, max_length=MAXLEN, paged=True, block_len=BL,
                         device="cpu", **kw)
    got = run(teng)
    assert got == want
    assert _counters(teng) == _counters(jeng)
    m = teng.metrics()
    assert m["kv_cache"]["prefix_hit_tokens"] == jeng.kv.stats[
        "prefix_hit_tokens"]
    assert m["kv_cache"]["evictions"] == jeng.kv.stats["evictions"]
    assert teng.kv.blocks_in_use() == 0
    if trace == "shared_prompt":
        # the second system-prompt request adopted its two full blocks
        assert teng.kv.stats["prefix_hit_tokens"] == 16
        assert (teng.prefill_tokens_computed
                == teng.prefill_tokens_total - 16)
    elif trace == "tight_pool":
        assert teng.kv.stats["evictions"] >= 1
        assert m["kv_cache"]["admission_blocked"] >= 1
    else:
        assert teng.kv.stats["prefix_hit_tokens"] == 0
        assert teng.prefill_tokens_computed == teng.prefill_tokens_total


def test_paged_matches_contiguous_engine(pair):
    """The same trace through the port's contiguous and paged engines:
    identical outputs row for row, and the paged run routes every
    attention call through the paged ops (plain versions on the CPU)."""
    _, tm = pair
    prompts = [_prompt(n, seed=110 + i) for i, n in enumerate((5, 11, 7, 14))]
    out = []
    _dispatch.reset_kernel_paths()
    for paged in (False, True):
        eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, paged=paged,
                            block_len=BL if paged else None, device="cpu")
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        res = dict(eng.drain())
        out.append([res[r] for r in rids])
    assert out[0] == out[1]
    paths = dict(_dispatch.kernel_paths)
    assert paths[("decode_attention_paged", "plain")] > 0
    assert paths[("paged_prefill", "plain")] > 0
    assert not any(path == "kernel" for _, path in paths)


def test_paged_slot_reuse_and_eos(pair):
    """EOS retirement mid-stream frees the slot's blocks; the recycled
    slot must not see the previous tenant's KV.  One slot, EOS picked from
    the JAX engine's own output: both engines agree."""
    jm, tm = pair
    p1, p2 = _prompt(8, seed=32), _prompt(5, seed=33)
    p0 = eos = cut = None
    for seed in range(31, 63):
        cand = _prompt(5, seed=seed)
        eng = JaxEngine(jm, num_slots=1, max_length=MAXLEN, paged=True,
                        block_len=BL)
        rid = eng.submit(cand, max_new_tokens=8)
        ref = dict(eng.drain())[rid]
        mid = [j for j, t in enumerate(ref) if ref.index(t) == j and
               1 <= j < 7]
        if mid:
            p0, cut, eos = cand, mid[0], ref[mid[0]]
            break
    assert p0 is not None

    def run(engine):
        rids = [engine.submit(p, max_new_tokens=8) for p in (p0, p1, p2)]
        out = dict(engine.drain())
        return [out[r] for r in rids]

    want = run(JaxEngine(jm, num_slots=1, max_length=MAXLEN, paged=True,
                         block_len=BL, eos_token_id=eos))
    teng = ServingEngine(tm, num_slots=1, max_length=MAXLEN, paged=True,
                         block_len=BL, eos_token_id=eos, device="cpu")
    got = run(teng)
    assert got == want
    assert len(got[0]) == cut + 1
    assert teng.metrics()["retired"]["eos"] >= 1
    assert teng.kv.blocks_in_use() == 0


def test_pool_too_small_rejected_at_submit(pair):
    _, tm = pair
    eng = ServingEngine(tm, num_slots=1, max_length=MAXLEN, paged=True,
                        block_len=BL, num_blocks=3, device="cpu")
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(_prompt(20, seed=130), max_new_tokens=8)
    assert eng.metrics()["requests_submitted"] == 0


def test_block_len_must_divide_max_length(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="block_len"):
        ServingEngine(tm, num_slots=2, max_length=60, paged=True,
                      block_len=8, device="cpu")


def test_paged_flags_select_the_paged_engine(pair):
    """FLAGS_serving_paged_kv / kv_cache_block_len / kv_cache_num_blocks /
    serving_prefix_cache do what the constructor arguments do."""
    _, tm = pair
    flags.set_flags({"serving_paged_kv": True, "kv_cache_block_len": BL,
                     "kv_cache_num_blocks": 9,
                     "serving_prefix_cache": False})
    try:
        eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, device="cpu")
    finally:
        flags.set_flags({"serving_paged_kv": False,
                         "kv_cache_block_len": 128, "kv_cache_num_blocks": 0,
                         "serving_prefix_cache": True})
    assert eng.paged and eng.block_len == BL and eng.max_blocks == 8
    assert eng.kv.num_blocks == 9 and not eng.kv.prefix_cache
    assert tuple(eng._cache.shape) == (2, 2, 9, BL, 2, 16)
    default = ServingEngine(tm, num_slots=2, max_length=MAXLEN, paged=True,
                            block_len=BL, device="cpu")
    assert default.kv.num_blocks == 2 * 8 + 1


def test_cow_copy_moves_the_device_block(pair):
    """The COW hook of the decode tick: a shared block about to be
    written is swapped for a private copy, the pool block copied and the
    table row refreshed.  (The engine's own flow never shares a written
    block; a forking feature would.)"""
    _, tm = pair
    eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, paged=True,
                        block_len=BL, device="cpu")
    p = _prompt(20, seed=140)
    eng.kv.admit(0, p, 20, 4)
    eng.kv.admit(1, p, 20, 4)          # adopts 2 full blocks of slot 0
    shared = eng.kv.chain(1)[1]
    eng._cache[:, :, shared] = 3.0
    eng._positions[1] = BL + 1         # writing into the shared block
    eng._grow_row_for_writes(1, BL + 1)
    dst = eng.kv.chain(1)[1]
    assert dst != shared and eng.kv.stats["cow_copies"] == 1
    assert bool((eng._cache[:, :, dst] == 3.0).all())
    assert eng._tables[1, 1] == dst
