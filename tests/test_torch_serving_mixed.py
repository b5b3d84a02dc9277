"""The port's mixed bf16/int8 pool (``kv_cache_dtype="mixed"``) against the
JAX package's, on the CPU.

1. The pool's lifecycle (``tests/test_serving_int8.py:149-258``): each
   scenario runs through the port's ``BlockManager`` and the JAX one, the
   dtype tags, demotion hooks, ``quantized_blocks`` and
   ``bytes_by_dtype`` equal.
2. The demote op (``serving/engine.py`` ``_DemoteOp``) against the JAX
   engine's ``_demote_impl`` on seeded float32 and bf16 pools, bit for
   bit (a block whose head is all zero included: its scale is 0).
3. The engine (``tests/test_serving_int8.py:350-378``): one JAX
   ``tiny_llama_config`` model (float32) bridged into the port; the same
   prompts through the JAX mixed engine and the port's, wave and chunked.
   Tokens identical, the demotions, ``quantized_blocks`` and
   ``bytes_by_dtype`` equal.  Held against the JAX MIXED engine, never
   JAX bf16: the reference's int8 path is not token-identical to its
   bf16 path (ROADMAP §C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.kv_cache import BlockManager as JaxBlockManager

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.engine import _DemoteOp
from paddle_tpu_torch.serving.kv_cache import BlockManager

MAXLEN = 64
BL = 8


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


# ---- 1. the pool's lifecycle, both managers ----------------------------------

def _mgrs(**kw):
    kw.setdefault("num_blocks", 12)
    kw.setdefault("block_len", BL)
    return [cls(**kw) for cls in (BlockManager, JaxBlockManager)]


def _same(mgrs):
    """Dtype tags, quantized blocks and chains equal across the managers;
    returns the port's."""
    port, ref = mgrs
    assert port._dtype.tolist() == ref._dtype.tolist()
    assert port.quantized_blocks() == ref.quantized_blocks()
    assert {s: port.chain(s) for s in port._slots} == {
        s: ref.chain(s) for s in ref._slots}
    return port


def test_mixed_demotes_only_full_prefix_blocks():
    seen = []
    for m in _mgrs(kv_dtype="mixed"):
        events = []
        m.on_demote = events.append
        m.admit(0, _prompt(20, 1), 20, max_new_tokens=4)  # 2 full + tail
        (bids,) = events
        assert len(bids) == 2
        assert [m.block_dtype(b) for b in m.chain(0)[:2]] == ["int8"] * 2
        assert m.block_dtype(m.chain(0)[2]) == "bf16"  # the hot tail
        assert m.quantized_blocks() == 2
        seen.append(events)
    assert seen[0] == seen[1]


def test_mixed_truncate_across_dtype_boundary_resets_to_hot():
    """Spec-decode rollback across the bf16/int8 boundary: blocks freed by
    truncate_to re-enter the pool at its default (hot for mixed, int8 for
    an int8 pool)."""
    for kv_dtype, want in (("mixed", "bf16"), ("int8", "int8")):
        mgrs = _mgrs(kv_dtype=kv_dtype, prefix_cache=False)
        for m in mgrs:
            m.admit(0, _prompt(9, 2), 9, max_new_tokens=30)
            for pos in range(9, 30):
                m.ensure_capacity(0, pos)
            chain = list(m.chain(0))
            if kv_dtype == "mixed":
                m._dtype[chain[-1]] = 1             # force a demoted tail
            m.truncate_to(0, 10)                    # back to 2 blocks
            freed = chain[len(m.chain(0)):]
            assert freed and all(m.block_dtype(b) == want for b in freed)
        _same(mgrs)


def test_mixed_cow_into_demoted_shared_block_goes_hot():
    """A fork writing into a demoted shared block copies it onto a fresh
    block: the private copy is hot, the shared original stays demoted."""
    mgrs = _mgrs(kv_dtype="mixed")
    p = _prompt(16, 3)                              # exactly 2 full blocks
    for m in mgrs:
        m.admit(0, p, p.size, max_new_tokens=4)
        shared = list(m.chain(0)[:2])
        assert all(m.block_dtype(b) == "int8" for b in shared)
        hit = m.admit(1, np.concatenate([p, _prompt(3, 4)]), 19,
                      max_new_tokens=4)
        assert hit == 16
        src, dst = m.ensure_writable(1, 1)
        assert src == shared[1]
        assert m.block_dtype(src) == "int8"
        assert m.block_dtype(dst) == "bf16"
    _same(mgrs)


def test_mixed_prefix_hits_adopt_int8_blocks():
    """LRU-parked demoted blocks revive through the trie with their
    dtype."""
    mgrs = _mgrs(kv_dtype="mixed")
    p = _prompt(16, 5)
    for m in mgrs:
        m.admit(0, p, p.size, max_new_tokens=4)
        demoted = list(m.chain(0)[:2])
        m.release(0)
        assert m.quantized_blocks() == 2            # parked, content kept
        hit = m.admit(1, np.concatenate([p, _prompt(2, 6)]), 18,
                      max_new_tokens=4)
        assert hit == 16 and list(m.chain(1)[:2]) == demoted
    _same(mgrs)


def test_mixed_eviction_resets_dtype_and_bytes():
    mgrs = _mgrs(num_blocks=6, kv_dtype="mixed")    # 5 usable
    p = _prompt(16, 7)
    for m in mgrs:
        m.set_block_nbytes({"bf16": 1000, "int8": 300})
        m.admit(0, p, p.size, max_new_tokens=4)     # 3 blocks, 2 demoted
        m.release(0)                                # 2 parked + 1 freed
        assert m.quantized_blocks() == 2
        # the 4-block admission evicts the parked pair (tags reset) while
        # the new prompt's 3 full blocks demote at their registration
        m.admit(1, _prompt(25, 8), 25, max_new_tokens=6)
        assert m.quantized_blocks() == 3
        assert [m.block_dtype(b) for b in m.chain(1)] == \
            ["int8"] * 3 + ["bf16"]
    port = _same(mgrs)
    assert port.stats["bytes_by_dtype"] == {"int8": 3 * 300,
                                            "bf16": 1 * 1000}
    assert int(mgrs[1]._g_bytes["int8"].value()) == 3 * 300
    assert int(mgrs[1]._g_bytes["bf16"].value()) == 1 * 1000


def test_fresh_block_tracking_excludes_cow_destinations():
    """drain_fresh: appended blocks are fresh, COW destinations are not
    (on an int8 pool, both managers)."""
    p = _prompt(16, 9)
    got = []
    for m in _mgrs(kv_dtype="int8"):
        m.admit(0, p, p.size, max_new_tokens=4)
        fresh = m.drain_fresh()
        assert sorted(fresh) == sorted(m.chain(0))
        assert m.drain_fresh() == []
        m.admit(1, np.concatenate([p, _prompt(3, 10)]), 19, max_new_tokens=4)
        m.drain_fresh()
        src, dst = m.ensure_writable(1, 1)
        assert dst not in m.drain_fresh()
        got.append((fresh, src, dst))
    assert got[0] == got[1]


# ---- 2. the demote op against _demote_impl ------------------------------------

@pytest.fixture(scope="module")
def pair():
    pt.seed(7)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    return jm, tm


PARITY_PROMPTS = [_prompt(n, 60 + n) for n in (5, 12, 3, 20)]


def _serve(model, kw, prompts, n_new=12):
    kw = dict({"num_slots": 3, "max_length": MAXLEN, "prefill_batch": 2},
              **kw)
    if isinstance(model, LlamaForCausalLM):
        eng = ServingEngine(model, device="cpu", **kw)
    else:
        eng = JaxEngine(model, **kw)
    rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    out = dict(eng.drain())
    return [out[r] for r in rids], eng


@pytest.fixture(scope="module")
def jax_mixed(pair):
    """The JAX mixed wave engine on the parity prompts: (tokens, engine)."""
    jm, _ = pair
    return _serve(jm, dict(paged=True, block_len=BL,
                           kv_cache_dtype="mixed"), PARITY_PROMPTS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_demote_op_bit_exact_to_the_reference(jax_mixed, dtype):
    """Every block of a seeded pool (L 2, 6 blocks of 8, 2 KV heads, D 16;
    values spread over 1e-3..1e2, one head of block 3 all zero) demoted by
    the port's op and by the JAX engine's ``_demote_impl``: the same bits,
    and the op built once."""
    _, jeng = jax_mixed
    rng = np.random.default_rng(3)
    shape = (2, 2, 6, BL, 2, 16)
    x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(
        -3, 2, (1, 2, 6, 1, 2, 1))).astype(np.float32)
    x[:, :, 3, :, 1] = 0.0
    tdt = getattr(torch, dtype)
    pool = torch.from_numpy(x.copy()).to(tdt)
    op = _DemoteOp(pool, engine_id="test_demote_" + dtype)
    # a copy: jnp.asarray may share a float32 array's memory, which the
    # port's op then rewrites in place
    want = jnp.asarray(pool.float().numpy().copy()).astype(
        getattr(jnp, dtype))
    for bid in range(1, 6):
        op(bid)
        want = jeng._demote_fn(want, jnp.int32(bid))
    got = pool.float().numpy()
    ref = np.asarray(want.astype(jnp.float32))
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert op.traces == 1
    # the demoted values differ from the input (the op did something),
    # the untouched null block does not
    assert not np.array_equal(got[:, :, 1:], x[:, :, 1:])
    assert np.array_equal(got[:, :, 0],
                          torch.from_numpy(x[:, :, 0]).to(tdt).float()
                          .numpy())


# ---- 3. the engine against the JAX mixed engine --------------------------------

def _kv(eng):
    m = eng.metrics()["kv_cache"]
    return {k: m[k] for k in ("kv_dtype", "quantized_blocks",
                              "bytes_by_dtype", "prefix_hit_tokens")}


def test_mixed_mode_parity_demotion_and_accounting(pair, jax_mixed):
    """The port's mixed engine serves the JAX mixed engine's tokens while
    demoting exactly the cold full prefix blocks; the demotion counter,
    the manager's tags and ``bytes_by_dtype`` agree with it."""
    _, tm = pair
    want, jeng = jax_mixed
    got, eng = _serve(tm, dict(paged=True, block_len=BL,
                               kv_cache_dtype="mixed"), PARITY_PROMPTS)
    assert got == want
    assert eng.step_traces == 1 and eng.demote_traces == 1
    assert eng._pending_demote == []            # every demotion applied
    mk = eng.metrics()["kv_cache"]
    assert mk["kv_dtype"] == "mixed"
    # prompts of 12 and 20 tokens hold 1 + 2 cold full prefix blocks
    assert mk["quantized_blocks"] == 3
    assert mk["demoted_blocks"] == int(jeng._m_demoted.value()) == 3
    per_block = eng.kv._block_nbytes
    assert per_block == jeng.kv._block_nbytes
    assert mk["bytes_by_dtype"]["int8"] == 3 * per_block["int8"]
    jk = jeng.metrics()["kv_cache"]
    assert mk["bytes_by_dtype"] == jk["bytes_by_dtype"]
    assert mk["quantized_blocks"] == jk["quantized_blocks"]
    assert eng.kv._dtype.tolist() == jeng.kv._dtype.tolist()


def test_mixed_chunked_parity(pair):
    """``mixed`` x ``chunked`` (4-token chunks, a shared 17-token prompt
    so later requests adopt demoted blocks): tokens, demotions and the
    pool's accounting equal the JAX mixed chunked engine's."""
    jm, tm = pair
    sys_p = _prompt(17, 70)
    prompts = PARITY_PROMPTS + [np.concatenate([sys_p, _prompt(n, 71 + n)])
                                for n in (3, 6)]
    kw = dict(paged=True, block_len=BL, kv_cache_dtype="mixed",
              chunked=True, prefill_chunk=4)
    want, jeng = _serve(jm, kw, prompts)
    got, eng = _serve(tm, kw, prompts)
    assert got == want
    assert _kv(eng) == _kv(jeng)
    assert _kv(eng)["prefix_hit_tokens"] > 0
    assert eng.metrics()["kv_cache"]["demoted_blocks"] == int(
        jeng._m_demoted.value()) > 0
    assert eng.kv._dtype.tolist() == jeng.kv._dtype.tolist()
    assert eng.step_traces == 1 and eng.demote_traces == 1
