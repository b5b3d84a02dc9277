"""The port's paged attention and paged Llama decode against the JAX
package, on the CPU.

The plain version of K1-paged and K2-paged
(``cached_decode_attention_reference`` with ``block_tables``) is held
against the Pallas flash-decode kernel in interpret mode with the block
table (the reference's paged scalar-prefetch mode, which requires
``block_len % 128 == 0``) and against the JAX XLA gather path, at float32,
tolerance 1e-5 (the two libraries sum in other orders).  The pools are
built so a kernel cannot pass by accident: physical blocks shuffled across
the pool, two rows sharing their first blocks, null-filled dead tails; the
q-tiled case has ``s * G > 64`` so the Pallas kernel walks ``nq > 1`` q
tiles; head dims 16, 32, 64, 72 and 128, the ones below 128 at 8 query
heads a KV head too.  Then the tiny model's paged ``decode_step`` against the JAX
model's: a prefix prefill at 0, a suffix prefill at per-row ``pos > 0``
and incremental steps, logits and pool within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.ops.attention import (
    cached_decode_attention_reference as jax_decode_ref)
from paddle_tpu.ops.pallas.decode_attention import decode_attention_pallas
from paddle_tpu.serving.kv_cache import (
    init_paged_kv_cache as jax_init_pool)

from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.ops import (_dispatch, cached_decode_attention,
                                  cached_decode_attention_reference,
                                  decode_attention_paged_cuda,
                                  flash_attention_fwd_paged_cuda)
from paddle_tpu_torch.serving.kv_cache import init_paged_kv_cache

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def paged_tables(pos, s, block_len, max_blocks, num_blocks, seed,
                 share=(0, 1, 1)):
    """A (B, max_blocks) table for rows reading keys [0, pos_b + s):
    physical blocks drawn shuffled from 1..num_blocks-1, rows ``share[0]``
    and ``share[1]`` sharing their first ``share[2]`` blocks, the dead tail
    null (0)."""
    rng = np.random.default_rng(seed)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    b = len(pos)
    need = [min(max_blocks, -(-(int(p) + s) // block_len)) for p in pos]
    tables = np.zeros((b, max_blocks), np.int32)
    for r in range(b):
        for j in range(need[r]):
            tables[r, j] = free.pop()
    r0, r1, n = share
    n = min(n, need[r0], need[r1])
    tables[r1, :n] = tables[r0, :n]
    return tables


# (b, s, hq, hkv, d, pos, max_blocks): s = 1 decode; s = 20 with G = 4 is
# s * G = 80 > 64 query rows, so the Pallas kernel walks two q tiles
PAGED_CASES = [
    (3, 1, 8, 2, 32, [0, 300, 129], 3),
    (2, 1, 4, 4, 16, [255, 40], 2),
    (3, 20, 8, 2, 32, [5, 200, 130], 2),
    (2, 9, 4, 2, 16, [0, 120], 2),
    # float32 at head_dim 128 (LlamaConfig(), Qwen2VLConfig()'s decoder):
    # the decode tick and a 5-token window
    (3, 1, 8, 2, 128, [0, 300, 129], 3),
    (2, 5, 4, 4, 128, [0, 120], 2),
    # head dims below 128 at TinyLlama's 8 query heads a KV head: 64, and
    # 72 (D % 16 == 8); s = 9 x G 8 = 72 rows walks two q tiles
    (3, 1, 8, 1, 64, [0, 300, 129], 3),
    (2, 9, 16, 2, 64, [0, 120], 2),
    (3, 1, 8, 1, 72, [7, 250, 128], 3),
    (2, 5, 16, 2, 72, [0, 130], 2),
]


@pytest.mark.parametrize("b,s,hq,hkv,d,pos,mb", PAGED_CASES)
def test_paged_plain_matches_pallas_and_xla(b, s, hq, hkv, d, pos, mb):
    bl, nb = 128, 9
    q = _rand((b, s, hq, d), 1)
    k_pool = _rand((nb, bl, hkv, d), 2)
    v_pool = _rand((nb, bl, hkv, d), 3)
    pos = np.asarray(pos, np.int32)
    tables = paged_tables(pos, s, bl, mb, nb, seed=4)
    assert (tables == 0).any()                       # a null dead tail
    want_pallas = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(pos), block_tables=jnp.asarray(tables), interpret=True)
    want_xla = jax_decode_ref(jnp.asarray(q), jnp.asarray(k_pool),
                              jnp.asarray(v_pool), jnp.asarray(pos),
                              block_tables=jnp.asarray(tables))
    got = cached_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(pos),
        block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **TOL)


def test_paged_plain_ignores_dead_tail_and_unreferenced_blocks():
    """Only the blocks a row's table names below ``pos + s`` matter:
    overwriting every other pool block (the null block included) with
    large finite garbage leaves the output bit-identical, and a scalar
    ``pos`` equals its per-row broadcast."""
    b, s, hq, hkv, d, bl, mb, nb = 2, 3, 4, 2, 16, 8, 4, 12
    q = _rand((b, s, hq, d), 5)
    kp, vp = _rand((nb, bl, hkv, d), 6), _rand((nb, bl, hkv, d), 7)
    pos = np.asarray([9, 9], np.int32)
    tables = paged_tables(pos, s, bl, mb, nb, seed=8, share=(0, 1, 1))
    args = [torch.from_numpy(x) for x in (q, kp, vp)]
    base = cached_decode_attention_reference(
        *args, torch.from_numpy(pos), block_tables=torch.from_numpy(tables))
    live = {int(tables[r, j]) for r in range(b)
            for j in range(-(-(int(pos[r]) + s) // bl))}
    kp2, vp2 = kp.copy(), vp.copy()
    for blk in set(range(nb)) - live:
        kp2[blk] = 1e4
        vp2[blk] = -1e4
    got = cached_decode_attention_reference(
        *[torch.from_numpy(x) for x in (q, kp2, vp2)], torch.from_numpy(pos),
        block_tables=torch.from_numpy(tables))
    assert torch.equal(got, base)
    scalar = cached_decode_attention_reference(
        *args, 9, block_tables=torch.from_numpy(tables))
    assert torch.equal(scalar, base)


def test_paged_plain_live_len_trims_table_columns():
    b, s, hq, hkv, d, bl, mb, nb = 2, 1, 4, 2, 16, 8, 6, 14
    q = _rand((b, s, hq, d), 9)
    kp, vp = _rand((nb, bl, hkv, d), 10), _rand((nb, bl, hkv, d), 11)
    pos = np.asarray([3, 20], np.int32)
    tables = paged_tables(pos, s, bl, mb, nb, seed=12)
    args = [torch.from_numpy(x) for x in (q, kp, vp, pos)]
    full = cached_decode_attention_reference(
        *args, block_tables=torch.from_numpy(tables))
    trimmed = cached_decode_attention_reference(
        *args, block_tables=torch.from_numpy(tables), live_len=21)
    want = jax_decode_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                          jnp.asarray(pos), block_tables=jnp.asarray(tables),
                          live_len=21)
    np.testing.assert_allclose(trimmed.numpy(), full.numpy(), **TOL)
    np.testing.assert_allclose(trimmed.numpy(), np.asarray(want), **TOL)


def test_paged_routes_count_plain_on_cpu():
    _dispatch.reset_kernel_paths()
    q1, q4 = torch.zeros(1, 1, 2, 8), torch.zeros(1, 4, 2, 8)
    pool = torch.zeros(3, 8, 2, 8)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    cached_decode_attention(q1, pool, pool, 5, block_tables=table)
    cached_decode_attention(q4, pool, pool, 3, block_tables=table)
    assert dict(_dispatch.kernel_paths) == {
        ("decode_attention_paged", "plain"): 1,
        ("paged_prefill", "plain"): 1}


def test_paged_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 2, 16)
    pool = torch.zeros(3, 8, 2, 16)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError):
        decode_attention_paged_cuda(q, pool, pool, 0, table)
    with pytest.raises(ValueError):
        flash_attention_fwd_paged_cuda(q, pool, pool, 0, table)


def test_init_paged_kv_cache_matches_reference():
    cfg = config_from(jax_tiny())
    pool = init_paged_kv_cache(cfg, 5, 8, device="cpu")
    jpool = jax_init_pool(jax_tiny(), 5, 8)
    assert tuple(pool.shape) == tuple(jpool.shape)
    assert pool.dtype == torch.float32 and not pool.any()
    q = init_paged_kv_cache(cfg, 5, 8, quantized=True, device="cpu")
    jq = jax_init_pool(jax_tiny(), 5, 8, quantized=True)
    for key, dt in (("kv", torch.int8), ("scale", torch.float32)):
        assert tuple(q[key].shape) == tuple(jq[key].shape)
        assert q[key].dtype == dt and not q[key].any()


# ---- the model: paged decode_step vs the JAX model's --------------------------

BL, MB, NB = 8, 6, 16         # tiny model: 48-token logical rows


@pytest.fixture(scope="module")
def pair():
    pt.seed(5)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    return jm, tm


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def test_paged_decode_step_matches_jax(pair):
    """A paged session through both models on shuffled, shared tables:
    prefix prefill at pos 0 (s = 16), a suffix prefill at per-row pos
    [16, 8] (s = 8: row 1 re-reads the block it shares with row 0 and
    writes pad positions past its real suffix), then two single-token
    steps at per-row positions — logits and the whole pool within
    1e-5 at every step."""
    jm, tm = pair
    tables = paged_tables(np.asarray([40, 40]), 0, BL, MB, NB, seed=13,
                          share=(0, 1, 1))
    jpool = jax_init_pool(jm.config, NB, BL)
    tpool = init_paged_kv_cache(tm.config, NB, BL, device="cpu")
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    steps = [(_ids(2, 16, 1), np.asarray([0, 0], np.int32)),
             (_ids(2, 8, 2), np.asarray([16, 8], np.int32)),
             (_ids(2, 1, 3), np.asarray([24, 12], np.int32)),
             (_ids(2, 1, 4), np.asarray([25, 13], np.int32))]
    for i, (ids, pos) in enumerate(steps):
        jpos = 0 if i == 0 else jnp.asarray(pos)
        tpos = 0 if i == 0 else torch.from_numpy(pos)
        jl, jpool = jm.decode_step(jnp.asarray(ids), jpool, jpos,
                                   block_tables=jt)
        with torch.no_grad():
            tl, tpool = tm.decode_step(torch.from_numpy(ids), tpool, tpos,
                                       block_tables=tt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), **TOL)


def test_paged_pads_past_the_table_go_to_the_null_block(pair):
    """A suffix bucket running past the table's coverage (and past the
    RoPE cache): the pad writes land in block 0 only; every block the
    row owns holds exactly what the JAX model wrote."""
    jm, tm = pair
    tables = np.asarray([[3, 7, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0]], np.int32)
    ids = _ids(2, 64, 6)
    pos = np.asarray([4, 100], np.int32)        # row 1: past everything
    jpool = jax_init_pool(jm.config, NB, BL)
    tpool = init_paged_kv_cache(tm.config, NB, BL, device="cpu")
    jl, jpool = jm.decode_step(jnp.asarray(ids), jpool, jnp.asarray(pos),
                               block_tables=jnp.asarray(tables))
    with torch.no_grad():
        tl, tpool = tm.decode_step(torch.from_numpy(ids), tpool,
                                   torch.from_numpy(pos),
                                   block_tables=torch.from_numpy(tables))
    assert torch.isfinite(tl).all()
    tp, jp = tpool.numpy(), np.asarray(jpool)
    np.testing.assert_allclose(tp[:, :, 1:], jp[:, :, 1:], **TOL)
    assert not tp[:, :, [b for b in range(1, NB) if b not in (3, 7)]].any()
    # the row's real positions 4..15 attend only real keys: equal logits
    np.testing.assert_allclose(tl.numpy()[0, :12], np.asarray(jl)[0, :12],
                               **TOL)
