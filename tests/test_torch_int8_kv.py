"""The port's int8 KV cache against the JAX package's, on the CPU.

* The two scatter-time quantized writes (``models/llama.py``
  ``quantized_paged_write`` / ``quantized_contiguous_write``) leave payload
  and scales EXACTLY equal to the reference's jitted
  ``_quantized_paged_write`` / ``_quantized_contiguous_write``: several
  tokens a block (duplicate scatter indices), scales that grow over an
  existing payload, fresh blocks at scale 0, all-zero tokens, pad tokens
  steered to the null block, and a suffix starting on a block boundary.
* The int8 plain attention (``cached_decode_attention_reference`` with
  ``k_scale`` / ``v_scale``, the plain version of K1-int8, K1-paged-int8
  and K2-paged-int8) against ``decode_attention_pallas(..., k_scale,
  v_scale, interpret=True)`` and the JAX XLA dequant path at float32,
  tolerance 1e-5 (the libraries sum in other orders): paged at block_len
  128 for s = 1 and s > 1, contiguous with 128-token granules.
* The tiny model's int8 ``decode_step``, both layouts, logits within 1e-5
  of the JAX model's at every step of a session.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.models.generation import init_kv_cache as jax_init_cache
from paddle_tpu.ops.attention import (
    cached_decode_attention_reference as jax_decode_ref)
from paddle_tpu.ops.pallas.decode_attention import decode_attention_pallas
from paddle_tpu.serving.kv_cache import init_paged_kv_cache as jax_init_pool

from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     init_kv_cache, load_jax_state_dict)
from paddle_tpu_torch.models.generation import scale_granules
from paddle_tpu_torch.models.llama import (quantized_contiguous_write,
                                           quantized_paged_write)
from paddle_tpu_torch.ops import (_dispatch, cached_decode_attention,
                                  decode_attention_int8_cuda,
                                  decode_attention_paged_int8_cuda,
                                  flash_attention_fwd_paged_int8_cuda)
from paddle_tpu_torch.serving.kv_cache import init_paged_kv_cache

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(
        np.int8)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the quantized writes --------------------------------------------------------

L_, HKV, D = 2, 2, 16


def _pool_state(nb, bl, seed):
    """A used int8 pool: random payload, small positive scales (so new
    tokens grow them), two blocks fresh (scale 0)."""
    kv = _int8((L_, 2, nb, bl, HKV, D), seed)
    sc = np.abs(_rand((L_, 2, nb, HKV), seed + 1, 0.01)).astype(np.float32)
    sc[:, :, [4, 6]] = 0.0
    return kv, sc


@pytest.mark.parametrize("pos,s", [((5, 20), 12), ((8, 0), 9), ((3, 9), 1)])
def test_quantized_paged_write_equals_jax(pos, s):
    """Row 0 spans several blocks from ``pos[0]``; row 1's tokens past its
    3-column table land in the null block (once each per cell); token 2
    of row 0 is all zeros; K and V of both layers, the reference writing
    K then V, the port both in one pass, as each model writes them."""
    nb, bl, mb = 9, 8, 3
    kv, sc = _pool_state(nb, bl, 1)
    tables = np.asarray([[3, 7, 2], [5, 4, 6]], np.int32)
    position_ids = np.asarray(pos)[:, None] + np.arange(s)[None]
    lb = position_ids // bl
    phys = np.where(lb < mb, tables[np.arange(2)[:, None],
                                    np.minimum(lb, mb - 1)], 0)
    phys = phys.astype(np.int32)
    off = (position_ids % bl).astype(np.int32)
    jkv, jsc = jnp.asarray(kv), jnp.asarray(sc)
    tkv, tsc = _t(kv), _t(sc)
    for idx in range(L_):
        kv_new = []
        for kvsl in (0, 1):
            x = _rand((2, s, HKV, D), 10 * idx + kvsl, 2.0)
            if s > 2:
                x[0, 2] = 0.0
            jkv, jsc = jllama._quantized_paged_write(
                jkv, jsc, idx, kvsl, jnp.asarray(x), jnp.asarray(phys),
                jnp.asarray(off))
            kv_new.append(_t(x))
        quantized_paged_write(tkv, tsc, idx, *kv_new, _t(phys), _t(off))
    assert (np.asarray(jsc) != sc).any()             # some scales grew
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jkv))


def test_quantized_paged_write_duplicates_write_the_last_token():
    """Tokens of two rows past their 1-column tables all land in the null
    block, at the same cells (a padded wave's tail): every cell holds the
    bytes of the LAST token written there, as JAX's scatter leaves it --
    the same bytes every run, where an index write on the card would pick
    among the duplicates in no fixed order."""
    nb, bl = 9, 8
    kv, sc = _pool_state(nb, bl, 3)
    tables = np.asarray([[3], [5]], np.int32)
    s = 20                                 # positions 4..23: 4..7 in-table
    position_ids = np.asarray([4, 4])[:, None] + np.arange(s)[None]
    lb = position_ids // bl
    phys = np.where(lb < 1, tables[np.arange(2)[:, None], 0], 0)
    phys = phys.astype(np.int32)
    off = (position_ids % bl).astype(np.int32)
    jkv, jsc = jnp.asarray(kv), jnp.asarray(sc)
    tkv, tsc = _t(kv), _t(sc)
    xs = [_rand((2, s, HKV, D), 40 + kvsl, 2.0) for kvsl in (0, 1)]
    for kvsl in (0, 1):
        jkv, jsc = jllama._quantized_paged_write(
            jkv, jsc, 0, kvsl, jnp.asarray(xs[kvsl]), jnp.asarray(phys),
            jnp.asarray(off))
    quantized_paged_write(tkv, tsc, 0, _t(xs[0]), _t(xs[1]), _t(phys),
                          _t(off))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jkv))
    # the null block's cell of position 23 (row 1's last token) holds that
    # token quantized under the block's final scale
    null_k = tkv[0, 0, 0].float()
    want = torch.round(_t(xs[0])[1, s - 1]
                       / tsc[0, 0, 0][:, None]).clamp(-127, 127)
    np.testing.assert_array_equal(null_k[23 % bl].numpy(), want.numpy())


@pytest.mark.parametrize("per_row", [True, False])
def test_quantized_contiguous_write_equals_jax(per_row):
    """Granules of 8 positions (n_gran 4 over 32): rows write 11 tokens
    from per-row offsets 0 and 13 (or the scalar 6), over a used cache
    whose granule 1 of row 0 is fresh."""
    b, max_len, n_gran, s = 2, 32, 4, 11
    kv = _int8((L_, 2, b, max_len, HKV, D), 3)
    sc = np.abs(_rand((L_, 2, b, n_gran, HKV), 4, 0.01)).astype(np.float32)
    sc[:, :, 0, 1] = 0.0
    start = np.asarray([0, 13]) if per_row else np.asarray([6])
    position_ids = (start[:, None] + np.arange(s)[None]).astype(np.int32)
    jkv, jsc = jnp.asarray(kv), jnp.asarray(sc)
    tkv, tsc = _t(kv), _t(sc)
    for idx in range(L_):
        kv_new = []
        for kvsl in (0, 1):
            x = _rand((b, s, HKV, D), 20 * idx + kvsl, 2.0)
            x[1, 4] = 0.0
            jkv, jsc = jllama._quantized_contiguous_write(
                jkv, jsc, idx, kvsl, jnp.asarray(x), jnp.asarray(position_ids))
            kv_new.append(_t(x))
        quantized_contiguous_write(tkv, tsc, idx, *kv_new, _t(position_ids))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jkv))


def test_init_kv_cache_quantized_matches_reference():
    cfg = config_from(jax_tiny())
    for max_len in (64, 256):
        c = init_kv_cache(cfg, 2, max_len, quantized=True, device="cpu")
        jc = jax_init_cache(jax_tiny(), 2, max_len, quantized=True)
        for key, dt in (("kv", torch.int8), ("scale", torch.float32)):
            assert tuple(c[key].shape) == tuple(jc[key].shape)
            assert c[key].dtype == dt and not c[key].any()
        assert c["scale"].shape[3] == scale_granules(max_len)
    assert scale_granules(256) == 2 and scale_granules(64) == 1


# ---- the int8 plain attention vs the Pallas kernel ---------------------------------

# (b, s, hq, hkv, d, pos, max_blocks); s = 20 with G = 4 walks two q tiles
PAGED_CASES = [
    (3, 1, 8, 2, 32, [0, 300, 129], 3),
    (3, 20, 8, 2, 32, [5, 200, 130], 2),
    # float32 q at head_dim 128 (LlamaConfig()): the tick and s = 5
    (3, 1, 8, 2, 128, [0, 300, 129], 3),
    (2, 5, 4, 4, 128, [5, 200], 2),
    # TinyLlama's head_dim 64 and 72 (an int8 row of D % 16 == 8 bytes), 8
    # query heads a KV head; s = 9 x G 8 = 72 rows walks two q tiles
    (3, 1, 8, 1, 64, [0, 300, 129], 3),
    (2, 9, 16, 2, 64, [5, 200], 2),
    (3, 1, 8, 1, 72, [7, 250, 128], 3),
    (2, 5, 16, 2, 72, [0, 130], 2),
]


@pytest.mark.parametrize("b,s,hq,hkv,d,pos,mb", PAGED_CASES)
def test_paged_int8_plain_matches_pallas_and_xla(b, s, hq, hkv, d, pos, mb):
    bl, nb = 128, 9
    q = _rand((b, s, hq, d), 1)
    kp, vp = _int8((nb, bl, hkv, d), 2), _int8((nb, bl, hkv, d), 3)
    ks = np.abs(_rand((nb, hkv), 4, 0.02)).astype(np.float32)
    vs = np.abs(_rand((nb, hkv), 5, 0.02)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    rng = np.random.default_rng(6)
    tables = np.zeros((b, mb), np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    for r in range(b):
        for j in range(min(mb, -(-(int(pos[r]) + s) // bl))):
            tables[r, j] = free.pop()
    tables[1, 0] = tables[0, 0]                       # a shared block
    args = [jnp.asarray(a) for a in (q, kp, vp, pos)]
    want_pallas = decode_attention_pallas(
        *args, block_tables=jnp.asarray(tables), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), interpret=True)
    want_xla = jax_decode_ref(*args, block_tables=jnp.asarray(tables),
                              k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    _dispatch.reset_kernel_paths()
    got = cached_decode_attention(_t(q), _t(kp), _t(vp), _t(pos),
                                  block_tables=_t(tables), k_scale=_t(ks),
                                  v_scale=_t(vs))
    op = "decode_attention_paged_int8" if s == 1 else "paged_prefill_int8"
    assert dict(_dispatch.kernel_paths) == {(op, "plain"): 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **TOL)


@pytest.mark.parametrize("s,pos", [(1, [0, 255, 130]), (3, [7, 140, 200])])
def test_contiguous_int8_plain_matches_pallas_and_xla(s, pos):
    _contiguous_int8_case(s, pos, 32)


@pytest.mark.parametrize("s,pos", [(1, [0, 255, 130]), (5, [7, 140, 200])])
def test_contiguous_int8_plain_matches_pallas_at_head_dim_128(s, pos):
    """float32 q over the int8 cache at LlamaConfig()'s head_dim."""
    _contiguous_int8_case(s, pos, 128)


def _contiguous_int8_case(s, pos, d):
    b, hq, hkv, L, n_gran = 3, 8, 2, 256, 2            # 128-token granules
    q = _rand((b, s, hq, d), 7)
    kc, vc = _int8((b, L, hkv, d), 8), _int8((b, L, hkv, d), 9)
    ks = np.abs(_rand((b, n_gran, hkv), 10, 0.02)).astype(np.float32)
    vs = np.abs(_rand((b, n_gran, hkv), 11, 0.02)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    args = [jnp.asarray(a) for a in (q, kc, vc, pos)]
    want_pallas = decode_attention_pallas(
        *args, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        interpret=True)
    want_xla = jax_decode_ref(*args, k_scale=jnp.asarray(ks),
                              v_scale=jnp.asarray(vs))
    _dispatch.reset_kernel_paths()
    got = cached_decode_attention(_t(q), _t(kc), _t(vc), _t(pos),
                                  k_scale=_t(ks), v_scale=_t(vs))
    assert dict(_dispatch.kernel_paths) == {
        ("decode_attention_int8", "plain"): 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **TOL)


def test_int8_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 2, 16)
    kv = torch.zeros(1, 64, 2, 16, dtype=torch.int8)
    pool = torch.zeros(3, 8, 2, 16, dtype=torch.int8)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError):
        decode_attention_int8_cuda(q, kv, kv, 0, torch.ones(1, 1, 2),
                                   torch.ones(1, 1, 2))
    for fn in (decode_attention_paged_int8_cuda,
               flash_attention_fwd_paged_int8_cuda):
        with pytest.raises(ValueError):
            fn(q, pool, pool, 0, table, torch.ones(3, 2), torch.ones(3, 2))


# ---- the model: int8 decode_step vs the JAX model's ----------------------------------

@pytest.fixture(scope="module")
def pair():
    pt.seed(11)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    return jm, tm


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def _session(jm, tm, jcache, tcache, steps, tables=None):
    jt = None if tables is None else jnp.asarray(tables)
    tt = None if tables is None else _t(tables)
    for i, (ids, pos) in enumerate(steps):
        jpos = pos if isinstance(pos, int) else jnp.asarray(pos)
        tpos = pos if isinstance(pos, int) else _t(pos)
        jl, jcache = jm.decode_step(jnp.asarray(ids), jcache, jpos,
                                    block_tables=jt)
        with torch.no_grad():
            tl, tcache = tm.decode_step(_t(ids), tcache, tpos,
                                        block_tables=tt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")
    return jcache, tcache


def test_int8_contiguous_decode_step_matches_jax(pair):
    """Prefill at pos 0 (flash over the fresh K/V, 128-token granules of a
    256-long row), then per-row steps that read the quantized cache."""
    jm, tm = pair
    jc = jax_init_cache(jm.config, 2, 256, quantized=True)
    tc = init_kv_cache(tm.config, 2, 256, quantized=True, device="cpu")
    steps = [(_ids(2, 12, 1), 0),
             (_ids(2, 1, 2), np.asarray([12, 12], np.int32)),
             (_ids(2, 3, 4), np.asarray([13, 13], np.int32))]
    jc, tc = _session(jm, tm, jc, tc, steps)
    np.testing.assert_allclose(tc["scale"].numpy(), np.asarray(jc["scale"]),
                               **TOL)


def test_int8_paged_decode_step_matches_jax(pair):
    """A paged int8 session on shuffled tables with null dead tails:
    prefix prefill at 0, suffix prefill at per-row pos [16, 8] (row 1's
    pads run into its next block), then a step."""
    jm, tm = pair
    nb, bl = 16, 8
    tables = np.asarray([[9, 3, 12, 5, 0, 0], [7, 14, 2, 0, 0, 0]], np.int32)
    jp = jax_init_pool(jm.config, nb, bl, quantized=True)
    tp = init_paged_kv_cache(tm.config, nb, bl, quantized=True, device="cpu")
    steps = [(_ids(2, 16, 5), np.asarray([0, 0], np.int32)),
             (_ids(2, 8, 6), np.asarray([16, 8], np.int32)),
             (_ids(2, 1, 7), np.asarray([24, 16], np.int32))]
    jp, tp = _session(jm, tm, jp, tp, steps, tables)
    live = sorted({int(t) for t in tables.ravel()} - {0})
    np.testing.assert_allclose(tp["scale"].numpy()[:, :, live],
                               np.asarray(jp["scale"])[:, :, live], **TOL)
