"""The chunked engine's device side on the CPU: dropped writes, the
contiguous chunk through the identity view, and the mixed step.

  * **Dropped writes.**  A chunk-free tick (the decode step with rows that
    are not decoding: contiguous at ``max_length``, paged on an all-null
    table) and a chunk whose pad tail passes ``max_length`` leave every
    payload byte and every scale they do not write bit-identical — in
    both layouts, model dtype and int8.  The int8 contiguous case holds a
    granule whose scale is 0 over stale payload (a row reused by a new
    prompt), which a dropped token must not clear.
  * **The identity view.**  The contiguous cache read as a pool under its
    identity table (``ops.attention.identity_view``), the route of a
    contiguous chunk, matches ``decode_attention_pallas(interpret=True)``
    in its q-tiled contiguous mode (s > ``_MAX_Q_ROWS // G``, per-row
    positions, one row's queries past the cache's end; int8 with
    128-token granules), and so does ``cached_decode_attention(rows=)``
    with the rows permuted.
  * **The mixed step.**  ``MixedStep`` run eagerly equals two plain
    ``decode_step`` calls — the decode rows, then the chunk — on a copy
    of the cache: decode logits and the cache exactly, the chunk's logits
    at ``len - 1`` to float32 sum order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import (_MAX_Q_ROWS,
                                                    decode_attention_pallas)

from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
from paddle_tpu_torch.models.generation import init_kv_cache
from paddle_tpu_torch.ops import _dispatch
from paddle_tpu_torch.ops.attention import (cached_decode_attention,
                                            cached_decode_attention_reference,
                                            identity_tables, identity_view)
from paddle_tpu_torch.serving.kv_cache import init_paged_kv_cache
from paddle_tpu_torch.serving.step_graph import DecodeStep, MixedStep

L = 256              # two 128-token int8 granules a row
B = 3
BL = 32              # paged block_len: 8 blocks a row
NB = 30
CHUNK = 12
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    return LlamaForCausalLM(tiny_llama_config(max_position_embeddings=L),
                            device="cpu", seed=5)


def _random_cache(config, paged: bool, int8: bool, seed: int):
    g = torch.Generator().manual_seed(seed)
    if paged:
        cache = init_paged_kv_cache(config, NB, BL, quantized=int8,
                                    device="cpu")
    else:
        cache = init_kv_cache(config, B, L, quantized=int8, device="cpu")
    if int8:
        kv, sc = cache["kv"], cache["scale"]
        kv.copy_(torch.randint(-127, 128, kv.shape, generator=g,
                               dtype=torch.int8))
        sc.copy_(0.01 + 0.05 * torch.rand(sc.shape, generator=g))
        if not paged:
            sc[:, :, 2, 0] = 0.0     # a zero-scale granule over stale bytes
    else:
        cache.copy_(torch.randn(cache.shape, generator=g))
    return cache


def _clone(cache):
    return ({k: t.clone() for k, t in cache.items()}
            if isinstance(cache, dict) else cache.clone())


def _parts(cache):
    """(payload (layers, 2, units, unit_len, ...), scales or None)."""
    if isinstance(cache, dict):
        return cache["kv"], cache["scale"]
    return cache, None


# paged: row 0's chain; row 2's chain covers all 8 blocks (the chunk's)
_CHAIN0 = [3, 7, 11]
_CHAIN2 = [20, 21, 22, 23, 24, 25, 26, 27]


def _steps(model, cache, paged, tag):
    step = DecodeStep(model, cache, B, L // BL if paged else None,
                      torch.device("cpu"), f"drop-{tag}", graph="decode")
    mixed = MixedStep(step, CHUNK, L // BL if paged else None, f"drop-{tag}")
    step.build()
    mixed.build()
    # row 0 decodes at position 70 (block 2 of its chain); rows 1 and 2 do
    # not decode: contiguous at L, paged on all-null tables at 0
    step.tokens_host[:] = [5, 0, 0]
    step.positions_host[:] = [70, 0, 0] if paged else [70, L, L]
    if paged:
        step.tables_host[:] = 0
        step.tables_host[0, :3] = _CHAIN0
    return step, mixed


def _unwritten_equal(before, after, paged, chunk: bool):
    """Every payload byte and scale the step was not meant to write is
    bit-identical: contiguous — rows 1 and 2 (and, with the chunk, row
    2's positions below the chunk's granule / position); paged — every
    block but the null block, row 0's written block and the chunk's last
    block."""
    kb, sb = _parts(before)
    ka, sa = _parts(after)
    if paged:
        keep = torch.ones(NB, dtype=torch.bool)
        keep[[0, _CHAIN0[2]]] = False
        if chunk:
            keep[_CHAIN2[-1]] = False
        assert torch.equal(kb[:, :, keep], ka[:, :, keep])
        if sb is not None:
            assert torch.equal(sb[:, :, keep], sa[:, :, keep])
        return
    assert torch.equal(kb[:, :, 1], ka[:, :, 1])
    if sb is not None:
        assert torch.equal(sb[:, :, 1], sa[:, :, 1])
    if not chunk:
        assert torch.equal(kb[:, :, 2], ka[:, :, 2])
        if sb is not None:
            assert torch.equal(sb[:, :, 2], sa[:, :, 2])
        return
    # the chunk writes row 2 from L - 4 on: int8 may rescale that
    # granule (128 .. 255), never granule 0; bf16 touches nothing below
    below = 128 if sb is not None else L - 4
    assert torch.equal(kb[:, :, 2, :below], ka[:, :, 2, :below])
    if sb is not None:
        assert torch.equal(sb[:, :, 2, 0], sa[:, :, 2, 0])
    assert not torch.equal(kb[:, :, 2, below:], ka[:, :, 2, below:])


@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_dropped_writes_leave_unwritten_bytes(model, paged, int8):
    tag = f"{'paged' if paged else 'contiguous'}-{int8}"
    cache = _random_cache(model.config, paged, int8, seed=11)
    step, mixed = _steps(model, cache, paged, tag)
    # a chunk-free tick
    before = _clone(cache)
    step.run()
    _unwritten_equal(before, cache, paged, chunk=False)
    kb, _ = _parts(before)
    ka, _ = _parts(cache)
    assert not torch.equal(kb, ka)          # row 0 did write
    # a chunk of 3 real tokens at L - 4 into row 2: its pad tail runs to
    # L + 7, past max_length (contiguous: dropped; paged: past the table)
    mixed.ids_host[:] = 0
    mixed.ids_host[:3] = [9, 8, 7]
    mixed.pos_host[0] = L - 4
    mixed.len_host[0] = 3
    if paged:
        mixed.table_host[:] = _CHAIN2
    else:
        mixed.row_host[0] = 2
    before = _clone(cache)
    _, _, clogits, _ = mixed.run()
    assert torch.isfinite(clogits).all()
    _unwritten_equal(before, cache, paged, chunk=True)


@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_mixed_step_equals_two_decode_steps(model, paged, int8):
    tag = f"{'paged' if paged else 'contiguous'}-{int8}"
    cache = _random_cache(model.config, paged, int8, seed=12)
    step, mixed = _steps(model, cache, paged, f"two-{tag}")
    ids = np.arange(CHUNK, dtype=np.int32) + 30
    mixed.ids_host[:] = ids
    mixed.pos_host[0] = 40
    mixed.len_host[0] = 10
    if paged:
        mixed.table_host[:] = _CHAIN2
    else:
        mixed.row_host[0] = 2
    copy = _clone(cache)
    tokens = torch.from_numpy(step.tokens_host.copy())[:, None]
    positions = torch.from_numpy(step.positions_host.copy())
    tables = (torch.from_numpy(step.tables_host.copy()) if paged else None)
    logits, greedy, clogits, cgreedy = mixed.run()
    with torch.no_grad():
        want, copy = model.decode_step(tokens, copy, positions,
                                       block_tables=tables)
        cw, copy = model.decode_step(
            torch.from_numpy(ids)[None], copy, torch.tensor([40]),
            block_tables=(torch.tensor(_CHAIN2)[None] if paged else None),
            rows=None if paged else torch.tensor([2]))
    assert torch.equal(logits, want[:, -1])
    assert torch.equal(greedy, want[:, -1].argmax(-1))
    torch.testing.assert_close(clogits, cw[:, 9], rtol=1e-6, atol=1e-6)
    assert torch.equal(cgreedy, cw[:, 9].argmax(-1))
    for a, b in zip(*(([c[k] for k in sorted(c)] if isinstance(c, dict)
                       else [c]) for c in (cache, copy))):
        assert torch.equal(a, b)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
def test_identity_view_matches_pallas_q_tiled(int8):
    """s = 40 at G = 4 walks three q tiles of 16 rows (> _MAX_Q_ROWS //
    G); row 2's queries pass the cache's end (a chunk's pad tail)."""
    b, s, hq, hkv, d = 3, 40, 8, 2, 32
    assert s > _MAX_Q_ROWS // (hq // hkv)
    pos = np.asarray([0, 100, 230], np.int32)
    q = _rand((b, s, hq, d), 1)
    kw = {}
    if int8:
        rng = np.random.default_rng(2)
        kc = rng.integers(-127, 128, (b, L, hkv, d)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, L, hkv, d)).astype(np.int8)
        ks = (0.002 + 0.02 * rng.random((b, 2, hkv))).astype(np.float32)
        vs = (0.002 + 0.02 * rng.random((b, 2, hkv))).astype(np.float32)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = _rand((b, L, hkv, d), 3), _rand((b, L, hkv, d), 4)
    want = np.asarray(decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, kc, vc, pos)), interpret=True,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    t = {k: torch.from_numpy(v) for k, v in kw.items()}
    kp, vp, kps, vps, bl = identity_view(torch.from_numpy(kc),
                                         torch.from_numpy(vc),
                                         t.get("k_scale"), t.get("v_scale"))
    assert bl == (128 if int8 else 64)
    tables = identity_tables(torch.arange(b), L, bl)
    assert tables.shape == (b, L // bl) and int(tables[2, 0]) == 2 * L // bl
    got = cached_decode_attention_reference(
        torch.from_numpy(q), kp, vp, torch.from_numpy(pos),
        block_tables=tables, k_scale=kps, v_scale=vps)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the dispatcher's route for rows (a chunk addressed by cache row):
    # query row r reads cache row rows[r]
    rows = torch.tensor([1, 2, 0])
    _dispatch.reset_kernel_paths()
    got = cached_decode_attention(
        torch.from_numpy(q)[rows], torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(pos)[rows], rows=rows, **t)
    op = "paged_prefill" + ("_int8" if int8 else "")
    assert dict(_dispatch.kernel_paths) == {(op, "plain"): 1}
    np.testing.assert_allclose(got.numpy(), want[rows.numpy()], **TOL)
