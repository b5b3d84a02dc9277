"""The paged prefill kernels' tile walk, on the CPU.

K2-paged and K2-paged-int8 (``csrc/flash_attention_fwd.cu``, the Hopper
kernel with ``PAGED``) give each CTA one 128-query tile of one row and
walk its 128-key tiles from the diagonal down, below kv_hi = min(kv_len,
q0 + 128 + pos_b), kv_len = min(pos_b + s, max_blocks * block_len).  A
key tile reaches shared memory as two 64-key boxes a tensor, each at a
(block id, row in block) read through the block table (``paged_boxes``);
a half at or past kv_len repeats the first half's box.  A tile that
crosses the diagonal or kv_len is flagged for the element mask; the
others are taken whole.  ``_walk`` restates that rule.  Properties, by
hypothesis over pos, s (1..300), block_len in {64, 128, 256}, max_blocks,
shuffled tables that share blocks and end in null (block 0) tails, and
rows whose pos + s passes max_blocks * block_len:

* every visible (query, key) pair lies in a visited tile;
* no unflagged tile holds a hidden pair or a key >= kv_len;
* no box reads a dead-tail table column or crosses a block boundary, and
  every key < kv_len of a visited tile comes from ``pool[table[b, j //
  block_len], j % block_len]``;
* the kernel's algorithm in plain torch (``_model``: the visited tiles'
  boxes gathered from the pool, the element mask on flagged tiles only,
  int8 with each half's block scales) equals the plain version.

Then, at fixed cases, ``_model`` against the JAX package's flash-decode
kernel (``decode_attention_pallas(..., interpret=True)``) at 1e-5: float32
inputs, bfloat16 inputs (the bf16 values computed in float32 by both: the
kernel's own bf16 rounding is held on the card), and int8 pools with
their float32 scales.  The Pallas kernel's paged mode takes block_len %
128 == 0; at block_len 64 the comparison is with its contiguous mode over
the gathered cache (float32) and with the JAX XLA path (int8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu.ops.attention import (
    cached_decode_attention_reference as jax_decode_ref)
from paddle_tpu.ops.pallas.decode_attention import decode_attention_pallas

from paddle_tpu_torch.ops.attention import cached_decode_attention_reference
from paddle_tpu_torch.ops.cuda.flash_attention import PAGED_BOX, SEG_TILE

TILE, BOX = SEG_TILE, PAGED_BOX        # 128 queries / keys, 64-key boxes
TOL = dict(rtol=1e-5, atol=1e-5)


def _boxes(trow, bl, k0, kv_len):
    """([(block, row)] x 2, [table column] x 2): the producer's two boxes
    of the key tile at k0 (``paged_boxes``)."""
    col0 = k0 // bl
    first = (int(trow[col0]), k0 % bl)
    if k0 + BOX >= kv_len:
        return [first, first], [col0, col0]
    if k0 % bl + BOX < bl:
        return [first, (first[0], first[1] + BOX)], [col0, col0]
    col1 = (k0 + BOX) // bl
    return [first, (int(trow[col1]), 0)], [col0, col1]


def _walk(pos, s, bl, mb, trow):
    """[(q0, [(jt, flagged, boxes, columns)])]: each q tile's key tiles in
    the producer's order (from the diagonal down)."""
    kv_len = min(pos + s, mb * bl)
    out = []
    for q0 in range(0, s, TILE):
        kv_hi = min(kv_len, q0 + TILE + pos)
        n_kt = -(-kv_hi // TILE) if kv_hi > 0 else 0
        tiles = []
        for jt in range(n_kt - 1, -1, -1):
            k0 = jt * TILE
            flagged = k0 + TILE - 1 > q0 + pos or k0 + TILE > kv_len
            tiles.append((jt, flagged) + _boxes(trow, bl, k0, kv_len))
        out.append((q0, tiles))
    return out


def _tables(rng, pos, s, bl, mb):
    """(B, mb) int32 tables for rows reading keys [0, min(pos_b + s, mb *
    bl)): live blocks drawn shuffled from 1.., the first blocks of rows 0
    and 1 shared, the dead tail null (0).  Returns (tables, live columns a
    row, pool size)."""
    need = [min(mb, -(-(p + s) // bl)) for p in pos]
    n_pool = sum(need) + 3
    free = list(rng.permutation(np.arange(1, n_pool)))
    tables = np.zeros((len(pos), mb), np.int32)
    for r, n in enumerate(need):
        tables[r, :n] = [free.pop() for _ in range(n)]
    if len(pos) > 1:
        n = int(rng.integers(0, min(need[0], need[1]) + 1))
        tables[1, :n] = tables[0, :n]
    return tables, need, n_pool


def _model(q, k_pool, v_pool, pos, tables, k_scale=None, v_scale=None):
    """The kernel's algorithm in float32 torch: per (row, q tile), the
    visited tiles' keys gathered box by box, the element mask on flagged
    tiles only (unflagged ones taken whole), int8 payloads times each
    half's block scale; one softmax over the visited keys."""
    b, s, hq, d = q.shape
    _, bl, hkv, _ = k_pool.shape
    g, mb = hq // hkv, tables.shape[1]
    out = torch.zeros(b, s, hq, d)
    qf = q.float().reshape(b, s, hkv, g, d) * d ** -0.5
    for r in range(b):
        p = int(pos[r])
        kv_len = min(p + s, mb * bl)
        for q0, tiles in _walk(p, s, bl, mb, tables[r]):
            rows = torch.arange(q0, min(q0 + TILE, s))
            ks, vs, keep = [], [], []
            for jt, flagged, boxes, _ in tiles:
                for h, (blk, row) in enumerate(boxes):
                    kt = k_pool[blk, row:row + BOX].float()
                    vt = v_pool[blk, row:row + BOX].float()
                    if k_scale is not None:
                        kt = kt * k_scale[blk][None, :, None]
                        vt = vt * v_scale[blk][None, :, None]
                    ks.append(kt)
                    vs.append(vt)
                    cols = jt * TILE + h * BOX + torch.arange(BOX)
                    m = torch.ones(len(rows), BOX, dtype=torch.bool)
                    if flagged:
                        m = (cols[None] < kv_len) & (cols[None]
                                                     <= p + rows[:, None])
                    keep.append(m)
            kk, vv, mask = torch.cat(ks), torch.cat(vs), torch.cat(keep, 1)
            sc = torch.einsum("skgd,lkd->kgsl", qf[r, rows], kk)
            sc = sc.masked_fill(~mask, -1e30)
            w = torch.softmax(sc, -1) * mask
            o = torch.einsum("kgsl,lkd->skgd", w, vv)
            out[r, rows] = o.reshape(len(rows), hq, d)
    return out


def _case(seed, b, s, bl, mb, int8=False, hq=4, hkv=2, d=8, pos=None):
    rng = np.random.default_rng(seed)
    if pos is None:
        pos = [int(rng.integers(0, mb * bl + 1)) for _ in range(b)]
    tables, need, n_pool = _tables(rng, pos, s, bl, mb)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    if int8:
        kp, vp = (rng.integers(-127, 128, (n_pool, bl, hkv, d),
                               dtype=np.int8) for _ in range(2))
        ks, vs = (0.002 + 0.02 * rng.random((n_pool, hkv),
                                            dtype=np.float32)
                  for _ in range(2))
        scales = (ks, vs)
    else:
        kp, vp = (rng.normal(size=(n_pool, bl, hkv, d)).astype(np.float32)
                  for _ in range(2))
        scales = None
    return np.asarray(pos, np.int32), tables, need, q, kp, vp, scales


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_walk(pos, tables, need, s, bl, mb):
    for r in range(len(pos)):
        p, trow = int(pos[r]), tables[r]
        kv_len = min(p + s, mb * bl)
        for q0, tiles in _walk(p, s, bl, mb, trow):
            rows = np.arange(q0, min(q0 + TILE, s))[:, None]
            visible = np.arange(kv_len)[None] <= p + rows
            seen = np.zeros(-(-kv_len // TILE), bool)
            for jt, flagged, boxes, cols in tiles:
                seen[jt] = True
                assert all(c < need[r] for c in cols)       # no dead column
                for blk, row in boxes:
                    assert blk != 0 and row % BOX == 0 and row + BOX <= bl
                k0 = jt * TILE
                for j in range(k0, min(k0 + TILE, kv_len)):
                    blk, row = boxes[(j - k0) // BOX]
                    assert (blk, row + (j - k0) % BOX) == (
                        int(trow[j // bl]), j % bl)
                if not flagged:   # every pair in range and visible
                    assert k0 + TILE <= kv_len
                    assert (np.arange(k0, k0 + TILE)[None]
                            <= p + rows).all()
            keys = np.nonzero(visible.any(0))[0]
            assert seen[keys // TILE].all()


@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 3),
       s=st.integers(1, 300), bl=st.sampled_from([64, 128, 256]),
       mb=st.integers(1, 8))
def test_walk_covers_visible_pairs_and_reads_live_blocks(seed, b, s, bl,
                                                         mb):
    pos, tables, need, *_ = _case(seed, b, s, bl, mb)
    _check_walk(pos, tables, need, s, bl, mb)


@pytest.mark.parametrize("s", [127, 128, 129, 256])
@pytest.mark.parametrize("bl", [64, 128])
def test_walk_at_tile_boundaries(s, bl):
    """Offsets on and beside the 128-key and 64-key edges, where a tile's
    last visible key or a box's block changes (random ones seldom land
    there)."""
    pos = [0, 1, 63, 64, 65, 126, 127, 128, 129, 254, 255, 256]
    mb = -(-(max(pos) + s) // bl) + 1
    tables, need, _ = _tables(np.random.default_rng(s + bl), pos, s, bl, mb)
    _check_walk(np.asarray(pos), tables, need, s, bl, mb)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 3),
       s=st.integers(1, 300), bl=st.sampled_from([64, 128, 256]),
       mb=st.integers(1, 6), int8=st.booleans())
def test_model_over_visited_tiles_equals_plain(seed, b, s, bl, mb, int8):
    pos, tables, _, q, kp, vp, scales = _case(seed, b, s, bl, mb, int8)
    kw = {}
    if scales is not None:
        kw = dict(k_scale=_t(scales[0]), v_scale=_t(scales[1]))
    got = _model(_t(q), _t(kp), _t(vp), pos, tables, **kw)
    want = cached_decode_attention_reference(
        _t(q), _t(kp), _t(vp), _t(pos), block_tables=_t(tables), **kw)
    torch.testing.assert_close(got, want, **TOL)


def _bf16_values(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


# (kind, b, s, block_len, max_blocks, pos): s = 300 is three q tiles,
# rows whose pos + s passes max_blocks * block_len, block_len 64, 128, 256
FIXED = [
    ("float32", 3, 300, 128, 6, [0, 200, 700]),
    ("bfloat16", 2, 150, 256, 3, [100, 700]),
    ("int8", 3, 200, 128, 5, [1, 130, 500]),
    ("float32", 3, 140, 64, 10, [0, 70, 600]),
    ("int8", 2, 140, 64, 9, [5, 500]),
]


@pytest.mark.parametrize("kind,b,s,bl,mb,pos", FIXED)
def test_model_matches_jax(kind, b, s, bl, mb, pos):
    pos, tables, _, q, kp, vp, scales = _case(
        7, b, s, bl, mb, int8=kind == "int8", hq=8, hkv=2, d=16, pos=pos)
    if kind == "bfloat16":
        q, kp, vp = _bf16_values(q), _bf16_values(kp), _bf16_values(vp)
    kw_t, kw_j = {}, {}
    if scales is not None:
        kw_t = dict(k_scale=_t(scales[0]), v_scale=_t(scales[1]))
        kw_j = dict(k_scale=jnp.asarray(scales[0]),
                    v_scale=jnp.asarray(scales[1]))
    got = _model(_t(q), _t(kp), _t(vp), pos, tables, **kw_t)
    jq, jk, jv, jp = (jnp.asarray(a) for a in (q, kp, vp, pos))
    if bl % 128 == 0:
        want = decode_attention_pallas(jq, jk, jv, jp,
                                       block_tables=jnp.asarray(tables),
                                       interpret=True, **kw_j)
    elif scales is None:   # the Pallas kernel over the gathered cache
        hkv, d = kp.shape[2:]
        want = decode_attention_pallas(
            jq, jk[tables].reshape(b, mb * bl, hkv, d),
            jv[tables].reshape(b, mb * bl, hkv, d), jp, interpret=True)
    else:
        want = jax_decode_ref(jq, jk, jv, jp,
                              block_tables=jnp.asarray(tables), **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the boxes never touched the dead tails the tables end in
    assert (tables == 0).any()
