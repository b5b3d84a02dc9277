"""The paged decode kernels' walk, on the CPU.

K1-paged and K1-paged-int8 at bf16 and head_dim 128
(``decode_paged_mma_kernel`` in ``csrc/decode_attention.cu``) give each CTA
up to ``PAGED_ROWS`` query rows of one (row, kv head) pair and one split
of ``split_len`` keys below the tile's live bound live = min(limit, pos_b
+ (last row's query offset) + 1), limit = min(max_blocks * block_len,
live_len).  Its ``PAGED_WARPS`` warps take the split's ``PAGED_SLICE``-key
slices in turn (warp w: slices w, w + 4, ...); each 8-key group of a
slice reads one table column, and every key row is copied from
``pool[table[b, j // block_len], j % block_len]``; keys at or past the
split's end are zero-filled, never read.  A split at or past live leaves at once.
``_walk`` restates that rule.  Properties, by hypothesis over pos, s,
G, block_len in {8, 16, 64, 128}, max_blocks, split lengths, shuffled
tables that share blocks and end in null (block 0) tails, and rows whose
pos + s passes max_blocks * block_len:

* every key below live is read exactly once per (row, kv head, row tile);
* no dead-tail table column is read, and each key comes from its block's
  row;
* no masked key is weighted: the keys a row weights are exactly those it
  sees (j <= pos_b + si, below limit).

The kernel's algorithm in plain torch (``_model``: each warp's online
softmax over its slices in the log2 domain, int8 payloads with K's block
scale folded into each key's score and V's into each key's probability,
the warps merged, then the split partials merged in split order) equals
the plain version at 1e-5.  At fixed cases ``_model`` also matches the JAX
package: ``decode_attention_pallas(..., interpret=True)`` at block_len 128
and ``cached_decode_attention_reference`` at block_len 8, 16 and 64 (the
Pallas kernel's paged mode takes block_len % 128 == 0), in float32, in
bf16 values (computed in float32 by both: the kernel's own bf16 rounding
of P is held on the card) and in int8 with float32 scales.
"""

import math

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
from paddle_tpu_torch.ops.cuda.decode_attention import (PAGED_ROWS,
                                                        PAGED_SLICE,
                                                        PAGED_WARPS)

GROUP = 8                  # keys of one table lookup (block_len % 8 == 0)
NEG = -1e30
TOL = dict(rtol=1e-5, atol=1e-5)


def _tiles(s, g):
    """[(first row, rows)] of the query row tiles of one (row, kv head)."""
    total = s * g
    return [(r0, min(PAGED_ROWS, total - r0))
            for r0 in range(0, total, PAGED_ROWS)]


def _walk(pos, s, g, bl, mb, trow, split_len, slice_len, live_len=None):
    """{(r0, split): [(warp, t, j0, columns, reads, zeroed)]}: for each row
    tile and live split, each warp's slices of ``slice_len`` keys in
    order; ``reads`` are (key, table column, (block, row)) of the keys
    copied, ``zeroed`` the keys zero-filled.  Splits that leave at once
    are absent."""
    L = mb * bl
    limit = L if live_len is None else max(1, min(L, live_len))
    out = {}
    for r0, nr in _tiles(s, g):
        live = min(limit, pos + (r0 + nr - 1) // g + 1)
        for split in range(math.ceil(limit / split_len)):
            k_begin = split * split_len
            k_end = min(live, k_begin + split_len)
            if k_end <= k_begin:
                continue
            slices = []
            for warp in range(PAGED_WARPS):
                for t in range(10 ** 6):
                    j0 = k_begin + slice_len * (warp + PAGED_WARPS * t)
                    if j0 >= k_end:
                        break
                    cols = [(j0 + q8) // bl
                            for q8 in range(0, slice_len, GROUP)
                            if j0 + q8 < k_end]
                    reads, zeroed = [], []
                    for kr in range(slice_len):
                        j = j0 + kr
                        if j >= k_end:
                            zeroed.append(j)
                            continue
                        grp = kr // GROUP
                        col = cols[grp]
                        row = (j0 + GROUP * grp) % bl + kr % GROUP
                        reads.append((j, col, (int(trow[col]), row)))
                    slices.append((warp, t, j0, cols, reads, zeroed))
            out[(r0, split)] = slices
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


def _model(q, k_pool, v_pool, pos, tables, split_len, k_scale=None,
           v_scale=None, live_len=None, kept=None):
    """The kernel's algorithm in float32 torch over ``_walk``'s slices.
    ``kept``, if given, collects {(b, h, row): set of keys weighted}."""
    b, s, hq, d = q.shape
    _, bl, hkv, _ = k_pool.shape
    g, mb = hq // hkv, tables.shape[1]
    L = mb * bl
    limit = L if live_len is None else max(1, min(L, live_len))
    scale_log2 = d ** -0.5 * math.log2(math.e)
    sl = PAGED_SLICE
    out = torch.zeros(b, s, hq, d)
    for r in range(b):
        p_r = int(pos[r])
        walk = _walk(p_r, s, g, bl, mb, tables[r], split_len, sl, live_len)
        for h in range(hkv):
            for r0, nr in _tiles(s, g):
                rows = torch.arange(r0, r0 + nr)
                si, gi = rows // g, rows % g
                qt = q[r, si, h * g + gi].float()               # (nr, d)
                live = min(limit, p_r + (r0 + nr - 1) // g + 1)
                n_live = math.ceil(live / split_len) if live > 0 else 0
                parts = []
                for split in range(n_live):
                    k_end = min(live, (split + 1) * split_len)
                    last = torch.minimum(torch.tensor(k_end),
                                         p_r + si + 1) - 1
                    warps = []
                    for w in range(PAGED_WARPS):
                        m = torch.full((nr,), NEG)
                        l = torch.zeros(nr)
                        acc = torch.zeros(nr, d)
                        for warp, _, j0, _, reads, _ in walk[(r0, split)]:
                            if warp != w:
                                continue
                            kt = torch.zeros(sl, d)
                            vt = torch.zeros(sl, d)
                            fk = torch.zeros(sl)
                            fv = torch.zeros(sl)
                            for j, _, (blk, row) in reads:
                                kt[j - j0] = k_pool[blk, row, h].float()
                                vt[j - j0] = v_pool[blk, row, h].float()
                                fk[j - j0] = (1.0 if k_scale is None
                                              else float(k_scale[blk, h]))
                                fv[j - j0] = (1.0 if v_scale is None
                                              else float(v_scale[blk, h]))
                            keys = j0 + torch.arange(sl)
                            keep = keys[None] <= last[:, None]
                            sc = (qt @ kt.T) * (scale_log2 * fk)[None]
                            sc = torch.where(keep, sc, torch.tensor(NEG))
                            mx = torch.maximum(m, sc.amax(1))
                            alpha = torch.exp2(m - mx)
                            p = torch.where(keep, torch.exp2(sc - mx[:, None]),
                                            torch.tensor(0.0))
                            l = l * alpha + p.sum(1)
                            acc = acc * alpha[:, None] + (p * fv[None]) @ vt
                            m = mx
                            if kept is not None:
                                for i in range(nr):
                                    kept.setdefault(
                                        (r, h, r0 + i), set()).update(
                                        keys[p[i] > 0].tolist())
                        warps.append((m, l, acc))
                    M = torch.full((nr,), NEG)
                    for m, l, _ in warps:
                        M = torch.where(l > 0, torch.maximum(M, m), M)
                    o, lsum = torch.zeros(nr, d), torch.zeros(nr)
                    for m, l, acc in warps:
                        cf = torch.where(l > 0, torch.exp2(m - M),
                                         torch.tensor(0.0))
                        lsum = lsum + l * cf
                        o = o + acc * cf[:, None]
                    parts.append((o, M * math.log(2.0), lsum))
                # the splits in split order (natural-log units)
                M = torch.full((nr,), NEG)
                for _, m, l in parts:
                    M = torch.where(l > 0, torch.maximum(M, m), M)
                o, lsum = torch.zeros(nr, d), torch.zeros(nr)
                for acc, m, l in parts:
                    wgt = torch.where(l > 0, torch.exp(m - M),
                                      torch.tensor(0.0))
                    lsum = lsum + l * wgt
                    o = o + acc * wgt[:, None]
                res = torch.where(lsum[:, None] > 0,
                                  o / lsum.clamp_min(1e-37)[:, None],
                                  torch.tensor(0.0))
                out[r, si, h * g + gi] = res
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


def _check_walk(pos, tables, need, s, g, bl, mb, split_len, slice_len,
                live_len=None):
    L = mb * bl
    limit = L if live_len is None else max(1, min(L, live_len))
    for r in range(len(pos)):
        p, trow = int(pos[r]), tables[r]
        walk = _walk(p, s, g, bl, mb, trow, split_len, slice_len, live_len)
        for r0, nr in _tiles(s, g):
            live = min(limit, p + (r0 + nr - 1) // g + 1)
            seen = []
            for (t0, split), slices in walk.items():
                if t0 != r0:
                    continue
                assert split * split_len < live       # no dead split runs
                for _, _, j0, cols, reads, zeroed in slices:
                    assert j0 % GROUP == 0
                    assert all(c < need[r] for c in cols)   # no dead column
                    for j, col, (blk, row) in reads:
                        assert col == j // bl and blk == int(trow[col])
                        assert row == j % bl and blk != 0
                        seen.append(j)
                    assert all(j >= min(live, (split + 1) * split_len)
                               for j in zeroed)
            assert sorted(seen) == list(range(max(live, 0)))   # each once


@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 3),
       s=st.integers(1, 3), g=st.sampled_from([1, 4, 8]),
       bl=st.sampled_from([8, 16, 64, 128]), mb=st.integers(1, 12),
       split_len=st.sampled_from([8, 16, 24, 40, 64, 256]),
       live_len=st.one_of(st.none(), st.integers(1, 2000)))
def test_walk_reads_each_live_key_once_and_no_dead_column(
        seed, b, s, g, bl, mb, split_len, live_len):
    pos, tables, need, *_ = _case(seed, b, s, bl, mb)
    _check_walk(pos, tables, need, s, g, bl, mb, split_len, PAGED_SLICE,
                live_len)


@pytest.mark.parametrize("split_len", [8, 24, 256])
@pytest.mark.parametrize("bl", [8, 16, 64])
def test_walk_at_group_and_block_edges(split_len, bl):
    """Depths on and beside the 8-key group, 16-key slice, 64-key warp
    round and block edges (random depths seldom land there)."""
    pos = [0, 7, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255,
           256, 257]
    mb = -(-(max(pos) + 1) // bl) + 1
    tables, need, _ = _tables(np.random.default_rng(bl + split_len), pos, 1,
                              bl, mb)
    _check_walk(np.asarray(pos), tables, need, 1, 4, bl, mb, split_len,
                PAGED_SLICE)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 3),
       s=st.integers(1, 3), bl=st.sampled_from([8, 16, 64, 128]),
       mb=st.integers(1, 6), split_len=st.sampled_from([8, 24, 64, 256]),
       int8=st.booleans(), live_len=st.one_of(st.none(),
                                              st.integers(1, 800)))
def test_model_equals_plain_and_weights_only_visible_keys(
        seed, b, s, bl, mb, split_len, int8, live_len):
    pos, tables, _, q, kp, vp, scales = _case(seed, b, s, bl, mb, int8)
    kw = {}
    if scales is not None:
        kw = dict(k_scale=_t(scales[0]), v_scale=_t(scales[1]))
    kept = {}
    got = _model(_t(q), _t(kp), _t(vp), pos, tables, split_len,
                 live_len=live_len, kept=kept, **kw)
    want = cached_decode_attention_reference(
        _t(q), _t(kp), _t(vp), _t(pos), block_tables=_t(tables),
        live_len=live_len, **kw)
    torch.testing.assert_close(got, want, **TOL)
    L = mb * bl
    limit = L if live_len is None else min(L, live_len)
    hkv, g = kp.shape[2], q.shape[2] // kp.shape[2]
    for r in range(b):
        for h in range(hkv):
            for rr in range(s * g):
                visible = set(range(min(limit, int(pos[r]) + rr // g + 1)))
                assert kept.get((r, h, rr), set()) == visible


def _bf16_values(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


# (kind, b, s, block_len, max_blocks, split_len, pos): several splits a
# row, rows whose pos + s passes max_blocks * block_len, slices spanning
# two blocks at block_len 8
FIXED = [
    ("float32", 3, 1, 128, 6, 256, [0, 200, 700]),
    ("bfloat16", 2, 1, 128, 4, 64, [130, 511]),
    ("int8", 3, 1, 128, 5, 256, [1, 300, 639]),
    ("float32", 3, 1, 8, 40, 24, [0, 7, 257]),
    ("int8", 3, 1, 8, 40, 40, [8, 255, 320]),
    ("bfloat16", 2, 2, 16, 20, 64, [17, 318]),
    ("int8", 2, 1, 16, 20, 256, [33, 300]),
    ("float32", 3, 3, 64, 10, 64, [0, 63, 638]),
    ("int8", 2, 1, 64, 9, 8, [5, 500]),
]


@pytest.mark.parametrize("kind,b,s,bl,mb,split_len,pos", FIXED)
def test_model_matches_jax(kind, b, s, bl, mb, split_len, pos):
    pos, tables, _, q, kp, vp, scales = _case(
        7, b, s, bl, mb, int8=kind == "int8", hq=8, hkv=2, d=16, pos=pos)
    if kind == "bfloat16":
        q, kp, vp = _bf16_values(q), _bf16_values(kp), _bf16_values(vp)
    kw_t, kw_j = {}, {}
    if scales is not None:
        kw_t = dict(k_scale=_t(scales[0]), v_scale=_t(scales[1]))
        kw_j = dict(k_scale=jnp.asarray(scales[0]),
                    v_scale=jnp.asarray(scales[1]))
    got = _model(_t(q), _t(kp), _t(vp), pos, tables, split_len, **kw_t)
    jq, jk, jv, jp = (jnp.asarray(a) for a in (q, kp, vp, pos))
    if bl % 128 == 0:
        want = decode_attention_pallas(jq, jk, jv, jp,
                                       block_tables=jnp.asarray(tables),
                                       interpret=True, **kw_j)
    else:
        want = jax_decode_ref(jq, jk, jv, jp,
                              block_tables=jnp.asarray(tables), **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the walk never touched the dead tails the tables end in
    assert (tables == 0).any()
    need = [min(mb, -(-(p + s) // bl)) for p in pos]
    _check_walk(pos, tables, need, s, 4, bl, mb, split_len, PAGED_SLICE)
