"""The decode kernels' walk, on the CPU.

K1, K1-int8, K1-paged and K1-paged-int8 at bf16 and head_dim 128
(``decode_mma_kernel<INT8, PAGED>`` in ``csrc/decode_attention.cu``) give
each CTA up to ``MMA_ROWS`` query rows of one (row, kv head) pair and one
split of ``split_len`` keys below the tile's live bound live = min(limit,
pos_b + (last row's query offset) + 1), limit = min(L, live_len).  Its
``MMA_WARPS`` warps take the split's ``MMA_SLICE``-key slices in turn (warp
w: slices w, w + 4, ...); each 8-key group of a slice is addressed once,
keys at or past the split's end are zero-filled, never read, and a split
at or past live leaves at once.  The two layouts differ only in that
addressing (``_walk`` restates both):

* paged (the pool (num_blocks, block_len, Hkv, D), L = max_blocks *
  block_len): a group reads one table column, and key j is copied from
  ``pool[table[b, j // block_len], j % block_len]``, its int8 scales from
  the block's row;
* contiguous (the cache (B, L, Hkv, D), int8 scales (B, n_gran, Hkv) over
  granules of gran_len = L / n_gran keys): no lookup; key j is copied
  from row b's own cache row ``b * L + j`` and a group's scales from row
  ``b * n_gran + j // gran_len``.

Properties, by hypothesis over pos, s, G, block_len or gran_len in {8, 16,
64, 128}, max_blocks or n_gran, split lengths, shuffled tables that share
blocks and end in null (block 0) tails, and rows whose pos + s passes L:

* every key below live is read exactly once per (row, kv head, row tile),
  and no key at or past limit;
* paged: no dead-tail table column is read, and each key comes from its
  block's row; contiguous: each key comes from row b's own cache row, and
  each 8-key group takes its granule's scale;
* no masked key is weighted: the keys a row weights are exactly those it
  sees (j <= pos_b + si, below limit).

The kernel's algorithm in plain torch (``_model``: each warp's online
softmax over its slices in the log2 domain, int8 payloads with K's scale
folded into each key's score and V's into each key's probability, the
warps merged, then the split partials merged in split order) equals the
plain version at 1e-5.  At fixed cases ``_model`` also matches the JAX
package: ``decode_attention_pallas(..., interpret=True)`` where the Pallas
kernel takes the shape (paged: block_len 128; contiguous: L a multiple of
128, int8 granules of 128) and ``cached_decode_attention_reference``
elsewhere (block_len or granule 8, 16 and 64), in float32, in bf16 values
(computed in float32 by both: the kernel's own bf16 rounding of P is held
on the card) and in int8 with float32 scales.

Below head_dim 128 the bf16 body keeps 128-wide ring rows: each key row's
copies read its D elements' bytes once and zero-fill the rest, every read
aligned to its size (8-byte copies for int8 rows of D % 16 == 8 bytes, as
K2-paged-int8's staging at those D), and ``_model`` on rows zero-padded to
128 equals it on the unpadded rows (D 16, 64, 72) and the Pallas kernel at
bf16 and int8, D 64, 8 query heads a KV head.
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
from paddle_tpu_torch.ops.cuda import BF16_HEAD_DIMS
from paddle_tpu_torch.ops.cuda.decode_attention import (MMA_ROWS, MMA_SLICE,
                                                        MMA_WARPS)

GROUP = 8                  # keys of one lookup (block_len, gran_len % 8 == 0)
NEG = -1e30
TOL = dict(rtol=1e-5, atol=1e-5)
LAYOUTS = ["paged", "contiguous"]


def _tiles(s, g):
    """[(first row, rows)] of the query row tiles of one (row, kv head)."""
    total = s * g
    return [(r0, min(MMA_ROWS, total - r0))
            for r0 in range(0, total, MMA_ROWS)]


def _paged_group(trow, bl):
    """Row b's paged addressing (``trow``: its table row): the group of 8
    keys from key j8 reads table column j8 // bl, once.  Returns (column,
    the first key's pool row, scale row = its block)."""
    def group(j8):
        col = j8 // bl
        blk = int(trow[col])
        return col, blk * bl + j8 % bl, blk
    return group


def _contiguous_group(b, L, gran):
    """Row b's contiguous addressing: no lookup; the group of 8 keys from
    key j8 starts at cache row b * L + j8 and takes granule j8 // gran's
    scales, row b * (L // gran) + j8 // gran.  Returns (granule, cache
    row, scale row)."""
    def group(j8):
        col = j8 // gran
        return col, b * L + j8, b * (L // gran) + col
    return group


def _walk(pos, s, g, L, group, split_len, slice_len, live_len=None):
    """{(r0, split): [(warp, t, j0, columns, reads, zeroed)]}: for each row
    tile and live split, each warp's slices of ``slice_len`` keys in
    order; ``columns`` are the slice's groups' lookups (table column or
    granule), ``reads`` are (key, column, row of the (-1, Hkv, D) view of
    K/V, row of the (-1, Hkv) view of the scales) of the keys copied,
    ``zeroed`` the keys zero-filled.  ``group`` is the layout's addressing
    of one row (``_paged_group`` / ``_contiguous_group``).  Splits that
    leave at once are absent."""
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
            for warp in range(MMA_WARPS):
                for t in range(10 ** 6):
                    j0 = k_begin + slice_len * (warp + MMA_WARPS * t)
                    if j0 >= k_end:
                        break
                    groups = [group(j0 + q8)
                              for q8 in range(0, slice_len, GROUP)
                              if j0 + q8 < k_end]
                    reads, zeroed = [], []
                    for kr in range(slice_len):
                        j = j0 + kr
                        if j >= k_end:
                            zeroed.append(j)
                            continue
                        col, first, srow = groups[kr // GROUP]
                        reads.append((j, col, first + kr % GROUP, srow))
                    slices.append((warp, t, j0, [c for c, _, _ in groups],
                                   reads, zeroed))
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


class Case:
    """Inputs of one call in one layout: ``bl`` and ``mb`` are the block
    length and table width (paged) or the granule length and granules a
    row (contiguous); L = mb * bl either way."""

    def __init__(self, seed, layout, b, s, bl, mb, int8=False, hq=4, hkv=2,
                 d=8, pos=None):
        rng = np.random.default_rng(seed)
        if pos is None:
            pos = [int(rng.integers(0, mb * bl + 1)) for _ in range(b)]
        self.layout, self.s, self.bl, self.mb = layout, s, bl, mb
        self.L = mb * bl
        self.pos = np.asarray(pos, np.int32)
        if layout == "paged":
            self.tables, self.need, n_rows = _tables(rng, pos, s, bl, mb)
            kv_shape, sc_shape = (n_rows, bl, hkv, d), (n_rows, hkv)
        else:
            self.tables = None
            kv_shape, sc_shape = (b, self.L, hkv, d), (b, mb, hkv)
        self.q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
        if int8:
            self.k, self.v = (rng.integers(-127, 128, kv_shape,
                                           dtype=np.int8) for _ in range(2))
            self.scales = tuple(
                0.002 + 0.02 * rng.random(sc_shape, dtype=np.float32)
                for _ in range(2))
        else:
            self.k, self.v = (rng.normal(size=kv_shape).astype(np.float32)
                              for _ in range(2))
            self.scales = None

    def group(self, r):
        if self.layout == "paged":
            return _paged_group(self.tables[r], self.bl)
        return _contiguous_group(r, self.L, self.bl)

    def walk(self, r, g, split_len, live_len=None):
        return _walk(int(self.pos[r]), self.s, g, self.L, self.group(r),
                     split_len, MMA_SLICE, live_len)

    def layout_kw(self):
        """The plain version's layout arguments (torch)."""
        return ({} if self.tables is None
                else dict(block_tables=_t(self.tables)))


def _model(case, q, k, v, split_len, k_scale=None, v_scale=None,
           live_len=None, kept=None, width=None):
    """The kernel's algorithm in float32 torch over ``_walk``'s slices.
    ``kept``, if given, collects {(b, h, row): set of keys weighted}.
    ``width``: the rows zero-padded to ``width`` head-dim columns first, as
    the Hopper body holds a head_dim below 128 (its ring rows and q
    registers are 128 wide, zeros past D), with the unpadded rows' scale;
    the columns past D are dropped."""
    d0 = q.shape[3]
    if width is not None:
        q, k, v = (torch.nn.functional.pad(x, (0, width - d0))
                   for x in (q, k, v))
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    k_rows, v_rows = k.reshape(-1, hkv, d), v.reshape(-1, hkv, d)
    if k_scale is not None:
        k_scale, v_scale = k_scale.reshape(-1, hkv), v_scale.reshape(-1, hkv)
    limit = case.L if live_len is None else max(1, min(case.L, live_len))
    scale_log2 = d0 ** -0.5 * math.log2(math.e)
    sl = MMA_SLICE
    out = torch.zeros(b, s, hq, d)
    for r in range(b):
        p_r = int(case.pos[r])
        walk = case.walk(r, g, split_len, live_len)
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
                    for w in range(MMA_WARPS):
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
                            for j, _, row, srow in reads:
                                kt[j - j0] = k_rows[row, h].float()
                                vt[j - j0] = v_rows[row, h].float()
                                fk[j - j0] = (1.0 if k_scale is None
                                              else float(k_scale[srow, h]))
                                fv[j - j0] = (1.0 if v_scale is None
                                              else float(v_scale[srow, h]))
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
    if width is not None:
        assert not out[..., d0:].any()     # the pad's rows of O^T stay 0
    return out[..., :d0]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_walk(case, g, split_len, live_len=None):
    limit = case.L if live_len is None else max(1, min(case.L, live_len))
    bl = case.bl
    for r in range(len(case.pos)):
        p = int(case.pos[r])
        walk = case.walk(r, g, split_len, live_len)
        for r0, nr in _tiles(case.s, g):
            live = min(limit, p + (r0 + nr - 1) // g + 1)
            seen = []
            for (t0, split), slices in walk.items():
                if t0 != r0:
                    continue
                assert split * split_len < live       # no dead split runs
                for _, _, j0, cols, reads, zeroed in slices:
                    assert j0 % GROUP == 0
                    if case.layout == "paged":        # no dead column
                        assert all(c < case.need[r] for c in cols)
                    for j, col, row, srow in reads:
                        assert j < live <= limit
                        assert col == j // bl         # the key's own group
                        if case.layout == "paged":
                            blk = int(case.tables[r, col])
                            assert blk != 0 and srow == blk
                            assert row == blk * bl + j % bl
                        else:
                            # row r's own cache row, its granule's scale
                            assert row == r * case.L + j
                            assert srow == r * case.mb + j // bl
                        seen.append(j)
                    assert all(j >= min(live, (split + 1) * split_len)
                               for j in zeroed)
            assert sorted(seen) == list(range(max(live, 0)))   # each once


@pytest.mark.parametrize("layout", LAYOUTS)
@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 3),
       s=st.integers(1, 3), g=st.sampled_from([1, 4, 8]),
       bl=st.sampled_from([8, 16, 64, 128]), mb=st.integers(1, 12),
       split_len=st.sampled_from([8, 16, 24, 40, 64, 256]),
       live_len=st.one_of(st.none(), st.integers(1, 2000)))
def test_walk_reads_each_live_key_once_and_no_dead_column(
        layout, seed, b, s, g, bl, mb, split_len, live_len):
    _check_walk(Case(seed, layout, b, s, bl, mb), g, split_len, live_len)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("split_len", [8, 24, 256])
@pytest.mark.parametrize("bl", [8, 16, 64])
def test_walk_at_group_and_block_edges(split_len, bl, layout):
    """Depths on and beside the 8-key group, 16-key slice, 64-key warp
    round and block (granule) edges (random depths seldom land there)."""
    pos = [0, 7, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255,
           256, 257]
    mb = -(-(max(pos) + 1) // bl) + 1
    case = Case(bl + split_len, layout, len(pos), 1, bl, mb, pos=pos)
    _check_walk(case, 4, split_len)


def _scale_kw(case):
    if case.scales is None:
        return {}
    return dict(k_scale=_t(case.scales[0]), v_scale=_t(case.scales[1]))


@pytest.mark.parametrize("layout", LAYOUTS)
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 3),
       s=st.integers(1, 3), bl=st.sampled_from([8, 16, 64, 128]),
       mb=st.integers(1, 6), split_len=st.sampled_from([8, 24, 64, 256]),
       int8=st.booleans(), live_len=st.one_of(st.none(),
                                              st.integers(1, 800)))
def test_model_equals_plain_and_weights_only_visible_keys(
        layout, seed, b, s, bl, mb, split_len, int8, live_len):
    case = Case(seed, layout, b, s, bl, mb, int8)
    kw = _scale_kw(case)
    kept = {}
    got = _model(case, _t(case.q), _t(case.k), _t(case.v), split_len,
                 live_len=live_len, kept=kept, **kw)
    want = cached_decode_attention_reference(
        _t(case.q), _t(case.k), _t(case.v), _t(case.pos),
        live_len=live_len, **case.layout_kw(), **kw)
    torch.testing.assert_close(got, want, **TOL)
    limit = case.L if live_len is None else min(case.L, live_len)
    hkv, g = case.k.shape[2], case.q.shape[2] // case.k.shape[2]
    for r in range(b):
        for h in range(hkv):
            for rr in range(s * g):
                visible = set(range(min(limit, int(case.pos[r]) + rr // g
                                        + 1)))
                assert kept.get((r, h, rr), set()) == visible


def _bf16_values(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


# (kind, b, s, block_len or granule, max_blocks or granules a row,
# split_len, pos): several splits a row, rows whose pos + s passes L,
# slices spanning two blocks or granules at 8
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


def _pallas_takes(case, int8):
    """Whether the Pallas kernel takes the case's shape: paged, block_len
    % 128 == 0; contiguous, int8 granules of 128 (a multiple of) or L % 128
    == 0 (its chunk divides L)."""
    if case.layout == "paged" or int8:
        return case.bl % 128 == 0
    return case.L % 128 == 0


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind,b,s,bl,mb,split_len,pos", FIXED)
def test_model_matches_jax(kind, b, s, bl, mb, split_len, pos, layout):
    _model_matches_jax(kind, b, s, bl, mb, split_len, pos, layout, 16)


# float32 (and int8 K/V under float32 q) at the reference's default head
# dim, 128: the decode tick and a 5-token window over several splits
FIXED_128 = [
    ("float32", 3, 1, 128, 4, 256, [0, 200, 500]),
    ("int8", 2, 5, 128, 3, 64, [1, 300]),
]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind,b,s,bl,mb,split_len,pos", FIXED_128)
def test_model_matches_jax_at_head_dim_128(kind, b, s, bl, mb, split_len,
                                           pos, layout):
    _model_matches_jax(kind, b, s, bl, mb, split_len, pos, layout, 128)


def _model_matches_jax(kind, b, s, bl, mb, split_len, pos, layout, d,
                       width=None, hq=8, hkv=2):
    int8 = kind == "int8"
    case = Case(7, layout, b, s, bl, mb, int8=int8, hq=hq, hkv=hkv, d=d,
                pos=pos)
    if kind == "bfloat16":
        case.q, case.k, case.v = (_bf16_values(a)
                                  for a in (case.q, case.k, case.v))
    kw_j = {}
    if case.scales is not None:
        kw_j = dict(k_scale=jnp.asarray(case.scales[0]),
                    v_scale=jnp.asarray(case.scales[1]))
    got = _model(case, _t(case.q), _t(case.k), _t(case.v), split_len,
                 width=width, **_scale_kw(case))
    jq, jk, jv, jp = (jnp.asarray(a)
                      for a in (case.q, case.k, case.v, case.pos))
    if case.tables is not None:
        kw_j["block_tables"] = jnp.asarray(case.tables)
    if _pallas_takes(case, int8):
        want = decode_attention_pallas(jq, jk, jv, jp, interpret=True,
                                       **kw_j)
    else:
        want = jax_decode_ref(jq, jk, jv, jp, **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case.tables is not None:
        # the walk never touched the dead tails the tables end in
        assert (case.tables == 0).any()
    _check_walk(case, 4, split_len)


# ---- bf16 at head dims below 128 (D <= 128, D % 8 == 0) ----------------------
#
# The Hopper body keeps its 128-wide ring rows at every D: the copies fill a
# row's first D elements' bytes and zero-fill the rest, q's fragments are
# zero past D, so S^T = K Q^T adds zero products over the pad, O^T's rows
# past D stay 0 and only D columns are stored.  The cache's rows stay D
# elements wide in device memory, so an int8 row of D % 16 == 8 bytes
# starts only 8-byte aligned; those rows go in 8-byte copies.

RING_ROW = 128             # csrc: kPD, a ring row's head-dim elements
WIDE_RING_ROW = 256        # csrc: kPDWide, the ring row above D 128


def _ring_row(d):
    return RING_ROW if d <= RING_ROW else WIDE_RING_ROW


def _row_copies(d, int8):
    """One key row's copies into its ring row (``issue`` in
    ``decode_mma_kernel``): [(byte offset in the row, bytes, read)], a copy
    that does not read zero-filling its bytes."""
    ring_bytes = _ring_row(d) * (1 if int8 else 2)
    row_bytes = d * (1 if int8 else 2)
    out = []
    for ch in range(ring_bytes // 16):
        if int8 and d % 16:
            out += [(16 * ch + 8 * e, 8, 16 * ch + 8 * e < row_bytes)
                    for e in range(2)]
        else:
            out.append((16 * ch, 16, 16 * ch < row_bytes))
    return out


def _staged_row_copies(d):
    """K2-paged-int8's cp.async staging at D % 16 == 8 (the pool's D-byte
    head stride rules out a TMA map): one key row's 8-byte pieces of its
    staged row, as wide as the tile (128 bytes up to D 128, 256 above)."""
    return [(8 * pc, 8, 8 * pc < d) for pc in range(_ring_row(d) // 8)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", sorted(BF16_HEAD_DIMS))
def test_row_copies_cover_d_and_zero_the_pad(d, int8):
    """Every key row's copies read its D elements' bytes exactly once, into
    the same bytes of the ring row, and zero-fill the ring row's rest; each
    read is aligned to its size at every row start ((row * Hkv + h) * D
    elements), so 16-byte copies are taken only where rows are 16-byte
    multiples."""
    row_bytes = d * (1 if int8 else 2)
    tables = [_row_copies(d, int8)]
    if int8 and d % 16:
        tables.append(_staged_row_copies(d))
    for copies in tables:
        read, zero = [], []
        for off, n, real in copies:
            (read if real else zero).extend(range(off, off + n))
        assert sorted(read) == list(range(row_bytes))
        assert sorted(zero) == list(range(row_bytes, copies[-1][0]
                                          + copies[-1][1]))
        for hkv in (1, 3, 4):
            for start in range(0, 6 * hkv * row_bytes, row_bytes):
                assert all((start + off) % n == 0
                           for off, n, real in copies if real)
    assert (max(n for _, n, _ in tables[0]) == 16) == (row_bytes % 16 == 0)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [16, 64, 72])
def test_padded_model_equals_unpadded(d, int8, layout):
    """The 128-wide padded rows give the unpadded rows' output: the pad's
    products are zero (G 8, s 1 and a 5-token window over several
    splits)."""
    for s, pos in ((1, [0, 300, 639]), (5, [3, 200, 635])):
        case = Case(d + s, layout, 3, s, 128, 5, int8=int8, hq=8, hkv=1,
                    d=d, pos=pos)
        args = (case, _t(case.q), _t(case.k), _t(case.v), 128)
        want = _model(*args, **_scale_kw(case))
        got = _model(*args, width=RING_ROW, **_scale_kw(case))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [136, 200])
def test_wide_padded_model_equals_unpadded(d, int8, layout):
    """The 256-wide padded rows (the wide instances, 128 < D < 256) give
    the unpadded rows' output at 1e-5: the pad's products are zero, and
    float32 matrix products of 256 columns sum in another order than of
    D (~1e-6 of the int8 cache's larger values)."""
    for s, pos in ((1, [0, 300, 639]), (5, [3, 200, 635])):
        case = Case(d + s, layout, 3, s, 128, 5, int8=int8, hq=8, hkv=1,
                    d=d, pos=pos)
        args = (case, _t(case.q), _t(case.k), _t(case.v), 128)
        want = _model(*args, **_scale_kw(case))
        got = _model(*args, width=WIDE_RING_ROW, **_scale_kw(case))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# (kind, b, s, block_len or granule, max_blocks or granules a row,
# split_len, pos) at TinyLlama's head_dim 64 and 8 query heads a KV head
FIXED_64 = [
    ("bfloat16", 3, 1, 128, 5, 256, [0, 300, 639]),
    ("bfloat16", 2, 5, 128, 3, 64, [1, 300]),
    ("int8", 3, 1, 128, 5, 64, [1, 300, 639]),
    ("int8", 2, 5, 128, 3, 256, [7, 250]),
]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind,b,s,bl,mb,split_len,pos", FIXED_64)
def test_padded_model_matches_jax_at_head_dim_64(kind, b, s, bl, mb,
                                                 split_len, pos, layout):
    """The padded model against ``decode_attention_pallas(...,
    interpret=True)`` at bf16 values (and int8 K/V) and D 64."""
    _model_matches_jax(kind, b, s, bl, mb, split_len, pos, layout, 64,
                       width=RING_ROW, hq=8, hkv=1)
