"""The bf16 flash kernels' tile walks, on the CPU.

K2 (``csrc/flash_attention_fwd.cu``) walks one 128-query tile's 128-key
tiles; K5 (``csrc/flash_attention_bwd.cu``) one 128-query tile's 64-key
tiles; K6 one 128-key tile's 64-query tiles, for every q head of its GQA
group.  Each skips the tiles above the causal diagonal and, with segment
ids, every tile pair whose [min, max] id ranges do not meet (K2's ranges
cover 128 tokens, from ``segment_tile_ranges``; K5's and K6's cover 64,
from ``backward_tile_ranges``, and a 128-token tile takes the union of its
two), and applies the element mask only on the pairs it flags.
``_walk`` restates each producer's rule.  Properties, for packed and
arbitrary int32 ids, ragged lengths, causal or not, self- and
cross-attention, at scaled-down tiles and at the kernels' own:

* no skipped pair holds a visible pair (same id, and causal where asked);
* no pair of a kept tile left unflagged is hidden or past Sq / Skv;
* the plain forward and backward restricted to the kept tiles equal the
  full ones (exactly), which the JAX package's flash kernels (Pallas in
  interpret mode) also give.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from paddle_tpu.ops.pallas.flash_attention import flash_attention_pallas

from paddle_tpu_torch.ops.attention import (_keep_mask,
                                            flash_attention_reference)
from paddle_tpu_torch.ops.cuda.flash_attention import (SEG_TILE,
                                                       segment_tile_ranges)
from paddle_tpu_torch.ops.cuda.flash_attention_bwd import (
    RANGE_TILE, _segments, backward_tile_ranges)


def _kept(rq, rk):
    """(B, Tq, Tk) bool: the kernel's rule on the two tiles' ranges."""
    return ((rq[:, :, None, 1] >= rk[:, None, :, 0])
            & (rq[:, :, None, 0] <= rk[:, None, :, 1]))


def _tile_mask(kept, sq, skv, tile):
    """(B, 1, Sq, Skv) bool: the pairs inside kept tile pairs."""
    i = torch.arange(sq) // tile
    j = torch.arange(skv) // tile
    return kept[:, i][:, :, j][:, None]


def _packed(rng, b, s):
    out = np.zeros((b, s), np.int32)
    for r in range(b):
        cuts = rng.choice(np.arange(1, s), min(s - 1, rng.integers(0, 6)),
                          replace=False) if s > 1 else []
        for c in cuts:
            out[r, c:] += 1
    return out


def _union(rng):
    """Ranges of tiles twice as long: the union of each two (the last may
    stand alone), as a 128-token tile takes them in K5 / K6."""
    b, n, _ = rng.shape
    out = []
    for t in range(0, n, 2):
        pair = rng[:, t:t + 2]
        out.append(torch.stack([pair[..., 0].amin(1), pair[..., 1].amax(1)],
                               -1))
    return torch.stack(out, 1)


def _walk(kind, ids_q, ids_k, sq, skv, causal, r):
    """(kept, flagged, tq, tk): the (query tile, key tile) pairs the kernel
    ``kind`` visits and those it applies the element mask on, (B, Tq, Tk)
    bool, at query / key tiles tq / tk, with ranges of r tokens — the
    producers' rules in csrc/flash_attention_{fwd,bwd}.cu, scaled by
    r / 64 (K2: r / 128).  K2 and K5 walk a query tile's key tiles below
    kv_hi = Skv or, causal, min(Skv, q0 + tq + Skv - Sq); K6 walks a key
    tile's query tiles from max(0, k0 - (Skv - Sq)) // tq, causal, or 0."""
    if kind == "k2":
        tq = tk = r
        rq, rk = segment_tile_ranges(ids_q, r), segment_tile_ranges(ids_k, r)
    else:
        rq, rk = (segment_tile_ranges(ids_q, r),
                  segment_tile_ranges(ids_k, r))
        if kind == "k5":
            tq, tk, rq = 2 * r, r, _union(rq)
        else:
            tq, tk, rk = r, 2 * r, _union(rk)
    b = ids_q.shape[0]
    n_q, n_k, off = -(-sq // tq), -(-skv // tk), skv - sq
    kept = torch.zeros(b, n_q, n_k, dtype=torch.bool)
    for i in range(n_q):
        for j in range(n_k):
            q0, k0 = i * tq, j * tk
            if kind == "k6":
                walked = not causal or i >= max(0, k0 - off) // tq
            else:
                hi = min(skv, q0 + tq + off) if causal else skv
                walked = j < (-(-hi // tk) if hi > 0 else 0)
            kept[:, i, j] = walked
    kept &= _kept(rq, rk)
    # flagged: across the diagonal, the ragged end(s), or ids not all one
    same = ((rq[:, :, None, 0] == rq[:, :, None, 1])
            & (rk[:, None, :, 0] == rk[:, None, :, 1])
            & (rq[:, :, None, 0] == rk[:, None, :, 0]))
    i = torch.arange(n_q)[:, None] * tq
    j = torch.arange(n_k)[None, :] * tk
    edge = (j + tk > skv) | (causal & (j + tk - 1 > i + off))
    if kind != "k5":   # K5's rows past Sq carry zero dS unmasked
        edge = edge | (i + tq > sq)
    flagged = kept & (edge[None] | ~same)
    return kept, flagged, tq, tk


def _pair_mask(tiles, sq, skv, tq, tk):
    """(B, 1, Sq, Skv) bool: the pairs inside the marked tile pairs."""
    i = torch.arange(sq) // tq
    j = torch.arange(skv) // tk
    return tiles[:, i][:, :, j][:, None]


def _ids(rng, b, sq, skv, cross, packed):
    if packed:
        ids_q = _packed(rng, b, sq)
        ids_k = _packed(rng, b, skv) if cross else ids_q
    else:   # arbitrary int32 ids, a few values so that some pairs match
        vals = rng.choice(np.array([-2 ** 31, -7, 0, 3, 2 ** 31 - 1],
                                   np.int64), 3).astype(np.int32)
        ids_q = vals[rng.integers(0, 3, (b, sq))]
        ids_k = vals[rng.integers(0, 3, (b, skv))] if cross else ids_q
    return torch.from_numpy(ids_q), torch.from_numpy(ids_k)


def _check_walk(kind, seed, b, sq, cross, causal, packed, r, backward):
    rng = np.random.default_rng(seed)
    skv = int(rng.integers(1, 70)) if cross else sq
    tq_ids, tk_ids = _ids(rng, b, sq, skv, cross, packed)
    kept, flagged, tq, tk = _walk(kind, tq_ids, tk_ids, sq, skv, causal, r)
    visible = _keep_mask(sq, skv, causal, tq_ids, tk_ids, "cpu")
    assert not (visible & ~_pair_mask(kept, sq, skv, tq, tk)).any()
    # an unflagged kept tile: every pair in range and visible (the padded
    # rows past Sq of K5's tiles aside)
    plain = _pair_mask(kept & ~flagged, -(-sq // tq) * tq,
                       -(-skv // tk) * tk, tq, tk)
    plain = plain[..., :sq, :] if kind == "k5" else plain
    assert not plain[..., skv:].any() and (
        kind == "k5" or not plain[..., sq:, :].any())
    assert not (plain[..., :sq, :skv] & ~visible).any()

    q = torch.from_numpy(rng.normal(size=(b, sq, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, skv, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, skv, 2, 8)).astype(np.float32))
    kw = dict(causal=causal, segment_ids=tq_ids, kv_segment_ids=tk_ids)
    tiles = _pair_mask(kept, sq, skv, tq, tk)
    if not backward:
        out, lse = flash_attention_reference(q, k, v, **kw)
        out_k, lse_k = flash_attention_reference(q, k, v, attn_mask=tiles,
                                                 **kw)
        torch.testing.assert_close(out_k, out, rtol=0, atol=0)
        torch.testing.assert_close(lse_k, lse, rtol=0, atol=0)
        return
    w = torch.from_numpy(rng.normal(size=(b, sq, 4, 8)).astype(np.float32))
    grads = []
    for mask in (None, tiles):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out, _ = flash_attention_reference(*leaves, attn_mask=mask, **kw)
        grads.append(torch.autograd.grad((out * w).sum(), leaves))
    for g, g_k in zip(*grads):
        torch.testing.assert_close(g_k, g, rtol=0, atol=0)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 2),
       sq=st.integers(1, 70), cross=st.booleans(), causal=st.booleans(),
       packed=st.booleans(), tile=st.sampled_from([4, 8, 16]))
def test_skipped_tiles_hold_no_visible_pair(seed, b, sq, cross, causal,
                                            packed, tile):
    """K2's walk: query tiles of ``tile``, key tiles of ``tile``."""
    _check_walk("k2", seed, b, sq, cross, causal, packed, tile,
                backward=False)


@pytest.mark.parametrize("kind", ["k5", "k6"])
@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 2),
       sq=st.integers(1, 70), cross=st.booleans(), causal=st.booleans(),
       packed=st.booleans(), tile=st.sampled_from([4, 8, 16]))
def test_backward_skipped_tiles_hold_no_visible_pair(kind, seed, b, sq,
                                                     cross, causal, packed,
                                                     tile):
    """K5's walk (query tiles of 2 x tile, key tiles of tile) and K6's
    (key tiles of 2 x tile, query tiles of tile), Sq = Skv or not: the
    plain backward over the kept tiles is the full one."""
    _check_walk(kind, seed, b, sq, cross, causal, packed, tile,
                backward=True)


@pytest.mark.parametrize("s", [1, 127, 128, 300])
def test_segment_tile_ranges_match_numpy(s):
    rng = np.random.default_rng(s)
    ids = rng.integers(-5, 5, (2, s)).astype(np.int32)
    got = segment_tile_ranges(torch.from_numpy(ids)).numpy()
    t = -(-s // SEG_TILE)
    assert got.shape == (2, t, 2) and got.dtype == np.int32
    for r in range(2):
        for i in range(t):
            blk = ids[r, i * SEG_TILE:(i + 1) * SEG_TILE]
            assert tuple(got[r, i]) == (blk.min(), blk.max())


def test_kept_tiles_forward_matches_jax():
    """At the kernel's own tile (128): four documents of 100, 60, 200 and
    152 tokens leave three of the ten causal tile pairs skipped, and the
    forward over the kept tiles equals the JAX package's flash forward
    (Pallas in interpret mode) within float32 sum order."""
    rng = np.random.default_rng(5)
    b, s, hq, hkv, d = 1, 512, 4, 2, 16
    ids = np.repeat(np.arange(4, dtype=np.int32), [100, 60, 200, 152])[None]
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    tid = torch.from_numpy(ids)
    ranges = segment_tile_ranges(tid)
    kept = _kept(ranges, ranges)
    assert int(torch.tril(~kept[0]).sum()) == 3   # (2, 0), (3, 0), (3, 1)
    out, lse = flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True,
        segment_ids=tid, attn_mask=_tile_mask(kept, s, s, SEG_TILE))
    want, want_lse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        segment_ids=jnp.asarray(ids), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 300])
def test_backward_tile_ranges_match_numpy(s):
    """64-token ranges of both id tensors; the keys' default to the
    queries' (one tensor, not a copy)."""
    rng = np.random.default_rng(s)
    ids = rng.integers(-5, 5, (2, s)).astype(np.int32)
    kv = rng.integers(-5, 5, (2, s + 7)).astype(np.int32)
    q_rng, kv_rng = backward_tile_ranges(torch.from_numpy(ids),
                                         torch.from_numpy(kv))
    for got, src in ((q_rng.numpy(), ids), (kv_rng.numpy(), kv)):
        t = -(-src.shape[1] // RANGE_TILE)
        assert got.shape == (2, t, 2) and got.dtype == np.int32
        for r in range(2):
            for i in range(t):
                blk = src[r, i * RANGE_TILE:(i + 1) * RANGE_TILE]
                assert tuple(got[r, i]) == (blk.min(), blk.max())
    same_q, same_kv = backward_tile_ranges(torch.from_numpy(ids))
    assert same_kv is same_q


def test_backward_segments_for_the_c_entry():
    """What K5 / K6's wrappers hand the C entry with segment ids: int32
    ids and their 64-token ranges (the queries' serving the keys of
    self-attention), for the bf16 build and, since its 3xTF32 kernels skip
    tile pairs too, the float32 one."""
    q = torch.zeros(2, 130, 4, 128, dtype=torch.bfloat16)
    ids = torch.arange(260, dtype=torch.int64).reshape(2, 130) // 50
    kv_ids = torch.zeros(2, 70, dtype=torch.int64)
    seg_q, seg_kv, q_rng, kv_rng = _segments(q, 70, ids, kv_ids)
    assert seg_q.dtype == seg_kv.dtype == torch.int32
    assert torch.equal(q_rng, backward_tile_ranges(ids)[0])
    assert kv_rng.shape == (2, 2, 2) and not kv_rng.any()
    _, _, q_rng, kv_rng = _segments(q, 130, ids, None)
    assert kv_rng is q_rng
    _, _, q_rng, kv_rng = _segments(q.float()[..., :16], 70, ids, kv_ids)
    assert torch.equal(q_rng, backward_tile_ranges(ids)[0])
    assert kv_rng.shape == (2, 2, 2) and not kv_rng.any()


@pytest.mark.parametrize("kind", ["k5", "k6"])
def test_kept_tiles_backward_matches_jax(kind):
    """At the kernels' own tiles (64-token ranges): four documents of 100,
    60, 200 and 152 tokens; the plain backward over the tiles K5 or K6
    keeps equals the VJP of the JAX package's flash kernel (Pallas in
    interpret mode) within float32 sum order."""
    _kept_tiles_backward(kind, 16)


@pytest.mark.parametrize("kind", ["k5", "k6"])
def test_kept_tiles_backward_matches_jax_at_head_dim_72(kind):
    """The same at DiT-XL/2's head_dim: the walk is by tokens, so the tiles
    K5 / K6 keep at D 72 are those at 16."""
    _kept_tiles_backward(kind, 72)


@pytest.mark.parametrize("kind", ["k5", "k6"])
def test_kept_tiles_backward_matches_jax_at_head_dim_128(kind):
    """The same at the reference's float32 default head_dim (128): the
    float32 build's walk is K5 / K6's walk by tokens."""
    _kept_tiles_backward(kind, 128)


def _kept_tiles_backward(kind, d):
    rng = np.random.default_rng(6)
    b, s, hq, hkv = 1, 512, 4, 2
    ids = np.repeat(np.arange(4, dtype=np.int32), [100, 60, 200, 152])[None]
    q, k, v, do = (rng.normal(size=(b, s, h, d)).astype(np.float32)
                   for h in (hq, hkv, hkv, hq))
    tid = torch.from_numpy(ids)
    kept, _, tq, tk = _walk(kind, tid, tid, s, s, True, RANGE_TILE)
    n_causal = sum(1 for i in range(kept.shape[1])
                   for j in range(kept.shape[2])
                   if j * tk <= i * tq + tq - 1)
    assert 0 < int(kept.sum()) < n_causal     # some causal tiles skipped

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, _ = flash_attention_reference(
        *leaves, causal=True, segment_ids=tid,
        attn_mask=_pair_mask(kept, s, s, tq, tk))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))

    def f(q, k, v):
        return flash_attention_pallas(q, k, v, causal=True,
                                      segment_ids=jnp.asarray(ids),
                                      interpret=True)[0]

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
