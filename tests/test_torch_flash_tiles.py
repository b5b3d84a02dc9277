"""K2's packed-document tile skip, on the CPU.

The bf16 build of K2 (``csrc/flash_attention_fwd.cu``) skips a (query
tile, key tile) pair when the [min, max] segment-id ranges of the two
tiles do not meet; the ranges come from
``ops/cuda/flash_attention.py::segment_tile_ranges``.  Properties, for
packed and arbitrary int32 ids, ragged lengths, causal or not, self- and
cross-attention:

* no skipped pair holds a visible pair (same id, and causal where asked);
* the plain forward restricted to the kept tiles equals the full plain
  forward (out and lse, exactly), which the JAX package's flash reference
  also gives.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu.ops.pallas.flash_attention import flash_attention_pallas

from paddle_tpu_torch.ops.attention import (_keep_mask,
                                            flash_attention_reference)
from paddle_tpu_torch.ops.cuda.flash_attention import (SEG_TILE,
                                                       segment_tile_ranges)


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


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 2),
       sq=st.integers(1, 70), cross=st.booleans(), causal=st.booleans(),
       packed=st.booleans(), tile=st.sampled_from([4, 8, 16]))
def test_skipped_tiles_hold_no_visible_pair(seed, b, sq, cross, causal,
                                            packed, tile):
    rng = np.random.default_rng(seed)
    skv = int(rng.integers(1, 70)) if cross else sq
    if packed:
        ids_q = _packed(rng, b, sq)
        ids_k = _packed(rng, b, skv) if cross else ids_q
    else:   # arbitrary int32 ids, a few values so that some pairs match
        vals = rng.choice(np.array([-2 ** 31, -7, 0, 3, 2 ** 31 - 1],
                                   np.int64), 3).astype(np.int32)
        ids_q = vals[rng.integers(0, 3, (b, sq))]
        ids_k = vals[rng.integers(0, 3, (b, skv))] if cross else ids_q
    tq, tk = torch.from_numpy(ids_q), torch.from_numpy(ids_k)
    kept = _kept(segment_tile_ranges(tq, tile), segment_tile_ranges(tk, tile))
    visible = _keep_mask(sq, skv, causal, tq, tk, "cpu")
    assert not (visible & ~_tile_mask(kept, sq, skv, tile)).any()

    q = torch.from_numpy(rng.normal(size=(b, sq, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, skv, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, skv, 2, 8)).astype(np.float32))
    kw = dict(causal=causal, segment_ids=tq, kv_segment_ids=tk)
    out, lse = flash_attention_reference(q, k, v, **kw)
    out_k, lse_k = flash_attention_reference(
        q, k, v, attn_mask=_tile_mask(kept, sq, skv, tile), **kw)
    torch.testing.assert_close(out_k, out, rtol=0, atol=0)
    torch.testing.assert_close(lse_k, lse, rtol=0, atol=0)


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
