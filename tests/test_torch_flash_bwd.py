"""The plain versions of the flash-attention backward (kernels K5 / K6) and
the port's attention gradients against the JAX package, on the CPU.

* ``flash_attention_bwd_reference`` against the VJP of the Pallas kernel
  in interpret mode (``jax.vjp`` of ``flash_attention_pallas(...,
  interpret=True)`` with given dO and dlse), fed JAX's own out and lse, at
  float32: 1e-5 (the two sum in other orders).  The Pallas kernel needs
  Sq % 8 == 0 and Skv % 128 == 0, so its cases are aligned.  Head dims
  32, DiT-XL/2's 72 and 64, 128, and above 128 a Gemma-2B-wide Llama's
  256 and 200 (K5 / K6 take K2's head dims), with GQA, dead rows and
  segment ids.
* The port's ``flash_attention`` under ordinary autograd (the CPU route)
  against ``jax.grad`` of JAX's ``flash_attention`` (its XLA path on the
  CPU), ragged lengths included, out and lse both in the loss, at head
  dims 16, 72 and 256: 1e-5.
* ``segment_mask`` equal to JAX's; the RMSNorm gradient against
  ``jax.grad`` of ``rms_norm_reference``: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.attention import flash_attention as jax_flash
from paddle_tpu.ops.attention import segment_mask as jax_segment_mask
from paddle_tpu.ops.norms import rms_norm_reference as jax_rms_norm
from paddle_tpu.ops.pallas.flash_attention import flash_attention_pallas

from paddle_tpu_torch.ops import (flash_attention,
                                  flash_attention_bwd_dkv_cuda,
                                  flash_attention_bwd_dq_cuda,
                                  flash_attention_bwd_reference, rms_norm,
                                  segment_mask)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _segments(b, s, seed, max_docs=4):
    """(B, S) int32 packed-document ids: 1..max_docs documents a row."""
    rng = np.random.RandomState(seed)
    out = np.zeros((b, s), np.int32)
    for r in range(b):
        n = rng.randint(1, max_docs + 1)
        for c in sorted(rng.choice(np.arange(1, s), n - 1, replace=False)):
            out[r, c:] += 1
    return out


# (id, b, sq, skv, hq, hkv, d, causal, segments, dlse)
PALLAS_CASES = [
    ("noncausal", 1, 128, 128, 2, 2, 32, False, None, False),
    ("causal_gqa", 2, 128, 128, 4, 2, 32, True, None, True),
    ("sq_lt_skv", 1, 64, 256, 4, 2, 32, True, None, False),
    ("sq_gt_skv_dead_rows", 1, 256, 128, 2, 1, 32, True, None, True),
    ("self_segments", 2, 128, 128, 4, 2, 32, True, "self", True),
    ("cross_segments", 1, 64, 128, 2, 2, 32, False, "cross", True),
    ("d72_full", 2, 128, 128, 4, 4, 72, False, None, True),
    ("d72_causal_gqa_dead_rows", 1, 256, 128, 4, 2, 72, True, None, True),
    ("d72_self_segments", 2, 128, 128, 4, 2, 72, True, "self", True),
    ("d64_causal_gqa", 2, 128, 128, 4, 2, 64, True, None, False),
    ("d64_cross_segments", 1, 64, 128, 2, 2, 64, False, "cross", True),
    # float32 at head_dim 128 (LlamaConfig(), Qwen2VLConfig()'s decoder)
    ("d128_causal_gqa_dead_rows", 1, 256, 128, 4, 2, 128, True, None, True),
    ("d128_self_segments", 1, 128, 128, 4, 2, 128, True, "self", True),
    ("d128_cross", 1, 64, 128, 2, 2, 128, False, None, False),
    # bf16's 256-wide tiles above head_dim 128 (a Gemma-2B-wide Llama's 256,
    # 8 query heads over one KV head), here in float32
    ("d256_causal_gqa_dead_rows", 1, 256, 128, 8, 1, 256, True, None, True),
    ("d256_self_segments", 1, 128, 128, 8, 1, 256, True, "self", True),
    ("d256_cross_segments", 1, 64, 128, 8, 1, 256, False, "cross", True),
    ("d200_causal_gqa_dead_rows", 1, 256, 128, 8, 1, 200, True, None, True),
    ("d200_self_segments", 1, 128, 128, 8, 1, 200, True, "self", True),
    ("d200_cross_segments", 1, 64, 128, 8, 1, 200, False, "cross", True),
]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=[c[0] for c in PALLAS_CASES])
def test_bwd_reference_matches_pallas_interpret(case):
    _, b, sq, skv, hq, hkv, d, causal, segs, with_dlse = case
    q, k, v = (_rand((b, sq, hq, d), 1), _rand((b, skv, hkv, d), 2),
               _rand((b, skv, hkv, d), 3))
    do = _rand((b, sq, hq, d), 4)
    dlse = _rand((b, hq, sq), 5) if with_dlse else np.zeros((b, hq, sq),
                                                            np.float32)
    seg = kv_seg = None
    if segs == "self":
        seg = _segments(b, sq, 6)
    elif segs == "cross":
        seg, kv_seg = _segments(b, sq, 7, 2), _segments(b, skv, 8, 2)

    def f(q, k, v):
        return flash_attention_pallas(
            q, k, v, causal=causal, interpret=True,
            segment_ids=None if seg is None else jnp.asarray(seg),
            kv_segment_ids=None if kv_seg is None else jnp.asarray(kv_seg))

    (out, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    def t(a):
        return torch.from_numpy(np.array(a))

    got = flash_attention_bwd_reference(
        t(q), t(k), t(v), t(np.asarray(out)), t(np.asarray(lse)), t(do),
        t(dlse) if with_dlse else None, causal=causal,
        segment_ids=None if seg is None else t(seg),
        kv_segment_ids=None if kv_seg is None else t(kv_seg))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    if causal and sq > skv:                # rows before the diagonal
        assert not got[0][:, :sq - skv].any()


# (id, b, sq, skv, hq, hkv, causal, segments, head_dim)
AUTOGRAD_CASES = [
    ("ragged_self", 2, 13, 13, 4, 2, True, None, 16),
    ("ragged_sq_lt_skv", 2, 13, 37, 4, 2, True, None, 16),
    ("ragged_dead_rows", 1, 37, 13, 2, 1, True, None, 16),
    ("ragged_noncausal", 1, 37, 37, 2, 2, False, None, 16),
    ("ragged_segments", 2, 37, 37, 4, 2, True, "self", 16),
    ("ragged_cross_segments", 2, 13, 37, 2, 1, False, "cross", 16),
    ("ragged_d72_gqa_dead_rows", 2, 37, 13, 4, 2, True, None, 72),
    ("ragged_d72_segments", 1, 37, 37, 2, 2, False, "self", 72),
    ("ragged_d256_gqa_dead_rows", 2, 37, 13, 8, 1, True, None, 256),
    ("ragged_d256_cross_segments", 1, 13, 37, 8, 1, False, "cross", 256),
]


@pytest.mark.parametrize("case", AUTOGRAD_CASES,
                         ids=[c[0] for c in AUTOGRAD_CASES])
def test_flash_attention_grad_matches_jax(case):
    _, b, sq, skv, hq, hkv, causal, segs, d = case
    q, k, v = (_rand((b, sq, hq, d), 11), _rand((b, skv, hkv, d), 12),
               _rand((b, skv, hkv, d), 13))
    w, wl = _rand((b, sq, hq, d), 14), _rand((b, hq, sq), 15)
    seg = kv_seg = None
    if segs == "self":
        seg = _segments(b, sq, 16)
    elif segs == "cross":
        seg, kv_seg = _segments(b, sq, 17, 2), _segments(b, skv, 18, 2)
    # dead rows carry lse = -1e30: keep their lse out of the loss value
    live = np.ones((b, hq, sq), np.float32)
    if causal and sq > skv:
        live[:, :, :sq - skv] = 0.0

    def jloss(q, k, v):
        out, lse = jax_flash(
            q, k, v, causal=causal, return_lse=True,
            segment_ids=None if seg is None else jnp.asarray(seg),
            kv_segment_ids=None if kv_seg is None else jnp.asarray(kv_seg))
        return jnp.sum(out * w) + jnp.sum(jnp.where(live > 0, lse, 0) * wl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = flash_attention(
        tq, tk, tv, causal=causal, return_lse=True,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        kv_segment_ids=None if kv_seg is None else torch.from_numpy(kv_seg))
    lse = torch.where(torch.from_numpy(live) > 0, lse, 0.0)
    loss = (out * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(wl)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for name, g, ww in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), **TOL,
                                   err_msg=name)


def test_segment_checks_match_reference():
    q = torch.zeros(1, 4, 2, 16)
    kv = torch.zeros(1, 6, 2, 16)
    with pytest.raises(ValueError, match="kv_segment_ids"):
        flash_attention(q, kv, kv, segment_ids=torch.zeros(1, 4, dtype=int))
    with pytest.raises(ValueError, match="requires segment_ids"):
        flash_attention(q, kv, kv, kv_segment_ids=torch.zeros(1, 6,
                                                              dtype=int))


def test_bwd_kernel_wrappers_refuse_cpu_tensors():
    """K5 / K6 launch or raise: a CPU tensor never reaches a plain
    version through them."""
    x = torch.zeros(1, 4, 2, 16)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError):
        flash_attention_bwd_dq_cuda(x, x, x, x, lse, lse)
    with pytest.raises(ValueError):
        flash_attention_bwd_dkv_cuda(x, x, x, x, lse, lse)


def test_segment_mask_matches_jax():
    qs, ks = _segments(3, 11, 20), _segments(3, 7, 21)
    got = segment_mask(torch.from_numpy(qs), torch.from_numpy(ks))
    want = jax_segment_mask(jnp.asarray(qs), jnp.asarray(ks))
    assert got.shape == (3, 1, 11, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_weight", [True, False])
def test_rms_norm_grad_matches_jax(with_weight):
    x = _rand((3, 5, 64), 30)
    wt = 1.0 + _rand((64,), 31, 0.1) if with_weight else None
    g = _rand((3, 5, 64), 32)

    def jloss(x, w):
        return jnp.sum(jax_rms_norm(x, w, 1e-5) * g)

    want = jax.grad(jloss, argnums=(0, 1) if with_weight else (0,))(
        jnp.asarray(x), None if wt is None else jnp.asarray(wt))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = None if wt is None else torch.from_numpy(wt).requires_grad_(True)
    loss = (rms_norm(tx, tw, 1e-5) * torch.from_numpy(g)).sum()
    got = torch.autograd.grad(loss, (tx,) if tw is None else (tx, tw))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
