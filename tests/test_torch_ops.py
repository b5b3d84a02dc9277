"""The PyTorch port's operators against the JAX package, on the CPU.

Each kernel of the port has a plain PyTorch version, which is what a CPU
tensor runs.  Here the plain versions are held against the JAX package's
Pallas kernels in interpret mode (and against its XLA math paths) on the
same numpy inputs, in float32: K1 flash-decode, K2 flash-attention
forward, K3 RMSNorm, plus RoPE.  The kernels themselves run only on the
card; ``chip_smoke.py`` holds them against these plain versions there.
Also here: the routing contract (CPU -> plain, no silent fallback), the
no-JAX import guard, and the device default.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.attention import (
    cached_decode_attention_reference as jax_decode_ref,
    flash_attention_reference as jax_flash_ref)
from paddle_tpu.ops.pallas.decode_attention import decode_attention_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention_pallas
from paddle_tpu.ops.pallas.rms_norm import rms_norm_pallas
from paddle_tpu.ops import rope as jax_rope

import paddle_tpu_torch
from paddle_tpu_torch.ops import (_dispatch, apply_rope, build_rope_cache,
                                  cache_mask, cached_decode_attention,
                                  cached_decode_attention_reference,
                                  decode_attention_cuda, flash_attention,
                                  flash_attention_fwd_cuda,
                                  flash_attention_reference, fused_rope,
                                  rms_norm, rms_norm_reference,
                                  rms_norm_triton)

REPO = Path(__file__).resolve().parents[1]
# float32 on both sides: the two libraries sum in other orders, so parity
# holds to a few float32 ulps of O(1) values
TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- K1 flash-decode: plain version vs the Pallas kernel + XLA path -------

DECODE_CASES = [
    # (b, s, hq, hkv, pos) — pos None means per-row [5, 130, 253],
    # "zero" per-row [0, 77, 200]
    (2, 1, 4, 4, 77),        # G = 1, scalar
    (3, 1, 8, 2, "zero"),    # G = 4, per-row including 0
    (3, 3, 4, 2, None),      # G = 2, per-row, s = 3
    (2, 3, 8, 2, 0),         # G = 4, scalar first tokens, s = 3
]


@pytest.mark.parametrize("b,s,hq,hkv,pos", DECODE_CASES)
def test_decode_plain_matches_pallas_and_xla(b, s, hq, hkv, pos):
    L, d = 256, 32
    q = _rand((b, s, hq, d), 1)
    k = _rand((b, L, hkv, d), 2)
    v = _rand((b, L, hkv, d), 3)
    if pos is None:
        pos = np.asarray([5, 130, 253][:b], np.int32)
    elif pos == "zero":
        pos = np.asarray([0, 77, 200][:b], np.int32)
    jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
    tpos = _t(pos) if isinstance(pos, np.ndarray) else pos
    want_pallas = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpos, block_kv=128,
        interpret=True)
    want_xla = jax_decode_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jpos)
    got = cached_decode_attention(_t(q), _t(k), _t(v), tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **TOL)


def test_decode_plain_live_len():
    """``live_len`` trims the read; the answer is unchanged."""
    b, s, hq, hkv, L, d = 2, 1, 8, 2, 256, 32
    q, k, v = _rand((b, s, hq, d), 4), _rand((b, L, hkv, d), 5), \
        _rand((b, L, hkv, d), 6)
    pos = np.asarray([10, 100], np.int32)
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   block_kv=128, live_len=128,
                                   interpret=True)
    got = cached_decode_attention_reference(_t(q), _t(k), _t(v), _t(pos),
                                            live_len=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_dead_tail_is_never_read():
    """The port's prefill writes only a slot's first ``bucket`` positions,
    leaving the previous tenant's K/V past them.  Attention over the cache
    must not depend on anything past ``pos + s``: fill the tail with large
    finite garbage and the output is bit-identical."""
    b, s, hq, hkv, L, d = 3, 2, 8, 2, 128, 16
    q, k, v = _rand((b, s, hq, d), 7), _rand((b, L, hkv, d), 8), \
        _rand((b, L, hkv, d), 9)
    pos = np.asarray([3, 40, 100], np.int32)
    base = cached_decode_attention(_t(q), _t(k), _t(v), _t(pos))
    k2, v2 = k.copy(), v.copy()
    for i, p in enumerate(pos):
        k2[i, p + s:] = 1e4 * _rand((L - p - s, hkv, d), 10 + i)
        v2[i, p + s:] = -1e4
    got = cached_decode_attention(_t(q), _t(k2), _t(v2), _t(pos))
    assert torch.equal(got, base)


def test_decode_fully_masked_row_is_zero():
    q, k, v = _rand((1, 1, 4, 16), 1), _rand((1, 8, 2, 16), 2), \
        _rand((1, 8, 2, 16), 3)
    out = cached_decode_attention_reference(_t(q), _t(k), _t(v), -1)
    assert torch.equal(out, torch.zeros_like(out))


def test_cache_mask_matches_reference():
    from paddle_tpu.ops.attention import cache_mask as jax_cache_mask
    pos = np.asarray([0, 5, 9], np.int32)
    np.testing.assert_array_equal(
        cache_mask(_t(pos), 3, 12).numpy(),
        np.asarray(jax_cache_mask(jnp.asarray(pos), 3, 12)))
    np.testing.assert_array_equal(cache_mask(4, 2, 8).numpy(),
                                  np.asarray(jax_cache_mask(4, 2, 8)))


# ---- K2 flash-attention forward: plain version vs the Pallas kernel --------

FLASH_CASES = [
    # (b, sq, skv, hq, hkv, d, causal)
    (1, 128, 128, 2, 2, 32, False),
    (1, 256, 256, 2, 2, 32, True),
    (2, 128, 256, 4, 2, 16, True),     # GQA + Sq < Skv (bottom-right)
    (1, 256, 128, 4, 1, 16, True),     # Sq > Skv: rows 0..127 see nothing
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", FLASH_CASES)
def test_flash_plain_matches_pallas(b, sq, skv, hq, hkv, d, causal):
    q, k, v = _rand((b, sq, hq, d), 11), _rand((b, skv, hkv, d), 12), \
        _rand((b, skv, hkv, d), 13)
    jout, jlse = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        interpret=True)
    out, lse = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    xout, xlse = jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(xout), **TOL)
    if sq > skv and causal:
        dead = sq - skv
        assert torch.equal(out[:, :dead], torch.zeros_like(out[:, :dead]))
        assert bool((lse[:, :, :dead] == -1e30).all())


def test_flash_ragged_lengths_plain():
    """The port takes any Sq/Skv (the prefill bucket is not 128-aligned);
    the plain version agrees with the JAX XLA reference there."""
    q, k, v = _rand((2, 13, 4, 16), 14), _rand((2, 21, 2, 16), 15), \
        _rand((2, 21, 2, 16), 16)
    out, lse = flash_attention_reference(_t(q), _t(k), _t(v), causal=True)
    jout, jlse = jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


# ---- float32 at head_dim 128 (the reference's default configurations) ----
# K1 and K2's plain versions at the head dim of LlamaConfig() and of
# Qwen2VLConfig()'s decoder, at 1e-5 (float32 sum order)

TOL_128 = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,hq,hkv,pos", [(2, 1, 4, 4, 77),
                                            (3, 5, 8, 2, "zero")])
def test_decode_plain_matches_pallas_at_head_dim_128(b, s, hq, hkv, pos):
    L, d = 256, 128
    q = _rand((b, s, hq, d), 31)
    k, v = _rand((b, L, hkv, d), 32), _rand((b, L, hkv, d), 33)
    pos = (np.asarray([0, 77, 200][:b], np.int32) if pos == "zero"
           else pos)
    jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
    tpos = _t(pos) if isinstance(pos, np.ndarray) else pos
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jpos, block_kv=128,
                                   interpret=True)
    got = cached_decode_attention(_t(q), _t(k), _t(v), tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_128)


@pytest.mark.parametrize("sq,skv,hq,hkv,causal,segments", [
    (256, 128, 4, 2, True, False),      # causal GQA, rows 0..127 dead
    (128, 256, 2, 2, False, False),     # not causal, Sq != Skv (cross)
    (256, 256, 4, 2, True, True)])      # packed documents
def test_flash_plain_matches_pallas_at_head_dim_128(sq, skv, hq, hkv, causal,
                                                    segments):
    d = 128
    q, k, v = (_rand((1, sq, hq, d), 34), _rand((1, skv, hkv, d), 35),
               _rand((1, skv, hkv, d), 36))
    seg = (np.repeat(np.arange(3, dtype=np.int32), [100, 60, 96])[None]
           if segments else None)
    jout, jlse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, segment_ids=None if seg is None else jnp.asarray(seg))
    out, lse = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               return_lse=True,
                               segment_ids=None if seg is None else _t(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL_128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL_128)
    if causal and sq > skv:
        assert not out[:, :sq - skv].any()
        assert bool((lse[:, :, :sq - skv] == -1e30).all())


def test_flash_ragged_causal_gqa_at_head_dim_128():
    """Sq 77 over Skv 61 (queries 0..15 see no key): the Pallas kernel
    takes 128-aligned lengths only, so the XLA reference stands here."""
    q, k, v = (_rand((2, 77, 8, 128), 37), _rand((2, 61, 2, 128), 38),
               _rand((2, 61, 2, 128), 39))
    out, lse = flash_attention_reference(_t(q), _t(k), _t(v), causal=True)
    jout, jlse = jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL_128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL_128)
    assert not out[:, :16].any()


# ---- K3 RMSNorm: plain version vs the Pallas kernel -------------------------

@pytest.mark.parametrize("with_weight", [True, False])
def test_rms_norm_plain_matches_pallas(with_weight):
    x = _rand((16, 256), 17)
    w = _rand((256,), 18) if with_weight else None
    want = rms_norm_pallas(jnp.asarray(x),
                           None if w is None else jnp.asarray(w),
                           epsilon=1e-5, interpret=True)
    got = rms_norm(_t(x), None if w is None else _t(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm_plain_backward_matches_jax():
    import jax
    from paddle_tpu.ops.norms import rms_norm_reference as jax_rms
    x, w, g = _rand((4, 64), 19), _rand((64,), 20), _rand((4, 64), 21)
    _, vjp = jax.vjp(lambda a, b: jax_rms(a, b, 1e-5), jnp.asarray(x),
                     jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    rms_norm_reference(tx, tw, 1e-5).backward(_t(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), **TOL)


# ---- RoPE --------------------------------------------------------------------

def test_rope_matches_jax():
    jcos, jsin = jax_rope.build_rope_cache(64, 16, base=500000.0)
    cos, sin = build_rope_cache(64, 16, base=500000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    x = _rand((2, 5, 3, 16), 22)
    ids = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    # the same cos/sin tables on both sides: the rotation itself is checked
    want = jax_rope.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(ids))
    got = apply_rope(_t(x), _t(jcos), _t(jsin), _t(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want0 = jax_rope.apply_rope(jnp.asarray(x), jcos, jsin)
    got0, _ = fused_rope(_t(x), _t(x), _t(jcos), _t(jsin))
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), **TOL)


# ---- routing: CPU -> plain, CUDA -> kernel or raise ---------------------------

def test_cpu_tensors_route_to_plain_versions():
    _dispatch.reset_kernel_paths()
    x = torch.ones(2, 8)
    rms_norm(x, None)
    q = torch.zeros(1, 1, 2, 8)
    kv = torch.zeros(1, 4, 2, 8)
    cached_decode_attention(q, kv, kv, 0)
    flash_attention(q, q, q)
    assert dict(_dispatch.kernel_paths) == {
        ("rms_norm", "plain"): 1, ("decode_attention", "plain"): 1,
        ("flash_attention", "plain"): 1}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises — it never computes the
    plain version itself, whatever it is given."""
    x = torch.zeros(1, 1, 2, 16)
    kv = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError):
        decode_attention_cuda(x, kv, kv, 0)
    with pytest.raises(ValueError):
        flash_attention_fwd_cuda(x, x, x)
    with pytest.raises(ValueError):
        rms_norm_triton(torch.zeros(2, 16))


def test_reference_mode_is_explicit_and_scoped():
    assert not _dispatch.in_reference_mode()
    with _dispatch.reference_mode():
        assert _dispatch.in_reference_mode()
    assert not _dispatch.in_reference_mode()
    assert _dispatch.use_kernel(torch.zeros(1)) is False


def test_unported_features_raise():
    q = torch.zeros(1, 1, 2, 8)
    kv = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        cached_decode_attention(q, kv, kv, 0, k_scale=torch.ones(1))
    with pytest.raises(NotImplementedError, match="extra_mask"):
        cached_decode_attention(q, kv, kv, 0,
                                extra_mask=torch.ones(1, 4, dtype=bool))
    with pytest.raises(NotImplementedError, match="A10"):
        flash_attention(q, q, q, dropout_p=0.1)


# ---- the package: no JAX, the card by default -----------------------------------

def test_import_leaves_jax_out():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.models, paddle_tpu_torch.ops, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.distributed; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_source_imports_no_jax():
    pat = re.compile(r"^\s*(import\s+(jax|paddle_tpu)\b(?!_torch)|"
                     r"from\s+(jax|paddle_tpu)(\.|\s)(?!_torch))", re.M)
    files = list((REPO / "paddle_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.default_device()
    with pytest.raises(RuntimeError):
        paddle_tpu_torch.default_device("cuda")
    assert paddle_tpu_torch.default_device("cpu") == torch.device("cpu")
