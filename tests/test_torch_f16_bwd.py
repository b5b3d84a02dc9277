"""The plain float16 flash-attention backward (the plain version of K5 /
K6, ``flash_attention_bwd_reference``) against the VJP of the JAX
package's Pallas kernel in interpret mode (``_bwd``: tiles loaded as
float32, dq / dk / dv rounded to float16 at the end), fed JAX's own out
and lse, on the CPU, at head dims 64, 128 and 256: causal GQA, dead rows
(Sq > Skv, causal), packed and cross-attention segment ids, and the range
shapes of ``chip_smoke.py``'s K5 / K6 range rows (dO near 3e2, V near
1e3, Q and K near 1e-2: the float32 dS passes float16's 65504 while the
gradients stay finite).  Each gradient is held within 2e-3 of its
largest magnitude (``F16_OUT_TOL``: both round the outputs to float16,
2^-11, and the Pallas kernel rounds each q head's dk / dv before the
group sum, the plain version once after it) and finite wherever the
Pallas kernel's is.  Head dim 256 and the range shapes are
``test_torch_f16_bwd_d256.py``'s (a file each keeps each alone near
10 s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import flash_attention_pallas

from paddle_tpu_torch.ops import flash_attention_bwd_reference

F16_OUT_TOL = 2e-3


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float16)


def _segments(b, s, seed, max_docs=4):
    rng = np.random.RandomState(seed)
    out = np.zeros((b, s), np.int32)
    for r in range(b):
        n = rng.randint(1, max_docs + 1)
        for c in sorted(rng.choice(np.arange(1, s), n - 1, replace=False)):
            out[r, c:] += 1
    return out


# (id, b, sq, skv, hq, hkv, d, causal, segments, range)
CASES = [
    ("d64_causal_gqa_segments", 1, 128, 128, 4, 2, 64, True, "self",
     False),
    ("d128_causal_gqa_dead_rows", 1, 256, 128, 4, 2, 128, True, None, False),
    ("d128_cross_segments", 1, 64, 128, 2, 2, 128, False, "cross", False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_f16_bwd_reference_matches_pallas_interpret(case):
    check_case(case)


def check_case(case):
    """One case of ``CASES``: the plain backward against the Pallas VJP."""
    _, b, sq, skv, hq, hkv, d, causal, segs, rng = case
    qk, v_scale, do_scale = (1e-2, 1e3, 3e2) if rng else (1.0, 1.0, 1.0)
    q, k = _rand((b, sq, hq, d), 1, qk), _rand((b, skv, hkv, d), 2, qk)
    v = _rand((b, skv, hkv, d), 3, v_scale)
    do = _rand((b, sq, hq, d), 4, do_scale)
    dlse = np.zeros((b, hq, sq), np.float32)
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
    assert out.dtype == jnp.float16 and want[0].dtype == jnp.float16

    def t(a):
        return torch.from_numpy(np.array(a))

    got = flash_attention_bwd_reference(
        t(q), t(k), t(v), t(np.asarray(out)), t(np.asarray(lse)), t(do),
        causal=causal, segment_ids=None if seg is None else t(seg),
        kv_segment_ids=None if kv_seg is None else t(kv_seg))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float16, name
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        fin = np.isfinite(w)
        assert np.isfinite(g[fin]).all(), name
        top = np.abs(w[fin]).max()
        err = np.abs(g - w)[fin].max()
        assert err <= F16_OUT_TOL * top, (name, err, top)
    if causal and sq > skv:                # rows before the diagonal
        assert not got[0][:, :sq - skv].any()
    if rng:
        # the case reaches past float16's range in dS (plain, float32)
        g = hq // hkv
        qf = torch.from_numpy(q).float().transpose(1, 2)
        kf = torch.from_numpy(k).float().repeat_interleave(g, 2)
        vf = torch.from_numpy(v).float().repeat_interleave(g, 2)
        s = torch.einsum("bhqd,bkhd->bhqk", qf, kf) * d ** -0.5
        p = torch.exp(s - torch.from_numpy(np.array(lse))[..., None])
        p = p.masked_fill(~torch.ones(sq, skv, dtype=torch.bool).tril(), 0)
        dof = torch.from_numpy(do).float().transpose(1, 2)
        dp = torch.einsum("bhqd,bkhd->bhqk", dof, vf)
        o32 = torch.from_numpy(np.array(out)).float().transpose(1, 2)
        delta = (dof * o32).sum(-1)
        ds = p * (dp - delta[..., None]) * d ** -0.5
        assert float(ds.abs().max()) > 65504
