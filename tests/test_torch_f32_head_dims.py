"""float32 at every head_dim <= 256 with D % 8 == 0 in every attention build
(the K1 family, K2 contiguous / segmented / paged / paged-int8, K5 / K6),
on the CPU.

  * the tables: every float32 table is the 16-bit set; D 264 and D 100 are
    refused naming ROADMAP B2 before any launch, and every wrapper
    launches at D 8, 64, 96, 136, 200 and 256 with that D and float32's
    dtype code (tensors that pass the device test, a library that records
    its calls);
  * a model of the float32 K1 body's lanes (``csrc/decode_attention.cu``,
    ``decode_attention_kernel<float, KV, EPL, KPI, PAGED>`` at a runtime
    D): at EPL 1, 2, 4 and 8, the least that covers D in 32 lanes, each
    element of [0, D) is owned by one lane, no lane reads past D, and each
    lane's vector load is aligned to its width;
  * a model of the float32 K5 / K6 split body at a runtime D
    (``csrc/flash_attention_bwd.cu``, ``bwd_dq_f32_rt_kernel`` /
    ``bwd_dkv_f32_rt_kernel``): at D % 16 == 8 over a quad and at 8
    threads a row, each column owned once, the shuffle sum the same bits on
    every thread of the group, and the walk's dq / dk / dv equal to the
    plain backward at 1e-5;
  * the plain versions against the JAX package's Pallas kernels in
    interpret mode at float32 D 64, 96 and 136, 1e-5: cached decode
    attention in its four layouts at s = 1 and 5, flash attention forward
    (out and lse) and backward (dq, dk, dv).

The kernels themselves run only on the card (``chip_smoke.py`` phase 2's
``/f32`` rows, ``serving_f32_tinyllama`` and ``training_f32_d256``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import decode_attention_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention_pallas

from paddle_tpu_torch.ops import (_dispatch, cached_decode_attention,
                                  flash_attention)
from paddle_tpu_torch.ops import cuda as pt_cuda
from paddle_tpu_torch.ops.attention import (flash_attention_bwd_reference,
                                            flash_attention_reference)
from paddle_tpu_torch.ops.cuda import BF16_HEAD_DIMS
from paddle_tpu_torch.ops.cuda import decode_attention as k1
from paddle_tpu_torch.ops.cuda import flash_attention as k2
from paddle_tpu_torch.ops.cuda import flash_attention_bwd as k56

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = (64, 96, 136)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(
        -127, 128, size=shape).astype(np.int8)


def _scales(shape, seed):
    return (0.002 + 0.02 * np.random.default_rng(seed).random(shape)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the tables ----------------------------------------------------------------

def test_every_float32_table_is_the_16_bit_set():
    for table in (k1.HEAD_DIM, k2.HEAD_DIM, k2.FWD_HEAD_DIMS,
                  k56.BWD_HEAD_DIMS):
        assert table[F32] == BF16_HEAD_DIMS == table[torch.bfloat16] \
            == table[torch.float16]
    assert BF16_HEAD_DIMS == frozenset(range(8, 257, 8))


class _FakeLib:
    """Stands in for a built library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def no_card(monkeypatch):
    """The wrappers on CPU tensors: the device test passes, and a launch
    reaches a fake library."""
    lib = _FakeLib()
    monkeypatch.setattr(pt_cuda, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(k56, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(_dispatch, "use_kernel", lambda x: True)
    for mod in (k1, k2, k56):
        monkeypatch.setattr(mod, "_lib", lambda *dtype: lib)
        monkeypatch.setattr(mod, "stream_ptr", lambda device: 0)
    return lib


def _calls(d):
    """Every float32 wrapper at head_dim ``d``: (entry name, index of D in
    its arguments, call) -- K1 in its four layouts at s = 1, K2 causal and
    segmented, K2-paged(-int8) over 16-token blocks, K5 and K6."""
    q = torch.zeros(2, 1, 4, d)
    qw = torch.zeros(2, 8, 4, d)
    kw = torch.zeros(2, 8, 2, d)
    pool, pool8 = torch.zeros(4, 16, 2, d), torch.zeros(4, 16, 2, d,
                                                         dtype=torch.int8)
    sc = torch.ones(4, 2)
    tbl = torch.zeros(2, 2, dtype=torch.int32)
    cache, cache8 = torch.zeros(2, 64, 2, d), torch.zeros(
        2, 64, 2, d, dtype=torch.int8)
    csc = torch.ones(2, 8, 2)
    seg = torch.zeros(2, 8, dtype=torch.int32)
    lse = torch.zeros(2, 4, 8)
    return [
        ("decode_attention", 12,
         lambda: k1.decode_attention_cuda(q, cache, cache, 3)),
        ("decode_attention_int8", 14,
         lambda: k1.decode_attention_int8_cuda(q, cache8, cache8, 3,
                                               k_scale=csc, v_scale=csc)),
        ("decode_attention_paged", 13,
         lambda: k1.decode_attention_paged_cuda(q, pool, pool, 3, tbl)),
        ("decode_attention_paged_int8", 15,
         lambda: k1.decode_attention_paged_int8_cuda(
             q, pool8, pool8, 3, tbl, k_scale=sc, v_scale=sc)),
        ("flash_attention_fwd", 14,
         lambda: k2.flash_attention_fwd_cuda(qw, kw, kw, causal=True)),
        ("flash_attention_fwd", 14,
         lambda: k2.flash_attention_fwd_cuda(qw, kw, kw, causal=True,
                                             segment_ids=seg)),
        ("flash_attention_fwd_paged", 10,
         lambda: k2.flash_attention_fwd_paged_cuda(qw, pool, pool, 0, tbl)),
        ("flash_attention_fwd_paged_int8", 12,
         lambda: k2.flash_attention_fwd_paged_int8_cuda(qw, pool8, pool8, 0,
                                                        tbl, sc, sc)),
        ("flash_attention_bwd_dq", 16,
         lambda: k56.flash_attention_bwd_dq_cuda(qw, kw, kw, qw, lse, lse,
                                                 causal=True)),
        ("flash_attention_bwd_dkv", 17,
         lambda: k56.flash_attention_bwd_dkv_cuda(qw, kw, kw, qw, lse, lse,
                                                  causal=True)),
    ]


@pytest.mark.parametrize("d", [8, 64, 96, 136, 200, 256])
def test_every_wrapper_launches_float32(no_card, d):
    """Each float32 build launches at ``d`` with D passed through and
    float32's dtype code (1, the argument before the stream)."""
    for name, i_d, call in _calls(d):
        no_card.calls.clear()
        call()
        (got, args), = no_card.calls
        assert got == name and args[i_d] == d
        assert args[-2] == pt_cuda.DTYPE_CODES[F32] == 1


@pytest.mark.parametrize("d", [264, 100])
def test_other_float32_head_dims_name_b2(no_card, d):
    """Past 256, or off the multiples of 8, every wrapper refuses naming
    ROADMAP B2, before any launch."""
    for _, _, call in _calls(d):
        with pytest.raises(NotImplementedError, match="ROADMAP B2"):
            call()
    assert no_card.calls == []


# ---- a model of K1's float32 lanes -------------------------------------------

LANES = 32


def k1_epl(d: int) -> int:
    """Elements a lane of the float32 K1 body holds at head_dim ``d``: the
    least of 1, 2, 4 and 8 that covers ``d`` in 32 lanes (the C entry's
    ``f32_launch``)."""
    return next(e for e in (1, 2, 4, 8) if LANES * e >= d)


def lane_elements(lane: int, epl: int, d: int):
    """The elements lane ``lane`` loads: [lane EPL, lane EPL + EPL), or
    none where that starts at or past ``d`` (``lane_on``)."""
    d0 = lane * epl
    return list(range(d0, d0 + epl)) if d0 < d else []


@pytest.mark.parametrize("d", sorted(BF16_HEAD_DIMS))
def test_k1_lanes_own_each_element_once(d):
    epl = k1_epl(d)
    owned = [lane_elements(lane, epl, d) for lane in range(LANES)]
    flat = sorted(e for els in owned for e in els)
    assert flat == list(range(d))          # each element once, none past D
    for lane, els in enumerate(owned):
        if not els:
            continue
        # a lane's vector load: a row starts at a multiple of D elements,
        # so its offset is a multiple of its width (float2 / float4 / two
        # float4; int8 char2 / char4 / two char4) given 16-byte rows
        for esz in (4, 1):
            for row in (0, 1, 7):
                start = (row * d + lane * epl) * esz
                assert start % (min(epl, 4) * esz) == 0


@pytest.mark.parametrize("epl,ds", [(2, (40, 48, 56, 64)),
                                    (4, (72, 96, 120, 128)),
                                    (8, (136, 200, 248, 256))])
def test_k1_instances_by_head_dim(epl, ds):
    """The 2- and 8-element instances take the head dims past 32 and 128
    that their narrower neighbours cannot."""
    assert all(k1_epl(d) == epl for d in ds)
    assert k1_epl(32) == 1 and k1_epl(8) == 1


# ---- a model of K5 / K6's float32 split body at a runtime D -----------------

CHUNKS = 8    # float4 chunks a thread holds at most (the C template's C)


def group_of(d: int) -> int:
    """Threads a row: a quad up to D 128, an octet above."""
    return 4 if d <= 128 else 8


def owned_columns(g: int, d: int, t: int):
    """The columns thread ``g`` of a ``t``-thread group owns: float4 chunks
    g + t e (e < CHUNKS) below D."""
    return [4 * c + x for e in range(CHUNKS) for c in (g + t * e,)
            if c < d // 4 for x in range(4)]


def group_sum(parts):
    """The kernel's xor shuffles (1, 2, 4) over the group's partials in
    float32: each thread's result, in the order the kernel adds."""
    x = [np.float32(p) for p in parts]
    o = 1
    while o < len(x):
        x = [np.float32(x[g] + x[g ^ o]) for g in range(len(x))]
        o <<= 1
    return x


@pytest.mark.parametrize("d", [8, 24, 72, 120, 136, 200, 248, 256])
def test_split_group_owns_each_column_once(d):
    t = group_of(d)
    owned = [owned_columns(g, d, t) for g in range(t)]
    assert sorted(c for cols in owned for c in cols) == list(range(d))
    assert max(len(cols) for cols in owned) <= 4 * CHUNKS


@pytest.mark.parametrize("d", [72, 136, 200, 256])
def test_group_sum_is_the_same_bits_on_every_thread(d):
    t = group_of(d)
    rng = np.random.default_rng(d)
    for _ in range(20):
        a, b = rng.normal(size=(2, d)).astype(np.float32)
        parts = [np.float32(np.dot(a[owned_columns(g, d, t)],
                                   b[owned_columns(g, d, t)]))
                 for g in range(t)]
        sums = group_sum(parts)
        assert len({s.tobytes() for s in sums}) == 1
        np.testing.assert_allclose(sums[0], np.dot(a.astype(np.float64), b),
                                   rtol=1e-5, atol=1e-5)


def _split_backward(q, k, v, do, lse, delta, causal, scale):
    """K5 and K6's runtime-D walk in numpy: per (query, key) pair, each
    group thread's partial over its own columns, the group sum, p and dS,
    then each thread's update of its own columns; K6 sums the GQA group's
    q heads into the KV head's dk / dv."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    t = group_of(d)
    g_ = hq // hkv
    off = skv - sq
    cols = [owned_columns(g, d, t) for g in range(t)]
    dq = np.zeros_like(q)
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for bi in range(b):
        for h in range(hq):
            hk = h // g_
            for i in range(sq):
                for j in range(skv):
                    if causal and j > i + off:
                        continue
                    s = group_sum([np.dot(q[bi, i, h, c], k[bi, j, hk, c])
                                   for c in cols])[0]
                    dp = group_sum([np.dot(do[bi, i, h, c], v[bi, j, hk, c])
                                    for c in cols])[0]
                    p = np.float32(np.exp(np.float32(s * scale
                                                      - lse[bi, h, i])))
                    ds = np.float32(p * (dp - delta[bi, h, i]) * scale)
                    for c in cols:
                        dq[bi, i, h, c] += ds * k[bi, j, hk, c]
                        dv[bi, j, hk, c] += p * do[bi, i, h, c]
                        dk[bi, j, hk, c] += ds * q[bi, i, h, c]
    return dq, dk, dv


@pytest.mark.parametrize("d", [72, 200])
@pytest.mark.parametrize("causal,sq,skv", [(True, 7, 5), (False, 3, 6)])
def test_split_walk_equals_plain_backward(d, causal, sq, skv):
    """A quad at D 72 (D % 16 == 8: a thread of two holds one chunk more)
    and an octet at 200; causal GQA with dead rows and a non-causal cross
    shape."""
    rng = np.random.default_rng(1)
    b, hq, hkv = 1, 4, 2
    q, do = (rng.normal(size=(b, sq, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attention_reference(tq, tk, tv, causal=causal)
    delta = (tdo * out).sum(-1).transpose(1, 2)
    got = _split_backward(q, k, v, do, lse.numpy(), delta.numpy(), causal,
                          d ** -0.5)
    want = flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                         causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w.numpy(), **TOL, err_msg=name)
    if causal:
        assert not got[0][:, :sq - skv].any()      # dead rows: zero dq


# ---- the plain versions against the Pallas kernels (interpret mode) ----------

@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("s,pos", [(1, [0, 255, 130]), (5, [3, 250, 128])])
@pytest.mark.parametrize("layout", ["contiguous", "paged", "int8",
                                    "paged_int8"])
def test_decode_plain_matches_pallas(layout, s, pos, d):
    """K1's plain version (each layout, 4 query heads a KV head) against
    ``decode_attention_pallas(..., interpret=True)``: 256 positions, the
    paged pool in 128-token blocks, the int8 cache in 128-token scale
    granules (contiguous) or per-block scales (paged): the Pallas kernel's
    128-aligned blocks."""
    b, hq, hkv, L, bl = 3, 8, 2, 256, 128
    q = _rand((b, s, hq, d), 1)
    pos = np.asarray(pos, np.int32)
    int8 = layout in ("int8", "paged_int8")
    paged = layout.startswith("paged")
    n = 5 if paged else b
    rows = bl if paged else L
    if int8:
        k, v = _int8((n, rows, hkv, d), 2), _int8((n, rows, hkv, d), 3)
        sshape = (n, hkv) if paged else (b, L // bl, hkv)
        ks, vs = _scales(sshape, 4), _scales(sshape, 5)
    else:
        k, v = _rand((n, rows, hkv, d), 2), _rand((n, rows, hkv, d), 3)
    jkw, tkw = {}, {}
    if paged:
        # rows 0 and 1 share block 3; row 2 reads blocks 4, 1
        tables = np.asarray([[3, 2], [3, 1], [4, 1]], np.int32)
        jkw["block_tables"], tkw["block_tables"] = jnp.asarray(tables), \
            _t(tables)
    if int8:
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw.update(k_scale=_t(ks), v_scale=_t(vs))
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   interpret=True, **jkw)
    got = cached_decode_attention(_t(q), _t(k), _t(v), _t(pos), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("sq,skv,causal,segments", [
    (128, 128, True, False),      # causal GQA
    (128, 128, False, False),     # not causal
    (128, 128, True, True),       # packed documents
    (64, 128, True, False)])      # Sq != Skv, bottom-right causal
def test_flash_plain_matches_pallas(sq, skv, causal, segments, d):
    """K2's plain version (8 query heads over 2 KV heads) against
    ``flash_attention_pallas(..., interpret=True)``: out and lse."""
    hq, hkv = 8, 2
    q, k, v = (_rand((1, sq, hq, d), 6), _rand((1, skv, hkv, d), 7),
               _rand((1, skv, hkv, d), 8))
    seg = (np.repeat(np.arange(3, dtype=np.int32), [50, 30, 48])[None]
           if segments else None)
    jout, jlse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, segment_ids=None if seg is None else jnp.asarray(seg))
    out, lse = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               return_lse=True,
                               segment_ids=None if seg is None else _t(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("sq,skv,causal,segments", [
    (256, 128, True, False),      # causal GQA, dead rows
    (128, 128, True, True),       # packed documents
    (64, 128, False, False)])     # not causal, Sq != Skv
def test_flash_bwd_plain_matches_pallas(sq, skv, causal, segments, d):
    """K5 / K6's plain version against the vjp of
    ``flash_attention_pallas(..., interpret=True)`` with a given dO and
    dlse, fed JAX's own out and lse: dq, dk, dv."""
    hq, hkv = 4, 2
    q, k, v = (_rand((1, sq, hq, d), 1), _rand((1, skv, hkv, d), 2),
               _rand((1, skv, hkv, d), 3))
    do, dlse = _rand((1, sq, hq, d), 4), _rand((1, hq, sq), 5)
    seg = (np.repeat(np.arange(3, dtype=np.int32), [50, 30, 48])[None]
           if segments else None)

    def f(q, k, v):
        return flash_attention_pallas(
            q, k, v, causal=causal, interpret=True,
            segment_ids=None if seg is None else jnp.asarray(seg))

    (out, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    got = flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(out), _t(lse), _t(do), _t(dlse),
        causal=causal, segment_ids=None if seg is None else _t(seg))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    if causal and sq > skv:                # rows before the diagonal
        assert not got[0][:, :sq - skv].any()


# ---- the float32 rows' yardstick on the card: the plain backward in float64

@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_computes_float64_in_float64(causal):
    """``flash_attention_bwd_reference`` on float64 inputs (``chip_smoke.py``
    holds the float32 K5 / K6 against it) returns float64 gradients equal
    to autograd's of a float64 softmax attention (with the lse cotangent),
    far inside float32's rounding."""
    rng = np.random.default_rng(3)
    b, sq, skv, hq, hkv, d = 1, 12, 9, 4, 2, 40
    q, do = (torch.from_numpy(rng.normal(size=(b, sq, hq, d)))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, skv, hkv, d)))
            for _ in range(2))
    dlse = torch.from_numpy(rng.normal(size=(b, hq, sq)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    qh, kh, vh = (t.transpose(1, 2) for t in leaves)
    kh, vh = (t.repeat_interleave(hq // hkv, 1) for t in (kh, vh))
    s = qh @ kh.transpose(-1, -2) * d ** -0.5
    if causal:     # bottom-right: query i sees keys j <= i + skv - sq
        keep = torch.ones(sq, skv, dtype=torch.bool).tril(skv - sq)
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1)
    out = (torch.softmax(s, -1).nan_to_num() @ vh).transpose(1, 2)
    ((out * do).sum() + (lse.nan_to_num(neginf=0.0) * dlse).sum()).backward()
    got = flash_attention_bwd_reference(
        q, k, v, out.detach(), lse.detach().nan_to_num(neginf=-1e30), do,
        dlse, causal=causal)
    for g, leaf in zip(got, leaves):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), rtol=1e-10,
                                   atol=1e-10)
