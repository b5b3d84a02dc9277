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
  * a model of the float32 K5 / K6 (``csrc/flash_attention_bwd.cu``
    ``tc_body``, three TF32 passes on ``mma.sync``;
    ``tests/torch_tf32_model.py``): ``cvt.rna.tf32.f32`` restated on bits
    by the kernel's integer rounding (ties, signed zeros, subnormals, inf,
    the largest finite value; a NaN still reaching the product) and by
    value, the split's float32 accuracy, the tile walk of both
    kernels at D 16-256 (64-row tile sums, the GQA group sum, causal with
    dead rows, a non-causal cross shape, packed ids with tile-range skips)
    within 1e-5 of the float64 plain backward, and a single TF32 pass
    failing that bar;
  * a model of the float32 K2 family (``csrc/flash_attention_fwd.cu``
    ``flash_fwd_tf32_kernel``, the same three passes;
    ``tests/torch_tf32_model.py`` ``forward``): its walk at D 16-256 --
    causal GQA with dead rows, not causal with Sq != Skv and Sq 1, packed
    ids skipping key tiles, paged over shuffled tables at block_len 16
    and 64, an int8 pool -- within 1e-5 of the float64 plain forward,
    the heaviest q tiles first, a skipped row group seeing no key and an
    unmasked one every key of its tile, a single pass failing the bar;
    the float32 wrapper handing the kernel its 64-token id ranges; the
    plain forward versions computing float64 inputs in float64;
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
from paddle_tpu_torch.ops.attention import (
    cached_decode_attention_reference, flash_attention_bwd_reference,
    flash_attention_reference)
from paddle_tpu_torch.ops.cuda import BF16_HEAD_DIMS
from paddle_tpu_torch.ops.cuda import decode_attention as k1
from paddle_tpu_torch.ops.cuda import flash_attention as k2
from paddle_tpu_torch.ops.cuda import flash_attention_bwd as k56

import torch_tf32_model as tf32m

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


# ---- the float32 K5 / K6: 3xTF32 (tests/torch_tf32_model.py) ---------------

# cvt.rna.tf32.f32 on float32 bits: (input bits, output bits)
RNA_CASES = {
    "tie_rounds_away": (0x3F801000, 0x3F802000),
    "negative_tie_rounds_away": (0xBF801000, 0xBF802000),
    "below_tie": (0x3F800FFF, 0x3F800000),
    "above_tie": (0x3F801001, 0x3F802000),
    "carry_into_exponent": (0x3FFFF000, 0x40000000),
    "plus_zero": (0x00000000, 0x00000000),
    "minus_zero": (0x80000000, 0x80000000),
    "subnormal_tie": (0x00001000, 0x00002000),
    "smallest_subnormal": (0x00000001, 0x00000000),
    "subnormal_to_normal": (0x007FF000, 0x00800000),
    "largest_finite_to_inf": (0x7F7FFFFF, 0x7F800000),
    "inf": (0x7F800000, 0x7F800000),
    "minus_inf": (0xFF800000, 0xFF800000),
}


def _bits(u):
    return np.array([u], np.uint32).view(np.float32)


@pytest.mark.parametrize("case", sorted(RNA_CASES))
def test_tf32_rna_on_bits(case):
    x, want = RNA_CASES[case]
    got = tf32m.tf32_rna(_bits(x)).view(np.uint32)[0]
    assert got == want, (case, hex(got), hex(want))
    assert got & 0x1FFF == 0


@pytest.mark.parametrize("nan", [0x7FC00000, 0x7F800001, 0x7FFFFFFF,
                                 0xFFFFFFFF])
def test_a_nan_reaches_the_product(nan):
    """The integer rounding may turn a NaN's hi into a number; its lo is
    NaN, so the three passes' product is NaN, as the float32 product."""
    hi, lo = tf32m.split(_bits(nan))
    assert np.isnan(hi[0]) or np.isnan(lo[0])
    with np.errstate(invalid="ignore"):
        got = tf32m.product(np.zeros((1, 1), np.float32),
                            np.full((1, 8), _bits(nan)[0], np.float32),
                            np.ones((8, 1), np.float32))
    assert np.isnan(got[0, 0])


def test_tf32_rna_is_rounding_to_ten_bits_ties_away():
    """Against the same rounding done by value in float64 over every
    exponent of the normal range."""
    rng = np.random.default_rng(0)
    x = (rng.uniform(1, 2, 4096) * 2.0 ** rng.integers(-120, 120, 4096)
         * rng.choice([-1, 1], 4096)).astype(np.float32)
    x[:64] = (1 + (np.arange(64) * 2 + 1) / 2.0 ** 11).astype(np.float32)
    e = np.floor(np.log2(np.abs(x.astype(np.float64))))
    ulp = 2.0 ** (e - 10)
    want = np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(tf32m.tf32_rna(x).astype(np.float64), want)


def test_three_passes_keep_float32_accuracy():
    """hi + lo is within 2^-21 of x, and lo hi + hi lo + hi hi within
    2^-20 of a product, where one TF32 product is 2^-11 off."""
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(2, 8192)).astype(np.float32)
    hi, lo = tf32m.split(x)
    assert np.all(np.abs(x - (hi.astype(np.float64) + lo))
                  <= 2.0 ** -21 * np.abs(x))
    yh, yl = tf32m.split(y)
    exact = x.astype(np.float64) * y
    three = (lo.astype(np.float64) * yh + hi.astype(np.float64) * yl
             + hi.astype(np.float64) * yh)
    one = hi.astype(np.float64) * yh
    assert np.all(np.abs(three - exact) <= 2.0 ** -20 * np.abs(exact))
    assert np.max(np.abs(one - exact) / np.abs(exact)) > 2.0 ** -12


def _bwd_inputs(b, sq, skv, hq, hkv, d, causal, segments, seed):
    """Seeded float32 inputs, the plain forward's out / lse, delta, and
    (seg_q, seg_kv) ids: None, packed documents of 20-70 tokens (some
    64-token tile pairs then share no document) or the ring-hop form."""
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, sq, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
            for _ in range(2))
    dlse = rng.normal(size=(b, hq, sq)).astype(np.float32)
    seg_q = seg_kv = None
    if segments == "packed":
        cuts = np.cumsum(rng.integers(20, 70, size=(b, sq)), axis=1)
        seg_q = seg_kv = (np.arange(sq)[None, :, None]
                          >= cuts[:, None, :]).sum(-1).astype(np.int32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    kw = {}
    if seg_q is not None:
        kw = dict(segment_ids=torch.from_numpy(seg_q))
    out, lse = flash_attention_reference(tq, tk, tv, causal=causal, **kw)
    delta = ((tdo * out).sum(-1).transpose(1, 2)
             - torch.from_numpy(dlse)).contiguous()
    return (q, k, v, do, dlse, out.numpy(), lse.numpy(), delta.numpy(),
            seg_q, seg_kv, kw)


def _exact(q, k, v, out, lse, do, dlse, causal, kw):
    """The plain backward computed in float64 (the chip rows' yardstick)."""
    return [t.numpy() for t in flash_attention_bwd_reference(
        *(torch.from_numpy(np.asarray(x)).double()
          for x in (q, k, v, out, lse, do, dlse)),
        causal=causal, **{n: t for n, t in kw.items()})]


TC_SHAPES = {
    # causal GQA, Sq > Skv: queries 0..15 see no key
    "causal_gqa_dead_rows": (1, 77, 61, 4, 2, True, None),
    # not causal, Sq < Skv
    "cross": (1, 40, 130, 2, 1, False, None),
    # packed documents, tile pairs whose id ranges miss are skipped
    "packed": (2, 130, 130, 4, 2, True, "packed"),
}


@pytest.mark.parametrize("shape", sorted(TC_SHAPES))
@pytest.mark.parametrize("d", [16, 64, 72, 96, 128, 136, 200, 256])
def test_tf32_walk_equals_float64_backward(d, shape):
    """K5 and K6's walk in three TF32 passes (K5 128 / K6 64 rows a CTA up
    to D 128, 32 above; 32-row streamed tiles; S / dP in partials of 32
    columns; 64-row tile sums; K6 over the GQA group) within (1e-5, 1e-5)
    of the plain backward in float64, dead rows and unseen keys exactly 0;
    packed rows skip tile pairs and still lose nothing."""
    b, sq, skv, hq, hkv, causal, segments = TC_SHAPES[shape]
    (q, k, v, do, dlse, out, lse, delta, seg_q, seg_kv,
     kw) = _bwd_inputs(b, sq, skv, hq, hkv, d, causal, segments, d)
    walks = []
    got = tf32m.backward(q, k, v, do, lse, delta, causal=causal,
                         seg_q=seg_q, seg_kv=seg_kv, walks=walks)
    want = _exact(q, k, v, out, lse, do, dlse, causal, kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)
    keep = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        keep = torch.ones(sq, skv, dtype=torch.bool).tril(skv - sq)
    keep = keep.numpy()[None].repeat(b, 0)
    if seg_q is not None:
        keep = keep & (seg_q[:, :, None] == seg_kv[:, None, :])
    dead_q, dead_k = ~keep.any(2), ~keep.any(1)
    assert not got[0][dead_q].any()
    assert not got[1][dead_k].any() and not got[2][dead_k].any()
    if shape == "causal_gqa_dead_rows":
        assert dead_q.sum() == b * (sq - skv)
    if segments is not None:
        # the ids did skip tiles the causal walk alone would visit
        full = [tf32m.walk(kind == "dkv", bi, r0,
                           tf32m.rows_a_cta(d, kind == "dkv"), sq, skv,
                           hq // hkv, causal)
                for kind, bi, _, r0, _ in walks]
        assert sum(map(len, full)) > sum(len(w[-1]) for w in walks)


def test_one_tf32_pass_misses_the_bar():
    """The guard on the two extra passes: a single TF32 product at a
    mid-size shape lies far past (1e-5, 1e-5) where three passes hold it."""
    (q, k, v, do, dlse, out, lse, delta, _, _,
     kw) = _bwd_inputs(1, 128, 128, 4, 2, 64, True, None, 5)
    want = _exact(q, k, v, out, lse, do, dlse, True, kw)
    for passes, ok in ((1, False), (3, True)):
        got = tf32m.backward(q, k, v, do, lse, delta, causal=True,
                             passes=passes)
        ratio = max(float(np.max(np.abs(g - w) / (1e-5 + 1e-5 * np.abs(w))))
                    for g, w in zip(got, want))
        assert (ratio <= 1) == ok, (passes, ratio)
        if not ok:
            assert ratio > 10


# ---- the float32 K2 family: 3xTF32 (tests/torch_tf32_model.py forward) ------

def _fwd_inputs(b, sq, skv, hq, hkv, d, segments, seed):
    """Seeded float32 q (B, Sq, Hq, D), k, v (B, Skv, Hkv, D) and packed
    ids of 20-70 tokens a document (some 64-token tiles then share none)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
            for _ in range(2))
    seg = None
    if segments == "packed":
        cuts = np.cumsum(rng.integers(20, 70, size=(b, sq)), axis=1)
        seg = (np.arange(sq)[None, :, None]
               >= cuts[:, None, :]).sum(-1).astype(np.int32)
    return q, k, v, seg


def _paged_inputs(d, bl, int8, seed, b=3, s=70, mb_keys=256, hq=4, hkv=2,
                  pos=(-1, 3, 150)):
    """A suffix prefill of ``s`` queries a row at offsets ``pos`` (row 0's
    first query sees no key) over a shuffled pool of ``bl``-token blocks,
    two spare: (q, k_pool, v_pool, k_scale, v_scale, pos, table)."""
    rng = np.random.default_rng(seed)
    mb = mb_keys // bl
    n_blocks = b * mb + 2
    table = rng.permutation(n_blocks)[:b * mb].reshape(b, mb).astype(
        np.int32)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    if int8:
        kp, vp = (rng.integers(-127, 128, size=(n_blocks, bl, hkv, d))
                  .astype(np.int8) for _ in range(2))
        ks, vs = ((0.002 + 0.02 * rng.random((n_blocks, hkv)))
                  .astype(np.float32) for _ in range(2))
    else:
        kp, vp = (rng.normal(size=(n_blocks, bl, hkv, d)).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    return q, kp, vp, ks, vs, np.array(pos, np.int32), table


FWD_SHAPES = {
    # causal GQA, Sq > Skv: queries 0..19 see no key; two q tiles at D <= 128
    "causal_gqa_dead_rows": (1, 150, 130, 4, 2, True, None),
    # not causal, Sq != Skv; a one-query row
    "cross": (1, 40, 130, 2, 1, False, None),
    "cross_one_query": (2, 1, 70, 2, 2, False, None),
    # packed documents: key tiles whose id ranges miss the q tile's skipped
    "packed": (2, 200, 200, 4, 2, True, "packed"),
    # the paged walk over shuffled tables, float32 and int8 pools
    "paged_block_len_16": (16, False),
    "paged_block_len_64": (64, False),
    "paged_int8": (16, True),
}


def _visible_fwd(sq, skv, off, kv_len, causal, seg_q=None, seg_kv=None):
    """(Sq, Skv) bool of the visible pairs of one batch row."""
    keep = np.arange(skv)[None, :] < kv_len
    keep = keep & np.ones((sq, 1), bool)
    if causal:
        keep &= np.arange(skv)[None, :] <= np.arange(sq)[:, None] + off
    if seg_q is not None:
        keep &= seg_q[:, None] == seg_kv[None, :]
    return keep


def _check_walks(walks, d, sq, skv, keep_of, n_qt, hq, b):
    """The CTAs run the heaviest q tiles first; a skipped row group sees no
    key of its tile, an unmasked one sees every key of it."""
    bq, nk, _ = tf32m.fwd_tiles(d)
    assert [w[2] // bq for w in walks] == [
        qt for qt, _, _ in tf32m.fwd_cta_order(n_qt, hq, b)]
    assert [w[2] for w in walks] == sorted((w[2] for w in walks),
                                           reverse=True)
    for bi, _, q0, walk in walks:
        keep = keep_of(bi)
        for u, flags in walk:
            for rg, flag in enumerate(flags):
                r0 = q0 + 16 * rg
                blk = keep[r0:min(sq, r0 + 16), u * nk:u * nk + nk]
                if flag is None:
                    assert not blk.any()
                elif not flag:
                    assert blk.all() and blk.shape[1] == nk


@pytest.mark.parametrize("shape", sorted(FWD_SHAPES))
@pytest.mark.parametrize("d", [16, 64, 72, 96, 128, 136, 200, 256])
def test_tf32_forward_walk_equals_float64_forward(d, shape):
    """The float32 K2 body's walk in three TF32 passes (128 queries and
    64-key tiles up to D 128, 64 and 32 above; S in partials of 32 columns;
    the online softmax in exp2 units with each lane's partial sums; P as
    the A operand of P V) within (1e-5, 1e-5) of the plain forward in
    float64 (lse 1e-5), rows that see no key exactly 0 (lse -1e30); the
    heaviest q tiles first, packed rows skipping key tiles, paged walks at
    block_len 16 and 64 and an int8 pool (two passes over its exact
    values) losing nothing."""
    walks = []
    if shape.startswith("paged"):
        bl, int8 = FWD_SHAPES[shape]
        q, kp, vp, ks, vs, pos, table = _paged_inputs(d, bl, int8, d + bl)
        got, lse = tf32m.forward(q, kp, vp, causal=True, pos=pos,
                                 table=table, k_scale=ks, v_scale=vs,
                                 walks=walks)
        assert lse is None
        kw = {}
        if int8:
            kw = dict(k_scale=torch.from_numpy(ks).double(),
                      v_scale=torch.from_numpy(vs).double())
        want = cached_decode_attention_reference(
            torch.from_numpy(q).double(), torch.from_numpy(kp),
            torch.from_numpy(vp), torch.from_numpy(pos),
            block_tables=torch.from_numpy(table), **kw).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        assert not got[0, 0].any()            # pos -1: query 0 sees no key
        b, s, hq = q.shape[:3]
        kv_len = [min(p + s, table.shape[1] * bl) for p in pos]
        _check_walks(walks, d, s, table.shape[1] * bl,
                     lambda bi: _visible_fwd(s, table.shape[1] * bl,
                                             int(pos[bi]), kv_len[bi], True),
                     -(-s // tf32m.fwd_tiles(d)[0]), hq, b)
        return
    b, sq, skv, hq, hkv, causal, segments = FWD_SHAPES[shape]
    q, k, v, seg = _fwd_inputs(b, sq, skv, hq, hkv, d, segments, d)
    got, lse = tf32m.forward(q, k, v, causal=causal, seg_q=seg, seg_kv=seg,
                             walks=walks)
    kw = {} if seg is None else dict(segment_ids=torch.from_numpy(seg))
    want, wlse = (t.numpy() for t in flash_attention_reference(
        *(torch.from_numpy(x).double() for x in (q, k, v)), causal=causal,
        **kw))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, **TOL)
    live = wlse > -1e29
    np.testing.assert_allclose(lse[live], wlse[live], rtol=0, atol=1e-5)
    assert np.all(lse[~live] == np.float32(-1e30))
    assert not got.transpose(0, 2, 1, 3)[~live].any()
    if shape == "causal_gqa_dead_rows":
        assert (~live).sum() == b * hq * (sq - skv)

    def keep_of(bi):
        return _visible_fwd(sq, skv, skv - sq, skv, causal,
                            None if seg is None else seg[bi],
                            None if seg is None else seg[bi])
    n_qt = -(-sq // tf32m.fwd_tiles(d)[0])
    _check_walks(walks, d, sq, skv, keep_of, n_qt, hq, b)
    if segments is not None:
        # the ids did skip key tiles the causal walk alone would visit
        bq, nk, _ = tf32m.fwd_tiles(d)
        full = sum(len(tf32m.fwd_walk(q0, bq, nk, sq, skv, skv - sq, skv,
                                      causal)) for _, _, q0, _ in walks)
        assert full > sum(len(w[-1]) for w in walks)


def test_one_tf32_pass_misses_the_forward_bar():
    """The guard on the two extra passes of the forward: one TF32 pass of
    Q K^T and P V lies far past (1e-5, 1e-5) of the float64 forward where
    three hold it."""
    q, k, v, _ = _fwd_inputs(1, 128, 128, 4, 2, 64, None, 5)
    want = flash_attention_reference(
        *(torch.from_numpy(x).double() for x in (q, k, v)),
        causal=True)[0].numpy()
    for passes, ok in ((1, False), (3, True)):
        got = tf32m.forward(q, k, v, causal=True, passes=passes)[0]
        ratio = float(np.max(np.abs(got - want) / (1e-5 + 1e-5 * np.abs(want))))
        assert (ratio <= 1) == ok, (passes, ratio)
        if not ok:
            assert ratio > 10


def test_float32_forward_hands_the_tile_ranges_to_the_kernel(no_card,
                                                              monkeypatch):
    """With segment ids the float32 K2 skips key tiles by the 64-token id
    ranges (``RANGE_TILE``, the body's kIdRange) where the 16-bit builds
    take 128-token ones: the wrapper computes them and passes q_rng /
    kv_rng."""
    tiles = []
    real = k2.segment_tile_ranges

    def spy(ids, tile=k2.SEG_TILE):
        tiles.append(tile)
        return real(ids, tile)

    monkeypatch.setattr(k2, "segment_tile_ranges", spy)
    q = torch.zeros(1, 130, 4, 64)
    k = torch.zeros(1, 130, 2, 64)
    seg = torch.from_numpy(np.repeat(np.arange(3, dtype=np.int32), 44)[:130]
                           [None])
    k2.flash_attention_fwd_cuda(q, k, k, causal=True, segment_ids=seg)
    k2.flash_attention_fwd_cuda(q, k, k, causal=True, segment_ids=seg,
                                kv_segment_ids=seg)
    assert tiles == [k2.RANGE_TILE] * 3 == [64] * 3
    assert [c[0] for c in no_card.calls] == ["flash_attention_fwd"] * 2
    for _, args in no_card.calls:
        assert all(a not in (None, 0) for a in args[5:9])   # ids, ranges
    # the ranges the model of the body walks with
    np.testing.assert_array_equal(
        real(seg, k2.RANGE_TILE).numpy(), tf32m.tile_ranges(seg.numpy()))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_computes_float64_in_float64(causal):
    """``flash_attention_reference`` and ``cached_decode_attention_reference``
    on float64 inputs (``chip_smoke.py`` holds the float32 K2 family
    against them) return float64 equal to a float64 softmax attention far
    inside float32's rounding, the int8 cache dequantized in float64."""
    rng = np.random.default_rng(4)
    b, sq, skv, hq, hkv, d = 2, 12, 9, 4, 2, 40
    q = torch.from_numpy(rng.normal(size=(b, sq, hq, d)))
    k, v = (torch.from_numpy(rng.normal(size=(b, skv, hkv, d)))
            for _ in range(2))

    def softmax_attention(q, k, v, keep):
        qh = q.transpose(1, 2)
        kh, vh = (t.transpose(1, 2).repeat_interleave(hq // hkv, 1)
                  for t in (k, v))
        s = (qh @ kh.transpose(-1, -2) * d ** -0.5).masked_fill(
            ~keep, float("-inf"))
        return ((torch.softmax(s, -1).nan_to_num() @ vh).transpose(1, 2),
                torch.logsumexp(s, -1))

    keep = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        keep = keep.tril(skv - sq)
    out, lse = flash_attention_reference(q, k, v, causal=causal)
    want, wlse = softmax_attention(q, k, v, keep)
    live = keep.any(-1)
    assert out.dtype == lse.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(lse[..., live].numpy(),
                               wlse[..., live].numpy(), rtol=1e-12)
    # the paged int8 cache at per-row offsets: K / V dequantized in float64
    pos = torch.tensor([0, 5])
    kp, vp = (torch.from_numpy(rng.integers(-127, 128, size=(4, 4, hkv, d))
                               .astype(np.int8)) for _ in range(2))
    ks, vs = (torch.from_numpy(0.002 + 0.02 * rng.random((4, hkv)))
              for _ in range(2))
    table = torch.tensor([[3, 1], [0, 2]], dtype=torch.int32)
    got = cached_decode_attention_reference(q[:, :3], kp, vp, pos,
                                            block_tables=table, k_scale=ks,
                                            v_scale=vs)
    assert got.dtype == torch.float64
    kd, vd = ((p[table.long()].double() * sc[table.long()][:, :, None, :,
                                                            None])
              .reshape(b, 8, hkv, d) for p, sc in ((kp, ks), (vp, vs)))
    for r in range(b):
        kv_keep = (torch.arange(8)[None] <= pos[r] + torch.arange(3)[:, None])
        w, _ = softmax_attention(q[r:r + 1, :3], kd[r:r + 1], vd[r:r + 1],
                                 kv_keep)
        np.testing.assert_allclose(got[r:r + 1].numpy(), w.numpy(),
                                   rtol=1e-10, atol=1e-12)


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
