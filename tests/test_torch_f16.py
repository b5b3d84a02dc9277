"""float16 in every forward kernel build of the port, on the CPU.

  * the tables: every forward build of K1 (contiguous, paged, int8, paged
    int8), K2 (contiguous, paged, paged int8) maps float16 to
    ``BF16_HEAD_DIMS`` itself, K4 takes float16 x at the 16-bit builds'
    alignment, and each float16 build lives in a library of its own (the
    bf16 source compiled with ``-DPTT_F16``); a float16 q at a head dim
    outside the set is refused naming ROADMAP B2; the backward K5 / K6
    takes float16 at the same set, from a library of its own, and
    ``flash_attention`` under autograd launches K2, K5 and K6 there;
  * the float16 builds' exact int8 converters, restated in numpy (the byte
    into the mantissa of the float16 1024, one pair subtraction) over all
    256 bytes;
  * the plain versions against the JAX package's Pallas kernels in
    interpret mode at float16, each within 2e-3 of the largest output:
    cached decode attention contiguous, paged, int8 and paged int8 at s =
    1 and 5, D 64, 128 and 256; flash attention causal, with segment ids
    and at Sq != Skv, D 64 and 128; ``weight_only_linear`` against
    ``int8_matmul_pallas``;
  * a float16 ``tiny_llama_config`` Llama and the narrow D 64, G 8 Llama
    bridged from JAX's ``state_dict()``: float16 parameters, forward
    logits, a prefill and two ``decode_step`` calls within F16_LOGIT_TOL
    of JAX's float16 ones; the narrow Llama's four engines token-identical
    to the JAX package's float16 engines of the same kind (int8 against
    JAX's int8, never against float argmax: ROADMAP C).  The tiny model's
    engines are not held token for token: its float16 logits tie (the top
    two of a prefill equal in float16), and on that tie the JAX package's
    own paged and contiguous engines pick different tokens
    (``test_tiny_f16_reference_engines_split_on_a_tie``).

The kernels themselves run only on the card (``chip_smoke.py`` phase 2's
``/f16`` rows and ``serving_f16``); here the wrappers are reached through
their argument checks and a stand-in library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.quant as jq
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.models.generation import init_kv_cache as jax_init_cache
from paddle_tpu.ops.pallas.decode_attention import decode_attention_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention_pallas
from paddle_tpu.ops.pallas.int8_matmul import int8_matmul_pallas
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     init_kv_cache, load_jax_state_dict)
from paddle_tpu_torch.nn import quant
from paddle_tpu_torch.ops import (_dispatch, cached_decode_attention,
                                  flash_attention)
from paddle_tpu_torch.ops import cuda as pt_cuda
from paddle_tpu_torch.ops.cuda import (BF16_HEAD_DIMS, DTYPE_CODES, _build,
                                       check_attention_args, library)
from paddle_tpu_torch.ops.cuda import decode_attention as k1
from paddle_tpu_torch.ops.cuda import flash_attention as k2
from paddle_tpu_torch.ops.cuda import flash_attention_bwd as k56
from paddle_tpu_torch.ops.cuda import int8_matmul as k4
from paddle_tpu_torch.serving import ServingEngine

F16 = torch.float16
# the plain versions against the Pallas kernels: both round the output to
# float16 (2^-11), the Pallas kernel P too (p.astype(v.dtype)), which the
# plain version keeps in float32; 2e-3 of the largest output is 4x that
F16_OUT_TOL = 2e-3


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float16)


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(
        -127, 128, size=shape).astype(np.int8)


def _scales(shape, seed):
    return (0.002 + 0.02 * np.random.default_rng(seed).random(shape)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= F16_OUT_TOL * np.abs(want).max(), err


# ---- (a) the tables --------------------------------------------------------------

def test_forward_tables_take_float16_at_the_bf16_set():
    """Every forward table maps float16 to ``BF16_HEAD_DIMS`` itself, and
    so does the backward's; K4 takes float16 x at N % 16; float16 is dtype
    code 2, in libraries of its own (every source has one)."""
    for table in (k1.HEAD_DIM, k2.HEAD_DIM, k2.FWD_HEAD_DIMS,
                  k56.BWD_HEAD_DIMS):
        assert table[F16] is BF16_HEAD_DIMS
    assert k56.BWD_HEAD_DIMS[torch.bfloat16] is BF16_HEAD_DIMS
    assert k4.N_ALIGN[F16] == k4.N_ALIGN[torch.bfloat16] == 16
    assert DTYPE_CODES[F16] == 2
    for name in _build.SOURCES:
        lib = library(name, F16)
        assert _build.VARIANTS[lib] == (name, ("-DPTT_F16",))
        assert library(name, torch.bfloat16) == name
        assert _build._library(lib) != _build._library(name)
    assert "flash_attention_bwd_f16" in _build.LIBRARIES


class _FakeCuda(torch.Tensor):
    """A CPU tensor that passes the device test."""

    @property
    def is_cuda(self):
        return True


def _fake(shape, dtype):
    return torch.zeros(shape, dtype=dtype).as_subclass(_FakeCuda)


@pytest.mark.parametrize("d,ok", [(64, True), (72, True), (128, True),
                                  (136, True), (256, True), (12, False),
                                  (264, False)])
@pytest.mark.parametrize("int8", [False, True])
def test_float16_check_takes_the_set_and_names_roadmap_b2(d, ok, int8):
    q = _fake((2, 1, 8, d), F16)
    kv = _fake((2, 16, 1, d), torch.int8 if int8 else F16)
    tables = [k1.HEAD_DIM, k2.HEAD_DIM] + ([] if int8 else
                                           [k2.FWD_HEAD_DIMS])
    for table in tables:
        if ok:
            assert check_attention_args("k", q, kv, kv, table, int8) == 2
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP B2"):
                check_attention_args("k", q, kv, kv, table, int8)


class _FakeLib:
    """Stands in for a built library: records each entry's arguments and
    the dtype each library was asked for."""

    def __init__(self):
        self.calls, self.dtypes = [], []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def no_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(pt_cuda, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(k56, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(k4, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(_dispatch, "use_kernel", lambda x: True)

    def fake_lib(dtype=torch.bfloat16):
        lib.dtypes.append(dtype)
        return lib
    for mod in (k1, k2, k56, k4):
        monkeypatch.setattr(mod, "_lib", fake_lib)
        monkeypatch.setattr(mod, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(k4, "_weight_map", lambda *a: None)
    return lib


def _qkv(d=128, s=8, grad=False):
    return tuple(torch.zeros(1, s, h, d, dtype=F16, requires_grad=grad)
                 for h in (8, 2, 2))


def test_float16_forward_launches_with_its_code(no_card):
    """K1, K2 (with and without ids), K2-paged and K4 launch float16 with
    dtype code 2, from the float16 library."""
    q, k, v = _qkv(s=1)
    cache = torch.zeros(1, 64, 2, 128, dtype=F16)
    k1.decode_attention_cuda(q, cache, cache, 3)
    q, k, v = _qkv()
    k2.flash_attention_fwd_cuda(q, k, v, causal=True)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    k2.flash_attention_fwd_cuda(q, k, v, causal=True, segment_ids=seg)
    pool = torch.zeros(2, 64, 2, 128, dtype=F16)
    k2.flash_attention_fwd_paged_cuda(q, pool, pool, 0,
                                      torch.zeros(1, 2, dtype=torch.int32))
    k4.int8_matmul_cuda(torch.zeros(8, 64, dtype=F16),
                        torch.zeros(64, 32, dtype=torch.int8),
                        torch.ones(32))
    names = [n for n, _ in no_card.calls]
    assert names == ["decode_attention", "flash_attention_fwd",
                     "flash_attention_fwd", "flash_attention_fwd_paged",
                     "int8_matmul"]
    # the dtype code: K1 after scale, K2 after scale and causal, K2-paged
    # after scale, K4 after K N ksplit k_chunk
    a = [args for _, args in no_card.calls]
    assert (a[0][18], a[1][17], a[2][17], a[3][15], a[4][11]) == (2,) * 5
    # with ids the 16-bit build takes the tile ranges too
    assert a[2][7] is not None and a[2][8] is not None
    assert set(no_card.dtypes) == {F16}


def test_float16_k4_alignment_and_route(no_card):
    """float16 x goes to K4 at N % 16 == 0 and is refused at N % 16 == 8;
    the dispatch rule routes it the same way."""
    x = torch.zeros(8, 64, dtype=F16)
    with pytest.raises(NotImplementedError, match="N of 16"):
        k4.int8_matmul_cuda(x, torch.zeros(64, 24, dtype=torch.int8),
                            torch.ones(24))
    assert quant.int8_matmul_path(x, 64, 32) == "kernel"
    assert quant.int8_matmul_path(x, 64, 24) == "dequant"


def test_float16_backward_names_b2_4b(no_card):
    """float16 reaches K5 / K6 (the test keeps its name from when the
    float16 backward was refused naming ROADMAP B2.4b): both wrappers
    launch with dtype code 2 from the float16 library, with tile ranges
    beside packed ids; ``flash_attention`` on float16 tensors that need a
    gradient launches K2 forward, then K5 and K6 in its backward."""
    q, k, v = _qkv()
    lse = torch.zeros(1, 8, 8)
    for fn in (k56.flash_attention_bwd_dq_cuda,
               k56.flash_attention_bwd_dkv_cuda):
        fn(q, k, v, q, lse, lse, causal=True)
    seg = torch.tensor([[0, 0, 0, 1, 1, 1, 1, 2]], dtype=torch.int32)
    k56.flash_attention_bwd_dq_cuda(q, k, v, q, lse, lse, causal=True,
                                    segment_ids=seg)
    names = [n for n, _ in no_card.calls]
    assert names == ["flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                     "flash_attention_bwd_dq"]
    a = [args for _, args in no_card.calls]
    # the dtype code after scale and causal: K5 at 19, K6 at 20
    assert (a[0][19], a[1][20], a[2][19]) == (2, 2, 2)
    assert a[0][8] is None and a[2][8] is not None and a[2][9] is not None
    assert set(no_card.dtypes) == {F16}
    no_card.calls.clear()
    qg, kg, vg = _qkv(grad=True)
    flash_attention(qg, kg, vg, causal=True).float().sum().backward()
    assert [n for n, _ in no_card.calls] == [
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv"]
    assert all(g is not None and g.dtype == F16
               for g in (qg.grad, kg.grad, vg.grad))


# ---- the float16 int8 converters, restated ---------------------------------------

def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: bytes of (y << 32 | x) picked by sel's nibbles."""
    src = (int(y) << 32) | int(x)
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _f16_pair_sub(a, b):
    """sub.rn.f16x2 on two words."""
    av = np.array([a & 0xFFFF, a >> 16], np.uint16).view(np.float16)
    bv = np.array([b & 0xFFFF, b >> 16], np.uint16).view(np.float16)
    return (av - bv).astype(np.float16)


@pytest.mark.parametrize("k4_order", [False, True])
def test_float16_int8_conversion_is_exact_for_every_byte(k4_order):
    """The float16 builds' converters (``int8x4_to_e16``: pairs of bytes
    {0, 1}, {2, 3}; K4's ``int8x4_to_e16x2x2``: {0, 2}, {1, 3}) restated:
    every byte, as int8, comes out as its exact float16."""
    sels = (0x4240, 0x4341) if k4_order else (0x4140, 0x4342)
    order = (0, 2, 1, 3) if k4_order else (0, 1, 2, 3)
    got, want = [], []
    for i in range(64):
        w = 0x03020100 + 0x04040404 * i
        u = w ^ 0x80808080
        for sel in sels:
            got.extend(_f16_pair_sub(_byte_perm(u, 0x64, sel), 0x64806480))
        want.extend(np.int8(np.uint8(4 * i + j)) for j in order)
    assert np.array_equal(np.asarray(got, np.float32),
                          np.asarray(want, np.float32))


# ---- (b) the plain versions against the Pallas kernels, float16 ------------------

@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s,pos", [(1, [0, 255, 130]), (5, [3, 250, 128])])
@pytest.mark.parametrize("layout", ["contiguous", "paged", "int8",
                                    "paged_int8"])
def test_decode_plain_matches_pallas_f16(layout, s, pos, d):
    """K1's plain version at float16 q (each layout, G 4) against
    ``decode_attention_pallas(..., interpret=True)``: 256 positions, the
    paged pool in 128-token blocks, the int8 cache in 128-token granules
    (contiguous) or per-block scales (paged)."""
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
        tables = np.asarray([[3, 2], [3, 1], [4, 1]], np.int32)
        jkw["block_tables"], tkw["block_tables"] = jnp.asarray(tables), \
            _t(tables)
    if int8:
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw.update(k_scale=_t(ks), v_scale=_t(vs))
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   interpret=True, **jkw)
    assert want.dtype == jnp.float16
    got = cached_decode_attention(_t(q), _t(k), _t(v), _t(pos), **tkw)
    assert got.dtype == F16
    _close(got.numpy(), want)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv,segments", [
    (256, 256, False),      # causal GQA
    (256, 256, True),       # packed documents
    (128, 256, False)])     # Sq != Skv, bottom-right causal
def test_flash_plain_matches_pallas_f16(sq, skv, segments, d):
    """K2's plain version at float16 (8 query heads over 2 KV heads,
    causal) against ``flash_attention_pallas(..., interpret=True)``: out
    within 2e-3 of the largest, lse (float32) within 1e-3."""
    hq, hkv = 8, 2
    q, k, v = (_rand((1, sq, hq, d), 6), _rand((1, skv, hkv, d), 7),
               _rand((1, skv, hkv, d), 8))
    seg = (np.repeat(np.arange(3, dtype=np.int32), [100, 60, 96])[None]
           if segments else None)
    jout, jlse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True, segment_ids=None if seg is None else jnp.asarray(seg))
    out, lse = flash_attention(_t(q), _t(k), _t(v), causal=True,
                               return_lse=True,
                               segment_ids=None if seg is None else _t(seg))
    assert out.dtype == F16 and jout.dtype == jnp.float16
    _close(out.numpy(), jout)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("rows", [1, 8, 20])
def test_weight_only_linear_matches_pallas_f16(rows):
    """``weight_only_linear``'s plain route and K4's plain version at
    float16 x against ``int8_matmul_pallas(..., interpret=True)``."""
    k, n = 256, 384
    x = _rand((rows, k), 1)
    w8, s = jq.weight_quantize(jnp.asarray(
        np.random.default_rng(2).normal(size=(k, n)).astype(np.float32)))
    want = int8_matmul_pallas(jnp.asarray(x), w8, s, interpret=True)
    assert want.dtype == jnp.float16
    tx, tw, ts = (torch.from_numpy(np.array(a)) for a in (x, w8, s))
    _dispatch.reset_kernel_paths()
    got = quant.weight_only_linear(tx, tw, weight_scale=ts)
    assert dict(_dispatch.kernel_paths) == {("int8_matmul", "plain"): 1}
    assert got.dtype == F16
    _close(got.numpy(), want)
    _close(k4.int8_matmul_reference(tx, tw, ts).numpy(), want)


# ---- (c) float16 Llamas bridged from JAX -----------------------------------------

# float16 logits: the port and JAX round different intermediates to
# float16 (2^-11), so they sit a few float16 ulps of the largest logit
# apart -- bf16's bound (2^-5) scaled by the 8x finer rounding; a wrong
# head_dim, mask or GQA mapping moves them by O(1)
F16_LOGIT_TOL = 2 ** -8
NARROW = dict(hidden_size=512, num_attention_heads=8, num_key_value_heads=1,
              intermediate_size=256, num_hidden_layers=2)


def _state(model):
    return {k: np.asarray(v)
            for k, v in model.state_dict(include_buffers=True).items()}


def _pair(**widths):
    pt.seed(67)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd", dtype="float16",
                           **widths))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, _state(jm))
    assert tm.config.dtype == "float16"
    assert all(p.dtype == F16 for p in tm.parameters())
    return jm, tm


MODELS = {"tiny": {}, "d64_g8": NARROW}


@pytest.fixture(scope="module", params=sorted(MODELS))
def llama(request):
    jm, tm = _pair(**MODELS[request.param])
    if request.param == "d64_g8":
        c = tm.config
        assert c.head_dim == 64 and c.num_attention_heads == 8 * \
            c.num_key_value_heads
    return jm, tm


def _within(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= F16_LOGIT_TOL * np.abs(want).max(), err


def test_f16_forward_and_decode_steps_match_jax(llama):
    """Forward logits over 16 tokens, then a 16-token prefill at pos 0 into
    a 64-position cache and two decode steps at per-row positions, in
    float16: each within F16_LOGIT_TOL of the largest of JAX's."""
    jm, tm = llama
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 256, (2, 16)).astype(np.int32)
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids))
    jl = jm(jnp.asarray(ids))
    tl = tl if isinstance(tl, torch.Tensor) else tl[0]
    jl = jl if not isinstance(jl, tuple) else jl[0]
    _within(tl, jl)
    jc = jax_init_cache(jm.config, 2, 64)
    tc = init_kv_cache(tm.config, 2, 64, device="cpu")
    steps = [(ids, 0)]
    steps += [(rng.randint(0, 256, (2, 1)).astype(np.int32),
               np.asarray([16 + t, 16 + t], np.int32)) for t in range(2)]
    for ids, pos in steps:
        jpos = pos if isinstance(pos, int) else jnp.asarray(pos)
        tpos = pos if isinstance(pos, int) else torch.from_numpy(pos)
        jl, jc = jm.decode_step(jnp.asarray(ids), jc, jpos)
        with torch.no_grad():
            tl, tc = tm.decode_step(torch.from_numpy(ids), tc, tpos)
        assert tl.dtype == F16
        _within(tl, jl)


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


_SYS = _prompt(17, 400)
PROMPTS = ([_prompt(n, 410 + n) for n in (5, 12, 3, 20)]
           + [np.concatenate([_SYS, _prompt(4, 401)]),
              np.concatenate([_SYS, _prompt(6, 402)])])
MAXLEN, BL = 64, 8
ENGINES = {"contiguous": dict(),
           "paged": dict(paged=True, block_len=BL),
           "int8_paged": dict(paged=True, block_len=BL,
                              kv_cache_dtype="int8"),
           "int8_contiguous": dict(kv_cache_dtype="int8")}


def _serve(engine, prompts, n_new=8):
    rids = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    out = dict(engine.drain())
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def narrow():
    return _pair(**NARROW)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_f16_engine_token_identical_to_jax(narrow, engine):
    """The narrow Llama's float16 engines against the JAX package's
    float16 engines of the same kind (int8 KV against JAX's int8), on the
    plain route."""
    jm, tm = narrow
    kw = dict(num_slots=3, max_length=MAXLEN, prefill_batch=2,
              **ENGINES[engine])
    want = _serve(JaxEngine(jm, **kw), PROMPTS)
    _dispatch.reset_kernel_paths()
    teng = ServingEngine(tm, device="cpu", **kw)
    got = _serve(teng, PROMPTS)
    assert got == want
    paths = dict(_dispatch.kernel_paths)
    assert not any(p == "kernel" for _, p in paths)
    sfx = "_int8" if "int8" in engine else ""
    op = "decode_attention_paged" if teng.paged else "decode_attention"
    assert paths[(op + sfx, "plain")] > 0
    if teng.paged:
        assert teng.kv.stats["prefix_hit_tokens"] == 16


def test_tiny_f16_reference_engines_split_on_a_tie():
    """Why the tiny float16 model's engines are not held token for token:
    the float16 prefill logits of PROMPTS[2] tie (the top two equal in
    float16, 3e-5 apart in float32, below float16's 2.4e-4 step there),
    and the JAX package's own paged and contiguous float16 engines break
    the tie differently; the port's engines agree with each other."""
    jm, tm = _pair()
    jc = jax_init_cache(jm.config, 1, MAXLEN)
    logits, _ = jm.decode_step(jnp.asarray(PROMPTS[2][None]), jc, 0)
    top = np.sort(np.asarray(logits[0, -1]))[-2:]
    assert top[0] == top[1]
    kw = dict(num_slots=3, max_length=MAXLEN, prefill_batch=2)
    paged = dict(kw, **ENGINES["paged"])
    assert (_serve(JaxEngine(jm, **kw), PROMPTS)
            != _serve(JaxEngine(jm, **paged), PROMPTS))
    assert (_serve(ServingEngine(tm, device="cpu", **kw), PROMPTS)
            == _serve(ServingEngine(tm, device="cpu", **paged), PROMPTS))
