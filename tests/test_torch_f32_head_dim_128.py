"""float32 at head_dim 128 — the reference's default configurations'
attention (``LlamaConfig()``: hidden 4096 over 32 heads; the decoder of
``Qwen2VLConfig()``: hidden 1024 over 8 heads) — on the CPU.

  * the builds' tables: (float32, 128) is taken by K1 (every layout),
    K2 (contiguous and paged) and K5 / K6, as is every other float32 D
    <= 256 with D % 8 == 0 -- the 16-bit set (the wrappers' launches at
    128 are in ``tests/test_torch_dit.py``, beside the other head dims';
    the other float32 head dims in ``tests/test_torch_f32_head_dims.py``);
  * the m16n8k8 TF32 fragments of the float32 K5 / K6 at every D
    (``csrc/mma_tf32.cuh``; ``tests/torch_tf32_model.py``): A, B and C
    each owned once, a C fragment used as an A fragment under the permuted
    k order (one step, and the exchange of a tile's 32 columns through
    shared memory), bank-free fragment loads at a row stride of D + 4, and
    the float32 wrappers handing the segment ranges to the kernel;
  * a narrow float32 Qwen2-VL whose decoder attends at head_dim 128
    (hidden 256 over 2 heads, the tower at 64) against the JAX package's:
    greedy and beam tokens identical, train-step losses rtol 1e-5 and
    parameters rtol 1e-5 + atol 5e-5;
  * a narrow float32 Llama at head_dim 128 (2 layers; MHA and GQA):
    the contiguous, paged and int8-KV paged engines token-identical to the
    JAX package's engines of the same kind (int8 against JAX's int8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import qwen2_vl as jvl
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.models import (LlamaForCausalLM, Qwen2VLConfig,
                                     Qwen2VLForConditionalGeneration,
                                     config_from, load_jax_state_dict)
from paddle_tpu_torch.ops import _dispatch
from paddle_tpu_torch.ops import flash_attention_bwd_reference
from paddle_tpu_torch.ops.attention import flash_attention_reference
from paddle_tpu_torch.ops.cuda import decode_attention as k1
from paddle_tpu_torch.ops.cuda import flash_attention as k2
from paddle_tpu_torch.ops.cuda import flash_attention_bwd as k56
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import ServingEngine

import torch_tf32_model as tf32m

D = 128
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=5e-5)


# ---- the tables and the wrappers' launches ------------------------------------

def test_tables_take_float32_head_dim_128_only_among_new_dims():
    f32 = torch.float32
    # float32 takes 128 and, since the float32 builds at every head dim,
    # 96 and the rest of the 16-bit set; past 256 and off the multiples of
    # 8 none
    for table in (k1.HEAD_DIM, k2.HEAD_DIM, k2.FWD_HEAD_DIMS):
        assert 128 in table[f32] and 96 in table[f32]
        assert table[f32] == table[torch.bfloat16]
        assert 264 not in table[f32] and 100 not in table[f32]
    # every bf16 build takes one set of head dims (D <= 256, D % 8 == 0),
    # and every float16 build, forward and backward, the same set
    assert (k1.HEAD_DIM[torch.bfloat16] == k2.HEAD_DIM[torch.bfloat16]
            == k2.FWD_HEAD_DIMS[torch.bfloat16])
    for table in (k1.HEAD_DIM, k2.HEAD_DIM, k2.FWD_HEAD_DIMS,
                  k56.BWD_HEAD_DIMS):
        assert table[torch.float16] == table[torch.bfloat16]
    assert 128 in k56.BWD_HEAD_DIMS[torch.float32]


# ---- the m16n8k8 TF32 fragments of the float32 K5 / K6 (every D) ----------

LANES = 32
FRAGMENTS = {"A": (tf32m.a_map, 4, (16, 8)), "B": (tf32m.b_map, 2, (8, 8)),
             "C": (tf32m.c_map, 4, (16, 8))}


@pytest.mark.parametrize("which", sorted(FRAGMENTS))
def test_fragment_owns_each_element_once(which):
    fmap, regs, shape = FRAGMENTS[which]
    owned = [fmap(lane, r) for lane in range(LANES) for r in range(regs)]
    assert sorted(owned) == [(i, j) for i in range(shape[0])
                             for j in range(shape[1])]


def _warp_product(a_regs, b_regs):
    """The 16 x 8 product the tensor cores form from each lane's A and B
    registers, placed by the PTX maps."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(LANES):
        for r in range(4):
            a[tf32m.a_map(lane, r)] = a_regs[lane][r]
        for r in range(2):
            b[tf32m.b_map(lane, r)] = b_regs[lane][r]
    return a @ b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_c_fragment_is_an_a_fragment_under_the_permuted_k(seed):
    """A C tile (P or dS, 16 x 8) kept in its lanes' registers as A (a[0..3]
    = c[0], c[2], c[1], c[3]) times B read at rows 2t and 2t + 1 equals the
    unpermuted product: the sum over k only changes order."""
    rng = np.random.default_rng(seed)
    p = rng.integers(-9, 10, size=(16, 8)).astype(np.float64)
    y = rng.integers(-9, 10, size=(8, 8)).astype(np.float64)
    c_regs = [[p[tf32m.c_map(lane, r)] for r in range(4)]
              for lane in range(LANES)]
    a_regs = [[c_regs[lane][tf32m.C_AS_A[r]] for r in range(4)]
              for lane in range(LANES)]
    b_regs = [[y[2 * (lane % 4), lane // 4], y[2 * (lane % 4) + 1, lane // 4]]
              for lane in range(LANES)]
    np.testing.assert_array_equal(_warp_product(a_regs, b_regs), p @ y)
    # the same as the map: B's k row t is the C tile's column perm_k(t)
    for k in range(8):
        assert tf32m.perm_k(k) == ([2 * t for t in range(4)]
                                   + [2 * t + 1 for t in range(4)])[k]


@pytest.mark.parametrize("wpr", [2, 4])
def test_exchange_round_trip_over_a_tile(wpr):
    """Phase A's WPR warps of a row group write their slices' C fragments
    at (rg * 4 + wi * NTA + j) * 32 + lane; phase B reads k step kk at (rg
    * 4 + kk) * 32 + lane: over the tile's 32 columns the warp forms P Y."""
    rng = np.random.default_rng(wpr)
    rg_count, nta = 8 // wpr, 4 // wpr
    p = rng.integers(-9, 10, size=(rg_count, 16, 32)).astype(np.float64)
    y = rng.integers(-9, 10, size=(32, 8)).astype(np.float64)
    buf = {}
    for rg in range(rg_count):
        for wi in range(wpr):
            for j in range(nta):
                col0 = (wi * nta + j) * 8
                for lane in range(LANES):
                    buf[(rg * 4 + wi * nta + j) * 32 + lane] = [
                        p[rg][r, col0 + c] for r, c in
                        (tf32m.c_map(lane, x) for x in range(4))]
    assert len(buf) == rg_count * 4 * LANES
    for rg in range(rg_count):
        got = np.zeros((16, 8))
        for kk in range(4):
            regs = [buf[(rg * 4 + kk) * 32 + lane] for lane in range(LANES)]
            a_regs = [[c[tf32m.C_AS_A[r]] for r in range(4)] for c in regs]
            b_regs = [[y[kk * 8 + 2 * (lane % 4), lane // 4],
                       y[kk * 8 + 2 * (lane % 4) + 1, lane // 4]]
                      for lane in range(LANES)]
            got += _warp_product(a_regs, b_regs)
        np.testing.assert_array_equal(got, p[rg] @ y)


@pytest.mark.parametrize("wpr", [1, 2])
def test_forward_fragments_place_every_column(wpr):
    """The float32 K2's fragments (``flash_fwd_tf32_kernel``): S's A from
    Q's 8-byte loads (rows g / g + 8, columns 2t, 2t + 1 as k t, k t + 4)
    and B from K's (key row g, the same columns) form Q K^T; P's C
    fragments -- with two warps a row group each warp's half of the tile's
    n-tiles written at (rg NT + j) 32 + lane and the group's read back --
    as A, V's B read as 8-byte pairs (rows 2t, 2t + 1; columns 16 m + 2g,
    + 1 for the n-tile pair 2m, 2m + 1), and each lane's 4 stored columns
    16 m + 4t .. + 3 place P V's every column once."""
    rng = np.random.default_rng(wpr)
    nt = 8 // wpr                      # n-tiles of 8 keys a tile (NT)
    q = rng.integers(-9, 10, size=(16, 8)).astype(np.float64)
    kk = rng.integers(-9, 10, size=(8, 8)).astype(np.float64)
    a_regs = [[q[g, 2 * t], q[g + 8, 2 * t], q[g, 2 * t + 1],
               q[g + 8, 2 * t + 1]] for g, t in map(_gt, range(LANES))]
    b_regs = [[kk[g, 2 * t], kk[g, 2 * t + 1]]
              for g, t in map(_gt, range(LANES))]
    np.testing.assert_array_equal(_warp_product(a_regs, b_regs), q @ kk.T)
    p = rng.integers(-9, 10, size=(16, 8 * nt)).astype(np.float64)
    v = rng.integers(-9, 10, size=(8 * nt, 16)).astype(np.float64)
    xp = {}
    for wi in range(wpr):              # each warp's half of S's n-tiles
        for j in range(wi * nt // wpr, (wi + 1) * nt // wpr):
            for lane in range(LANES):
                xp[j * 32 + lane] = [p[r, 8 * j + c] for r, c in
                                     (tf32m.c_map(lane, x) for x in range(4))]
    assert len(xp) == nt * LANES
    o = [np.zeros((16, 8)) for _ in range(2)]
    for j in range(nt):
        a_regs = [[xp[j * 32 + lane][tf32m.C_AS_A[r]] for r in range(4)]
                  for lane in range(LANES)]
        for x in range(2):
            b_regs = [[v[8 * j + 2 * t, 2 * g + x],
                       v[8 * j + 2 * t + 1, 2 * g + x]]
                      for g, t in map(_gt, range(LANES))]
            o[x] += _warp_product(a_regs, b_regs)
    out = np.full((16, 16), np.nan)
    for lane in range(LANES):
        g, t = _gt(lane)
        for row, i in ((g, 0), (g + 8, 1)):
            cols = slice(4 * t, 4 * t + 4)
            assert np.isnan(out[row, cols]).all()
            out[row, cols] = [o[0][row, 2 * t], o[1][row, 2 * t],
                              o[0][row, 2 * t + 1], o[1][row, 2 * t + 1]]
    np.testing.assert_array_equal(out, p @ v)


@pytest.mark.parametrize("d", [8, 64, 72, 96, 128, 136, 200, 256])
def test_forward_loads_hit_distinct_banks(d):
    """The float32 K2's rows sit ft_ld(D) = 8 (mod 32) floats apart (Q, K;
    the int8 K / V rows that many bytes) and D + 4 apart (float32 V): each
    half-warp's 8-byte loads -- Q / K at (row g, columns 2t, 2t + 1), V at
    (rows 2t or 2t + 1, columns 2g, 2g + 1) -- cover 32 distinct banks, and
    the int8 2-byte loads of a warp touch distinct words on distinct
    banks."""
    ld, vld = d + (8 - d) % 32, d + 4
    assert ld % 32 == 8 and ld >= d
    for c0 in (0, 8, d - 8):
        for half in (0, 1):
            lanes = range(16 * half, 16 * half + 16)
            for stride, at in ((ld, lambda g, t: g * ld + 2 * t),
                               (vld, lambda g, t: 2 * t * vld + 2 * g)):
                banks = [(at(g, t) + c0 + w) % 32 for g, t in map(_gt, lanes)
                         for w in (0, 1)]
                assert len(set(banks)) == 32, (stride, c0, half)
        for at in (lambda g, t: g * ld + 2 * t,            # K: row g
                   lambda g, t: 2 * t * ld + 2 * g):       # V: row 2t
            words = {(at(g, t) + c0) // 4 for g, t in map(_gt, range(LANES))}
            assert len({w % 32 for w in words}) == len(words)


def _gt(lane):
    """(g, t) of a lane: lane = 4 g + t."""
    return divmod(lane, 4)


@pytest.mark.parametrize("d", [8, 64, 72, 96, 128, 136, 200, 256])
def test_fragment_loads_hit_distinct_banks(d):
    """Tiles sit D + 4 floats a row apart: each scalar fragment load of a
    warp hits 32 distinct banks -- phase A's (row g, column t [+ 4]) of 8
    rows, and phase B's B operand (rows 2t, 2t + 1, column g) of 4 row
    pairs -- at any column offset."""
    ld = d + 4
    for c0 in (0, 8, d - 8):
        for extra in (0, 4):
            banks = {((lane // 4) * ld + lane % 4 + c0 + extra) % 32
                     for lane in range(LANES)}
            assert len(banks) == 32
        for row in (0, 1):
            banks = {((2 * (lane % 4) + row) * ld + lane // 4 + c0) % 32
                     for lane in range(LANES)}
            assert len(banks) == 32


def test_float32_wrapper_hands_the_tile_ranges_to_the_kernel(monkeypatch):
    """With segment ids the float32 K5 / K6 skip tile pairs by the 64-token
    id ranges, as the 16-bit builds do: both wrappers pass q_rng / kv_rng."""
    import paddle_tpu_torch.ops.cuda as pt_cuda
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(k56, "_lib", lambda dtype: Lib())
    monkeypatch.setattr(k56, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(k56, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(pt_cuda, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(_dispatch, "use_kernel", lambda x: True)
    q = torch.zeros(1, 130, 4, D)
    k = torch.zeros(1, 130, 2, D)
    lse = torch.zeros(1, 4, 130)
    seg = torch.from_numpy(np.repeat(np.arange(3, dtype=np.int32), 44)[:130]
                           [None])
    k56.flash_attention_bwd_dq_cuda(q, k, k, q, lse, lse, causal=True,
                                    segment_ids=seg)
    k56.flash_attention_bwd_dkv_cuda(q, k, k, q, lse, lse, causal=True,
                                     segment_ids=seg)
    assert [c[0] for c in calls] == ["flash_attention_bwd_dq",
                                     "flash_attention_bwd_dkv"]
    for _, args in calls:
        assert all(a not in (None, 0) for a in args[6:10])   # ids, ranges


# ---- a narrow float32 Qwen2-VL whose decoder attends at head_dim 128 ----------

QWEN = dict(hidden_size=256, num_attention_heads=2, num_key_value_heads=2,
            intermediate_size=256, vision_hidden_size=128, vision_heads=2)
GATE = 0.5
LR = 1e-4


def _state(model):
    return {k: np.asarray(v)
            for k, v in model.state_dict(include_buffers=True).items()}


def _qwen_pair(**kw):
    pt.seed(53)
    jm = jvl.Qwen2VLForConditionalGeneration(jvl.tiny_qwen2_vl_config(
        **QWEN, **kw))
    jm.set_state_dict({k: jnp.full_like(v, GATE) for k, v in
                       jm.state_dict().items() if k.endswith(".gate")},
                      strict=False)
    jm.eval()
    tm = Qwen2VLForConditionalGeneration(
        Qwen2VLConfig(**dataclasses.asdict(jm.config)), device="cpu")
    load_jax_state_dict(tm, _state(jm))
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def qwen():
    jm, tm = _qwen_pair()
    assert tm.config.head_dim == D and tm.config.dtype == "float32"
    assert tm.config.vision_hidden_size // tm.config.vision_heads == 64
    return jm, tm


@pytest.mark.parametrize("kw", [dict(), dict(num_beams=4, eos_token_id=5)],
                         ids=["greedy", "beam4-eos"])
def test_qwen2_vl_head_dim_128_generate_identical_to_jax(qwen, kw):
    jm, tm = qwen
    rng = np.random.RandomState(45)
    ids = rng.randint(0, 256, (2, 5)).astype(np.int32)
    pix = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    want = np.asarray(jm.generate(jnp.asarray(ids), jnp.asarray(pix),
                                  max_new_tokens=6, **kw))
    _dispatch.reset_kernel_paths()
    got = tm.generate(ids, pix, max_new_tokens=6, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    paths = dict(_dispatch.kernel_paths)
    assert paths[("flash_attention", "plain")] > 0
    assert paths[("decode_attention", "plain")] > 0


def test_qwen2_vl_head_dim_128_train_step_matches_jax():
    """2 AdamW steps of ``build_train_step`` against the JAX package's
    (the batch recipe of ``tests/test_torch_qwen2_vl.py``) at the learning
    rate the card's Qwen2-VL phases train with (1e-4): Adam's first
    update is about lr * g / |g| for every element, so an element whose
    gradient is within float32 sum order of 0 moves by a share of lr that
    the two sum orders decide (at lr 1e-3 one cross-attention element of
    131072 moved 5.5e-5 apart).  The plain backward at head_dim 128 is held
    against the Pallas backward at 1e-5 in ``tests/test_torch_flash_bwd.py``."""
    jm, tm = _qwen_pair()
    jm.train()
    tm.train()
    rng = np.random.RandomState(8)
    batches = []
    for _ in range(2):
        ids = rng.randint(0, 256, (2, 9)).astype(np.int32)
        batches.append({"input_ids": ids[:, :-1],
                        "pixel_values": rng.standard_normal(
                            (2, 3, 16, 16)).astype(np.float32),
                        "labels": ids[:, 1:]})
    hcg = jdist.HybridCommunicateGroup(devices=jax.devices()[:1])
    jdist.set_hybrid_group(hcg)
    try:
        step, params, opt_state = jdist.build_train_step(
            jm, JaxAdamW(LR, weight_decay=0.0), hcg=hcg)
        jl = []
        key = jax.random.key(0)
        for i, b in enumerate(batches):
            batch = jdist.shard_batch({k: jnp.asarray(a) for k, a in
                                       b.items()}, hcg)
            loss, params, opt_state = step(params, opt_state, batch,
                                           jax.random.fold_in(key, i))
            jl.append(float(loss))
        jp = jax.tree.map(np.asarray, params)
    finally:
        jdist.set_hybrid_group(None)
    tstep = build_train_step(tm, AdamW(LR, weight_decay=0.0))
    tl = [float(tstep({k: torch.from_numpy(np.array(a))
                       for k, a in b.items()})) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    got = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(jp)
    for k in jp:
        np.testing.assert_allclose(got[k], jp[k], **PARAM_TOL, err_msg=k)


# ---- a narrow float32 Llama at head_dim 128 through the engines ---------------

LLAMA = {"mha": dict(hidden_size=256, num_attention_heads=2,
                     num_key_value_heads=2, intermediate_size=256),
         "gqa": dict(hidden_size=256, num_attention_heads=2,
                     num_key_value_heads=1, intermediate_size=256)}
MAXLEN, BL = 64, 8
ENGINES = {"contiguous": dict(),
           "paged": dict(paged=True, block_len=BL),
           "int8_paged": dict(paged=True, block_len=BL,
                              kv_cache_dtype="int8")}


@pytest.fixture(scope="module", params=sorted(LLAMA))
def llama(request):
    pt.seed(61)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd", **LLAMA[request.param]))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, _state(jm))
    assert tm.config.head_dim == D and tm.config.dtype == "float32"
    return jm, tm


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


_SYS = _prompt(17, 300)
PROMPTS = ([_prompt(n, 310 + n) for n in (5, 12, 3, 20)]
           + [np.concatenate([_SYS, _prompt(4, 301)]),
              np.concatenate([_SYS, _prompt(6, 302)])])


def _serve(engine, prompts, n_new=8):
    rids = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    out = dict(engine.drain())
    return [out[r] for r in rids]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_llama_head_dim_128_engine_token_identical_to_jax(llama, engine):
    jm, tm = llama
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
