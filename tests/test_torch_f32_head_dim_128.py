"""float32 at head_dim 128 — the reference's default configurations'
attention (``LlamaConfig()``: hidden 4096 over 32 heads; the decoder of
``Qwen2VLConfig()``: hidden 1024 over 8 heads) — on the CPU.

  * the builds' tables: (float32, 128) is taken by K1 (every layout),
    K2 (contiguous and paged) and K5 / K6, as is every other float32 D
    <= 256 with D % 8 == 0 -- the 16-bit set (the wrappers' launches at
    128 are in ``tests/test_torch_dit.py``, beside the other head dims';
    the other float32 head dims in ``tests/test_torch_f32_head_dims.py``);
  * a model of the float32 head_dim-128 body of K5 / K6
    (``csrc/flash_attention_bwd.cu``, ``bwd_dq_f32_split_kernel`` /
    ``bwd_dkv_f32_split_kernel``): each of the D columns owned by exactly
    one thread of a row's quad, each dot product summed over all of them
    by the two xor shuffles (the same bits on the quad's four threads),
    and the walk's dq / dk / dv equal to the plain backward at 1e-5;
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


# ---- a model of K5 / K6's float32 head_dim-128 body ---------------------------

QUAD = 4


def owned_columns(g: int, d: int):
    """The columns thread ``g`` of a quad owns: float4 chunks g + 4 e."""
    return [4 * c + x for e in range(d // (4 * QUAD))
            for c in (g + QUAD * e,) for x in range(4)]


def quad_sum(parts):
    """The kernel's two xor shuffles over the quad's partials (float32):
    each thread's result, in the order the kernel adds."""
    one = [np.float32(parts[g] + parts[g ^ 1]) for g in range(QUAD)]
    return [np.float32(one[g] + one[g ^ 2]) for g in range(QUAD)]


@pytest.mark.parametrize("d", [16, 64, 128])
def test_quad_owns_each_column_once(d):
    owned = [owned_columns(g, d) for g in range(QUAD)]
    flat = sorted(c for cols in owned for c in cols)
    assert flat == list(range(d))                 # each column exactly once
    assert all(len(cols) == d // QUAD for cols in owned)
    # at step e the quad reads 16 contiguous floats (one broadcast read)
    for e in range(d // 16):
        assert sorted(owned[g][4 * e + x] for g in range(QUAD)
                      for x in range(4)) == list(range(16 * e, 16 * e + 16))


def test_quad_sum_covers_every_column_with_one_result():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, D)).astype(np.float32)
    parts = [np.float32(np.dot(a[owned_columns(g, D)], b[owned_columns(g, D)]))
             for g in range(QUAD)]
    sums = quad_sum(parts)
    assert len({s.tobytes() for s in sums}) == 1   # the same bits x 4
    np.testing.assert_allclose(sums[0], np.dot(a.astype(np.float64), b),
                               rtol=1e-5)
    # a column left out changes the sum: every column is in it
    for col in (0, 77, D - 1):
        c = b.copy()
        c[col] += 1.0
        part2 = [np.float32(np.dot(a[owned_columns(g, D)],
                                   c[owned_columns(g, D)]))
                 for g in range(QUAD)]
        assert quad_sum(part2)[0] != sums[0]


def _split_backward(q, k, v, do, lse, delta, causal, scale):
    """K5 and K6's float32 head_dim-128 walk in numpy: per (query, key)
    pair, each quad thread's partial over its own columns, the quad sum,
    p and dS, then each thread's update of its own columns; K6 sums the
    GQA group's q heads into the KV head's dk / dv."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g_ = hq // hkv
    off = skv - sq
    cols = [owned_columns(g, d) for g in range(QUAD)]
    dq = np.zeros_like(q)
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for bi in range(b):
        for h in range(hq):
            hk = h // g_
            for i in range(sq):
                for j in range(skv):
                    if causal and j > i + off:
                        continue
                    s = quad_sum([np.dot(q[bi, i, h, c], k[bi, j, hk, c])
                                  for c in cols])[0]
                    dp = quad_sum([np.dot(do[bi, i, h, c], v[bi, j, hk, c])
                                   for c in cols])[0]
                    p = np.float32(np.exp(np.float32(s * scale
                                                      - lse[bi, h, i])))
                    ds = np.float32(p * (dp - delta[bi, h, i]) * scale)
                    for c in cols:
                        dq[bi, i, h, c] += ds * k[bi, j, hk, c]
                        dv[bi, j, hk, c] += p * do[bi, i, h, c]
                        dk[bi, j, hk, c] += ds * q[bi, i, h, c]
    return dq, dk, dv


@pytest.mark.parametrize("causal,sq,skv", [(True, 7, 5), (False, 3, 6)])
def test_split_walk_equals_plain_backward(causal, sq, skv):
    """Causal GQA with dead rows (Sq > Skv) and a non-causal cross shape."""
    rng = np.random.default_rng(1)
    b, hq, hkv = 1, 4, 2
    q, do = (rng.normal(size=(b, sq, hq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, skv, hkv, D)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attention_reference(tq, tk, tv, causal=causal)
    delta = (tdo * out).sum(-1).transpose(1, 2)
    got = _split_backward(q, k, v, do, lse.numpy(), delta.numpy(), causal,
                          D ** -0.5)
    want = flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                         causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w.numpy(), **TOL, err_msg=name)
    if causal:
        assert not got[0][:, :sq - skv].any()      # dead rows: zero dq


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
