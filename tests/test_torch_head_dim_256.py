"""bf16 at every head_dim 136-256 in the forward attention builds (the K1
family, K2 contiguous / segmented / paged / paged-int8), and a Llama at
Gemma-2B's widths (head_dim 256, 8 query heads over 1 KV head), on the CPU.

  * the plain versions against the JAX package's Pallas kernels in
    interpret mode at D 256 and 200, float32, 1e-5: cached decode
    attention contiguous, paged, int8 and paged-int8 at s = 1 and s = 5
    with 8 query heads a KV head; flash attention causal GQA, not causal,
    segmented, and Sq != Skv;
  * a narrow float32 Llama at D 256, G 8 (2 layers, hidden 2048, 8 query
    heads over 1 KV head, intermediate 256, vocab 512; weights through
    ``load_jax_state_dict``): the port's contiguous, paged, int8-KV paged
    and int8-KV contiguous engines token-identical to the JAX package's
    engines of the same kind (int8 against JAX's int8, never against float
    argmax: ROADMAP C);
  * the same Llama in bf16: a prefill and two ``decode_step`` calls against
    JAX's, logits within 2^-5 of the largest (the two libraries round
    different intermediates to bf16);
  * the tables, through the wrappers' checks on tensors that pass the
    device test: the K1, K2 and K5 / K6 builds take bf16 D 136-256 (and
    launch at it), D 264 is refused naming ROADMAP B2, and a
    ``flash_attention`` call that needs a gradient at D 256 launches K2,
    then K5 and K6 on ``backward()``;
  * the same narrow Llama's train step (``build_train_step``, 4 steps of 4
    rows x 16 tokens, plain and packed, with ``chip_smoke.py``'s training
    AdamW) against the JAX package's: losses rtol 1e-5, parameters rtol
    1e-5 + atol 5e-5 (as ``test_torch_train.py``).

The kernels themselves run only on the card (``chip_smoke.py`` phase 2's
``/bf16_d256`` rows, ``serving_d256`` and ``training_d256``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.models.generation import init_kv_cache as jax_init_cache
from paddle_tpu.ops.pallas.decode_attention import decode_attention_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention_pallas
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     init_kv_cache, load_jax_state_dict)
from paddle_tpu_torch.ops import (_dispatch, cached_decode_attention,
                                  flash_attention)
from paddle_tpu_torch.ops import cuda as pt_cuda
from paddle_tpu_torch.ops.cuda import check_attention_args
from paddle_tpu_torch.ops.cuda import decode_attention as k1
from paddle_tpu_torch.ops.cuda import flash_attention as k2
from paddle_tpu_torch.ops.cuda import flash_attention_bwd as k56
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr
from paddle_tpu_torch.serving import ServingEngine

# float32 on both sides: the libraries sum in other orders
TOL = dict(rtol=1e-5, atol=1e-5)
WIDE = (136, 200, 256)


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


# ---- the plain versions against the Pallas kernels (interpret mode) ----------

@pytest.mark.parametrize("d", [200, 256])
@pytest.mark.parametrize("s,pos", [(1, [0, 255, 130]), (5, [3, 250, 128])])
@pytest.mark.parametrize("layout", ["contiguous", "paged", "int8",
                                    "paged_int8"])
def test_decode_plain_matches_pallas(layout, s, pos, d):
    """K1's plain version (each layout, G 8) against
    ``decode_attention_pallas(..., interpret=True)``: 256 positions, the
    paged pool in 128-token blocks, the int8 cache in 128-token scale
    granules (contiguous) or per-block scales (paged)."""
    b, hq, hkv, L, bl = 3, 8, 1, 256, 128
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


@pytest.mark.parametrize("d", [200, 256])
@pytest.mark.parametrize("sq,skv,causal,segments", [
    (256, 256, True, False),      # causal GQA
    (256, 256, False, False),     # not causal
    (256, 256, True, True),       # packed documents
    (128, 256, True, False)])     # Sq != Skv, bottom-right causal
def test_flash_plain_matches_pallas(sq, skv, causal, segments, d):
    """K2's plain version (8 query heads over 2 KV heads) against
    ``flash_attention_pallas(..., interpret=True)``: out and lse."""
    hq, hkv = 8, 2
    q, k, v = (_rand((1, sq, hq, d), 6), _rand((1, skv, hkv, d), 7),
               _rand((1, skv, hkv, d), 8))
    seg = (np.repeat(np.arange(3, dtype=np.int32), [100, 60, 96])[None]
           if segments else None)
    jout, jlse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, segment_ids=None if seg is None else jnp.asarray(seg))
    out, lse = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               return_lse=True,
                               segment_ids=None if seg is None else _t(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


# ---- the tables ----------------------------------------------------------------

class _FakeCuda(torch.Tensor):
    """A CPU tensor that passes the device test: the checks before it are
    the ones under test, and none of them launches anything."""

    @property
    def is_cuda(self):
        return True


def _fake(shape, dtype):
    return torch.zeros(shape, dtype=dtype).as_subclass(_FakeCuda)


@pytest.mark.parametrize("d,ok", [(136, True), (200, True), (248, True),
                                  (256, True), (264, False), (252, False)])
@pytest.mark.parametrize("int8", [False, True])
def test_forward_builds_take_136_to_256(d, ok, int8):
    """Every forward build's check takes bf16 D 136-256 (D % 8 == 0); past
    256, or off the multiples of 8, it refuses naming ROADMAP B2."""
    q = _fake((2, 1, 8, d), torch.bfloat16)
    kv = _fake((2, 16, 1, d), torch.int8 if int8 else torch.bfloat16)
    tables = [k1.HEAD_DIM, k2.HEAD_DIM] + ([] if int8 else
                                           [k2.FWD_HEAD_DIMS])
    for table in tables:
        if ok:
            assert check_attention_args("k", q, kv, kv, table, int8) == 0
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP B2"):
                check_attention_args("k", q, kv, kv, table, int8)


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
    """The wrappers on CPU tensors: the device test passes, the dispatch
    routes to the kernels, and a launch reaches a fake library."""
    lib = _FakeLib()
    monkeypatch.setattr(pt_cuda, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(k56, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(_dispatch, "use_kernel", lambda x: True)
    for mod in (k1, k2, k56):
        monkeypatch.setattr(mod, "_lib", lambda *dtype: lib)
        monkeypatch.setattr(mod, "stream_ptr", lambda device: 0)
    return lib


def _qkv(d, hq=8, hkv=1, s=8, grad=False):
    return tuple(torch.zeros(1, s, h, d, dtype=torch.bfloat16,
                             requires_grad=grad) for h in (hq, hkv, hkv))


@pytest.mark.parametrize("d", WIDE)
def test_k1_and_k2_launch_at_wide_head_dims(no_card, d):
    """K1 (s = 1 over a 64-position cache) and K2 forward launch at D
    136-256 with D passed through; the paged K2 too."""
    q, k, v = _qkv(d, s=1)
    cache = torch.zeros(1, 64, 1, d, dtype=torch.bfloat16)
    k1.decode_attention_cuda(q, cache, cache, 3)
    q, k, v = _qkv(d)
    k2.flash_attention_fwd_cuda(q, k, v, causal=True)
    pool = torch.zeros(2, 64, 1, d, dtype=torch.bfloat16)
    k2.flash_attention_fwd_paged_cuda(q, pool, pool, 0,
                                      torch.zeros(1, 2, dtype=torch.int32))
    (n1, a1), (n2, a2), (n3, a3) = no_card.calls
    assert (n1, n2, n3) == ("decode_attention", "flash_attention_fwd",
                            "flash_attention_fwd_paged")
    # D: after 8 pointers and B S Hq Hkv (K1); 9 pointers, B Sq Skv Hq Hkv
    # (K2); 6 pointers, B S Hq Hkv (K2-paged)
    assert (a1[12], a2[14], a3[10]) == (d, d, d)


@pytest.mark.parametrize("d", WIDE)
def test_k5_k6_launch_at_wide_head_dims(no_card, d):
    """K5 and K6 take bf16 D 136-256 and launch with D passed through,
    bf16's dtype code beside it."""
    q, k, v = _qkv(d)
    lse = torch.zeros(1, 8, 8)
    k56.flash_attention_bwd_dq_cuda(q, k, v, q, lse, lse, causal=True)
    k56.flash_attention_bwd_dkv_cuda(q, k, v, q, lse, lse, causal=True)
    (n5, a5), (n6, a6) = no_card.calls
    assert (n5, n6) == ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    # D after 11 pointers and B Sq Skv Hq Hkv (K5), 12 pointers (K6); the
    # dtype code after scale and causal
    assert (a5[16], a6[17]) == (d, d)
    assert (a5[19], a6[20]) == (0, 0)


def test_k5_k6_past_256_name_b2(no_card):
    q, k, v = _qkv(264)
    lse = torch.zeros(1, 8, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP B2") as e:
        k56.flash_attention_bwd_dq_cuda(q, k, v, q, lse, lse)
    assert "B2.3b" not in str(e.value)
    assert no_card.calls == []


def test_gradient_at_256_launches_k2_then_k5_k6(no_card):
    """``flash_attention`` on tensors that need a gradient at D 256
    launches K2 forward, and K5 then K6 on ``backward()``, each at D
    256."""
    q, k, v = _qkv(256, grad=True)
    out = flash_attention(q, k, v, causal=True)
    assert [n for n, _ in no_card.calls] == ["flash_attention_fwd"]
    out.float().sum().backward()
    names = [n for n, _ in no_card.calls]
    assert names == ["flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"]
    args = [a for _, a in no_card.calls]
    assert (args[0][14], args[1][16], args[2][17]) == (256, 256, 256)
    assert all(t.grad is not None and t.grad.shape == t.shape
               for t in (q, k, v))


# ---- a narrow Llama at head_dim 256, 8 query heads a KV head -------------------

D = 256
VOCAB = 512
NARROW = dict(hidden_size=2048, num_attention_heads=8, num_key_value_heads=1,
              intermediate_size=256, num_hidden_layers=2, vocab_size=VOCAB)


def _state(model):
    return {k: np.asarray(v)
            for k, v in model.state_dict(include_buffers=True).items()}


def _pair(dtype):
    pt.seed(71)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd", dtype=dtype, **NARROW))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, _state(jm))
    c = tm.config
    assert c.head_dim == D and c.num_attention_heads == 8 * \
        c.num_key_value_heads and c.dtype == dtype
    return jm, tm


@pytest.fixture(scope="module")
def llama():
    return _pair("float32")


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, n).astype(np.int32)


_SYS = _prompt(17, 500)
PROMPTS = ([_prompt(n, 510 + n) for n in (5, 12, 3, 20)]
           + [np.concatenate([_SYS, _prompt(4, 501)]),
              np.concatenate([_SYS, _prompt(6, 502)])])
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


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_head_dim_256_engine_token_identical_to_jax(llama, engine):
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


# bf16 logits: the port and JAX round different intermediates to bf16, so
# the two sit a few bf16 ulps of the largest logit apart; a wrong head_dim,
# mask or GQA mapping moves them by O(1)
BF16_LOGIT_TOL = 2 ** -5


def test_bf16_decode_step_matches_jax():
    """A 16-token prefill at pos 0 into a 64-position cache, then two
    decode steps at per-row positions, in bf16 at D 256, G 8: each step's
    logits within BF16_LOGIT_TOL of the largest of JAX's."""
    jm, tm = _pair("bfloat16")
    rng = np.random.RandomState(9)
    jc = jax_init_cache(jm.config, 2, MAXLEN)
    tc = init_kv_cache(tm.config, 2, MAXLEN, device="cpu")
    steps = [(rng.randint(0, VOCAB, (2, 16)).astype(np.int32), 0)]
    steps += [(rng.randint(0, VOCAB, (2, 1)).astype(np.int32),
               np.asarray([16 + t, 16 + t], np.int32)) for t in range(2)]
    for i, (ids, pos) in enumerate(steps):
        jpos = pos if isinstance(pos, int) else jnp.asarray(pos)
        tpos = pos if isinstance(pos, int) else torch.from_numpy(pos)
        jl, jc = jm.decode_step(jnp.asarray(ids), jc, jpos)
        with torch.no_grad():
            tl, tc = tm.decode_step(torch.from_numpy(ids), tc, tpos)
        want = np.asarray(jl, np.float32)
        got = tl.float().numpy()
        assert np.isfinite(got).all()
        err = np.abs(got - want).max()
        assert err <= BF16_LOGIT_TOL * np.abs(want).max(), (i, err)


# ---- the train step at head_dim 256, G 8 ---------------------------------------

TRAIN_STEPS, TRAIN_ROWS, TRAIN_SEQ = 4, 4, 16
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=5e-5)     # test_torch_train.py's reasons
# the card's training AdamW (chip_smoke.py phase 5, training_d256): lr 3e-4
# after a 2-step warmup, beta2 0.95, epsilon 1e-5, weight decay 0.1, clip
# 1.0.  Its epsilon bounds how far a gradient's float32 sum-order noise
# (~1e-8 at hidden 2048) moves an update: by <= lr * noise / epsilon, far
# under atol; at epsilon 1e-8 an element whose gradient is itself ~1e-8
# takes a step of either sign (Adam's first step is lr * g / (|g| + eps))


def _train_opts():
    return (JaxAdamW(jax_lr.LinearWarmup(3e-4, 2), beta2=0.95, epsilon=1e-5,
                     weight_decay=0.1, grad_clip=JaxClip(1.0)),
            AdamW(lr.LinearWarmup(3e-4, 2), beta2=0.95, epsilon=1e-5,
                  weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0)))


def _train_batches(packed):
    """4 batches of next-token ids; packed: 1-3 documents a row at seeded
    cuts, positions restarting at each."""
    rng = np.random.RandomState(43)
    out = []
    for _ in range(TRAIN_STEPS):
        ids = rng.randint(0, VOCAB, (TRAIN_ROWS, TRAIN_SEQ + 1)).astype(
            np.int32)
        b = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
        if packed:
            seg = np.zeros((TRAIN_ROWS, TRAIN_SEQ), np.int32)
            pos = np.zeros((TRAIN_ROWS, TRAIN_SEQ), np.int32)
            for r in range(TRAIN_ROWS):
                cuts = sorted(rng.choice(np.arange(2, TRAIN_SEQ - 1),
                                         rng.randint(0, 3), replace=False))
                for c in cuts:
                    seg[r, c:] += 1
                start = 0
                for c in list(cuts) + [TRAIN_SEQ]:
                    pos[r, start:c] = np.arange(c - start)
                    start = c
            b.update(segment_ids=seg, position_ids=pos)
        out.append(b)
    return out


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_head_dim_256_train_step_matches_jax(packed):
    """Four steps of the port's ``build_train_step`` on the narrow Llama at
    D 256, G 8 (float32) against JAX's from the same weights, batches and
    optimizer: losses and final parameters."""
    batches = _train_batches(packed)
    jopt, topt = _train_opts()
    hcg = jdist.HybridCommunicateGroup(devices=jax.devices()[:1])
    jdist.set_hybrid_group(hcg)
    try:
        pt.seed(73)
        jm = JaxLlama(jax_tiny(**NARROW))
        init = _state(jm)
        step, params, opt_state = jdist.build_train_step(jm, jopt, hcg=hcg)
        want = []
        key = jax.random.key(0)
        for i, b in enumerate(batches):
            batch = jdist.shard_batch(
                {k: jnp.asarray(a) for k, a in b.items()}, hcg)
            loss, params, opt_state = step(params, opt_state, batch,
                                           jax.random.fold_in(key, i))
            want.append(float(loss))
        jp = jax.tree.map(np.asarray, params)
    finally:
        jdist.set_hybrid_group(None)
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, init)
    assert tm.config.head_dim == D and tm.config.num_key_value_heads == 1
    tstep = build_train_step(tm, topt)
    got = [float(tstep({k: torch.from_numpy(a) for k, a in b.items()}))
           for b in batches]
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    tp = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], **PARAM_TOL, err_msg=k)
