"""bf16 at every head_dim D <= 128 with D % 8 == 0 in the K1 family and
K2-paged(-int8), and a Llama at TinyLlama's head_dim 64 with 8 query heads
a KV head, on the CPU.

  * the tables: every bf16 forward build of K1 (contiguous, paged, int8,
    paged int8), K2 (contiguous, paged, paged int8) and the backward K5 /
    K6 take one set, ``BF16_HEAD_DIMS`` (D <= 256); a bf16 D outside
    the set and float16 are refused by the wrappers' checks,
    naming ROADMAP B2 (head_dim 256 itself: ``test_torch_head_dim_256.py``);
  * a narrow float32 Llama at D 64, G 8 (2 layers, hidden 512, 8 query
    heads over 1 KV head): the port's contiguous, paged, int8-KV paged and
    int8-KV contiguous engines token-identical to the JAX package's
    engines of the same kind (int8 against JAX's int8, never against
    float argmax: ROADMAP C);
  * the same Llama in bf16: a prefill and two decode steps of the port's
    ``decode_step`` against JAX's, each within a bound on the logits'
    distance set by bf16 rounding (the two libraries round different
    intermediates).

The kernels themselves run only on the card (``chip_smoke.py`` phase 2's
``/bf16_d64`` rows and ``serving_tinyllama``); here the wrappers are
reached only through their argument checks, which run before any launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.models.generation import init_kv_cache as jax_init_cache
from paddle_tpu.serving import ServingEngine as JaxEngine

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     init_kv_cache, load_jax_state_dict)
from paddle_tpu_torch.ops import _dispatch
from paddle_tpu_torch.ops.cuda import BF16_HEAD_DIMS, check_attention_args
from paddle_tpu_torch.ops.cuda import decode_attention as k1
from paddle_tpu_torch.ops.cuda import flash_attention as k2
from paddle_tpu_torch.ops.cuda import flash_attention_bwd as k56
from paddle_tpu_torch.serving import ServingEngine

D = 64
NARROW = dict(hidden_size=512, num_attention_heads=8, num_key_value_heads=1,
              intermediate_size=256, num_hidden_layers=2)


# ---- the tables ---------------------------------------------------------------

def test_every_bf16_build_takes_one_set_of_head_dims():
    """The forward builds and the backward K5 / K6 share one set, D <=
    256, at bf16 and at float16."""
    assert BF16_HEAD_DIMS == frozenset(range(8, 257, 8))
    bf16 = torch.bfloat16
    for table in (k1.HEAD_DIM, k2.HEAD_DIM, k2.FWD_HEAD_DIMS,
                  k56.BWD_HEAD_DIMS):
        assert table[bf16] is BF16_HEAD_DIMS
        assert table[torch.float16] is BF16_HEAD_DIMS


class _FakeCuda(torch.Tensor):
    """A CPU tensor that passes the device test: the checks before it are
    the ones under test, and none of them launches anything."""

    @property
    def is_cuda(self):
        return True


def _fake(shape, dtype):
    return torch.zeros(shape, dtype=dtype).as_subclass(_FakeCuda)


@pytest.mark.parametrize("d,ok", [(8, True), (64, True), (72, True),
                                  (120, True), (128, True), (12, False),
                                  (136, True), (256, True), (264, False)])
@pytest.mark.parametrize("int8", [False, True])
def test_check_takes_the_set_and_names_roadmap_b2(d, ok, int8):
    """A bf16 or float16 q at a head dim of the set passes the wrappers'
    checks (K1 and K2-paged share them); another head dim is refused with
    ROADMAP B2 in the message."""
    q = _fake((2, 1, 8, d), torch.bfloat16)
    kv = _fake((2, 16, 1, d), torch.int8 if int8 else torch.bfloat16)
    for table in (k1.HEAD_DIM, k2.HEAD_DIM):
        if ok:
            assert check_attention_args("k", q, kv, kv, table, int8) == 0
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP B2"):
                check_attention_args("k", q, kv, kv, table, int8)
    q16 = _fake((2, 1, 8, d), torch.float16)
    kv16 = kv if int8 else _fake((2, 16, 1, d), torch.float16)
    for table in (k1.HEAD_DIM, k2.HEAD_DIM):
        if ok:
            assert check_attention_args("k", q16, kv16, kv16, table,
                                        int8) == 2
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP B2"):
                check_attention_args("k", q16, kv16, kv16, table, int8)


# ---- a narrow Llama at head_dim 64, 8 query heads a KV head -------------------

def _state(model):
    return {k: np.asarray(v)
            for k, v in model.state_dict(include_buffers=True).items()}


def _pair(dtype):
    pt.seed(67)
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


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_head_dim_64_engine_token_identical_to_jax(llama, engine):
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


# bf16 logits: the port and JAX round different intermediates to bf16
# (the reference keeps some products in float32 where the port rounds,
# and the other way round), so the two sit a few bf16 ulps of the largest
# logit apart; a wrong head_dim, mask or GQA mapping moves them by O(1)
BF16_LOGIT_TOL = 2 ** -5


def test_bf16_decode_step_matches_jax():
    """A 16-token prefill at pos 0 into a 64-position cache, then two
    decode steps at per-row positions, in bf16 at D 64, G 8: each step's
    logits within BF16_LOGIT_TOL of the largest of JAX's."""
    jm, tm = _pair("bfloat16")
    rng = np.random.RandomState(5)
    jc = jax_init_cache(jm.config, 2, MAXLEN)
    tc = init_kv_cache(tm.config, 2, MAXLEN, device="cpu")
    steps = [(rng.randint(0, 256, (2, 16)).astype(np.int32), 0)]
    steps += [(rng.randint(0, 256, (2, 1)).astype(np.int32),
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
