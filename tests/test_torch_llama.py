"""The PyTorch port's Llama against the JAX package's, on the CPU.

One JAX ``tiny_llama_config`` model (float32) is bridged into the port with
``load_jax_state_dict``; the same numpy token ids go through both.  Logits
of ``forward`` and of ``decode_step`` (prefill at ``pos=0`` through the
flash path, then scalar and per-row incremental steps through the cached
path) agree to float32 rounding (1e-5 on O(1) logits: the two libraries
sum in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.models.generation import _nucleus_mask as jax_nucleus
from paddle_tpu.models.generation import init_kv_cache as jax_init_cache
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     init_kv_cache, load_jax_state_dict,
                                     sample_tokens, tiny_llama_config)
from paddle_tpu_torch.models.generation import _nucleus_mask
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-5, atol=1e-5)


def _state(model):
    return {k: np.asarray(v)
            for k, v in model.state_dict(include_buffers=True).items()}


@pytest.fixture(scope="module")
def pair():
    pt.seed(7)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, _state(jm))
    return jm, tm


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def test_config_matches_reference():
    assert dataclasses.asdict(tiny_llama_config()) == {
        f.name: getattr(jax_tiny(), f.name)
        for f in dataclasses.fields(tiny_llama_config())}


def test_forward_logits_match(pair):
    jm, tm = pair
    ids = _ids(2, 13, 0)
    want = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


B, PLEN, MAXLEN = 2, 9, 32


@pytest.fixture(scope="module")
def prefilled(pair):
    """Both models after one prefill (pos 0, s > 1: the flash path)."""
    jm, tm = pair
    ids = _ids(B, PLEN, 1)
    jl, jc = jm.decode_step(jnp.asarray(ids),
                            jax_init_cache(jm.config, B, MAXLEN), 0)
    with torch.no_grad():
        tl, tc = tm.decode_step(
            torch.from_numpy(ids),
            init_kv_cache(tm.config, B, MAXLEN, device="cpu"), 0)
    return jl, jc, tl, tc


def test_prefill_matches(prefilled):
    jl, jc, tl, tc = prefilled
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_matches(per_row, pair, prefilled):
    """Two incremental steps after the prefill — one token, then three —
    with a scalar or a per-row position (the cached path)."""
    jm, tm = pair
    _, jc, _, tc = prefilled
    tc = tc.clone()
    pos = PLEN
    for s, seed in ((1, 2), (3, 3)):
        step = _ids(B, s, seed)
        if per_row:
            jpos = jnp.full((B,), pos, jnp.int32)
            tpos = torch.full((B,), pos, dtype=torch.int32)
        else:
            jpos = tpos = pos
        jl, jc = jm.decode_step(jnp.asarray(step), jc, jpos)
        with torch.no_grad():
            tl, tc = tm.decode_step(torch.from_numpy(step), tc, tpos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos += s
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_decode_step_ragged_rows(pair, prefilled):
    """Rows at different depths in one step (the engine's slot batch)."""
    jm, tm = pair
    _, jc, _, tc = prefilled
    pos = np.asarray([PLEN, 4], np.int32)
    tok = _ids(B, 1, 5)
    jl, _ = jm.decode_step(jnp.asarray(tok), jc, jnp.asarray(pos))
    with torch.no_grad():
        tl, _ = tm.decode_step(torch.from_numpy(tok), tc.clone(),
                               torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_bridge_rejects_mismatches(pair):
    jm, _ = pair
    tm = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    sd = _state(jm)
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_state_dict(tm, dict(sd, extra=np.zeros(1, np.float32)))
    with pytest.raises(KeyError, match="missing"):
        load_jax_state_dict(tm, {k: v for k, v in sd.items()
                                 if k != "lm_head"})
    bad = dict(sd)
    bad["lm_head"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="lm_head"):
        load_jax_state_dict(tm, bad)


def test_bridge_bfloat16_is_exact():
    """ml_dtypes bfloat16 arrays pass through float32 without rounding."""
    pt.seed(3)
    jm = JaxLlama(jax_tiny(dtype="bfloat16", context_parallel="gspmd"))
    sd = _state(jm)
    tm = LlamaForCausalLM(tiny_llama_config(dtype="bfloat16"), device="cpu")
    load_jax_state_dict(tm, sd)
    for name, t in tm.state_dict().items():
        np.testing.assert_array_equal(t.float().numpy(),
                                      sd[name].astype(np.float32))


def test_swiglu_matches():
    rng = np.random.RandomState(6)
    x, y = rng.randn(4, 8).astype(np.float32), rng.randn(4, 8).astype(
        np.float32)
    np.testing.assert_allclose(
        F.swiglu(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(JF.swiglu(jnp.asarray(x), jnp.asarray(y))), **TOL)


def test_nucleus_mask_matches():
    rng = np.random.RandomState(7)
    logits = rng.randn(3, 50).astype(np.float32)
    top_p = np.asarray([[0.3], [0.9], [1.0]], np.float32)
    want = np.asarray(jax_nucleus(jnp.asarray(logits), jnp.asarray(top_p)))
    got = _nucleus_mask(torch.from_numpy(logits),
                        torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)])


def test_sample_tokens_per_row_regime():
    """Greedy rows (temperature <= 0) give the argmax, the first maximal
    index on ties; a top_k = 1 row gives its largest logit; sampled rows
    stay inside their top_k."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [1.0, 3.0, 3.0, 0.0],
                           [1.0, 2.0, 3.0, 0.0], [1.0, 2.0, 3.0, 0.0]])
    temp = torch.tensor([0.0, -1.0, 1.0, 1.0])
    top_k = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    top_p = torch.ones(4)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        out = sample_tokens(logits, temp, top_k, top_p, generator=gen)
        assert out[:3].tolist() == [1, 1, 2]
        assert out[3].item() in (1, 2)
    assert out.dtype == torch.int32
