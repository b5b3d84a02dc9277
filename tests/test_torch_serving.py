"""The PyTorch port's ServingEngine against the JAX package's, on the CPU.

One JAX ``tiny_llama_config`` model (float32) is bridged into the port; the
same prompts go through the JAX ``ServingEngine`` and the port's, greedy.
Outputs must be TOKEN-IDENTICAL: argmax ties break to the first maximal
index in both libraries, and float32 logits agree to ~1e-6.  Fewer slots
than requests, so slots recycle — including a short prompt landing in a
slot a longer one used (the port writes only the new prompt's bucket; the
stale tail must never be read).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch import flags
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

MAXLEN = 64
LENGTHS = (30, 5, 9, 17, 3, 12)       # long first: later tenants are shorter


@pytest.fixture(scope="module")
def pair():
    pt.seed(11)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    return jm, tm


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).astype(np.int32) for n in LENGTHS]


def _serve(engine, prompts, n_new):
    rids = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    out = dict(engine.drain())
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def jax_outputs(pair):
    jm, _ = pair
    eng = JaxEngine(jm, num_slots=2, max_length=MAXLEN)
    return _serve(eng, _prompts(), 8)


def test_greedy_token_identical_to_jax(pair, jax_outputs):
    _, tm = pair
    eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, device="cpu")
    got = _serve(eng, _prompts(), 8)
    assert got == jax_outputs
    m = eng.metrics()
    assert m["tokens_generated"] == 8 * len(LENGTHS)
    assert m["requests_finished"] == len(LENGTHS)
    assert m["prefill_waves"] >= 3 and m["ttft_ms"]["count"] == len(LENGTHS)


def test_eos_token_identical_to_jax(pair, jax_outputs):
    """EOS picked from the plain run's first request, mid-stream: both
    engines retire it early, identically."""
    jm, tm = pair
    first = jax_outputs[0]
    cut = next(j for j in range(1, 8) if first.index(first[j]) == j)
    eos = first[cut]
    want = _serve(JaxEngine(jm, num_slots=2, max_length=MAXLEN,
                            eos_token_id=eos), _prompts(), 8)
    got = _serve(ServingEngine(tm, num_slots=2, max_length=MAXLEN,
                               eos_token_id=eos, device="cpu"),
                 _prompts(), 8)
    assert got == want
    assert got[0] == first[:cut + 1]


def test_one_slot_reuse_after_longer_prompt(pair, jax_outputs):
    """Every request through ONE slot: each new tenant's prefill leaves the
    previous tenant's longer K/V tail in the row."""
    _, tm = pair
    eng = ServingEngine(tm, num_slots=1, max_length=MAXLEN, device="cpu")
    assert _serve(eng, _prompts(), 8) == jax_outputs


def test_rejections(pair):
    _, tm = pair
    eng = ServingEngine(tm, num_slots=2, max_length=MAXLEN, device="cpu")
    with pytest.raises(ValueError, match="exceeds the engine's max_length"):
        eng.submit(np.zeros(60, np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="at least one token"):
        eng.submit([], max_new_tokens=4)
    with pytest.raises(ValueError, match="max_new_tokens must be >= 1"):
        eng.submit([1, 2], max_new_tokens=0)
    assert eng.metrics()["requests_submitted"] == 0


@pytest.mark.parametrize("kw,item", [
    ({"paged": True}, "A6.1"), ({"chunked": True}, "A6.2"),
    ({"spec_decode": True}, "A6.3"), ({"kv_cache_dtype": "int8"}, "A6.4"),
    ({"int8_weights": True}, "A6.5"), ({"preempt": "swap"}, "A6.6"),
    ({"mesh": "mp2dp2"}, "A9")])
def test_unported_modes_raise(pair, kw, item):
    _, tm = pair
    with pytest.raises(NotImplementedError, match=item):
        ServingEngine(tm, num_slots=2, max_length=MAXLEN, device="cpu", **kw)


def test_unported_flag_raises(pair):
    _, tm = pair
    flags.set_flags({"serving_paged_kv": True})
    try:
        with pytest.raises(NotImplementedError, match="A6.1"):
            ServingEngine(tm, max_length=MAXLEN, device="cpu")
    finally:
        flags.set_flags({"serving_paged_kv": False})


def test_engine_device_rules(pair, monkeypatch):
    _, tm = pair
    with pytest.raises(ValueError, match="meta"):
        ServingEngine(tm, max_length=MAXLEN, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tm, max_length=MAXLEN)


def test_sampled_requests_are_seeded(pair):
    """Sampled rows draw from the engine's seeded generator: one seed, one
    output; greedy rows in the same batch keep their greedy tokens."""
    _, tm = pair
    prompts = _prompts(1)[:3]
    hot = SamplingParams(temperature=1.0, top_k=20, top_p=0.9)

    def run(seed):
        eng = ServingEngine(tm, num_slots=3, max_length=MAXLEN, seed=seed,
                            device="cpu")
        rids = [eng.submit(prompts[0], 6, sampling=hot),
                eng.submit(prompts[1], 6),
                eng.submit(prompts[2], 6, sampling=hot)]
        out = dict(eng.drain())
        return [out[r] for r in rids]

    a, b = run(5), run(5)
    assert a == b and all(len(x) == 6 for x in a)
    greedy = ServingEngine(tm, num_slots=1, max_length=MAXLEN, device="cpu")
    assert a[1] == _serve(greedy, [prompts[1]], 6)[0]
