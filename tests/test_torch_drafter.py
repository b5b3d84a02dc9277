"""The port's drafters (``paddle_tpu_torch/serving/drafter.py``) and
``draft_model_from`` against the JAX package's, on the CPU.

* ``NgramDrafter``: proposals identical to JAX's on seeded histories
  (exact: both are integer numpy).
* ``DraftModelDrafter``: one tiny float32 JAX model bridged into the port;
  over several ticks of growing histories — a long first backlog drains
  through the ingest step, later windows carry 1 .. k + 1 new tokens, one
  slot idle — the greedy drafts are identical to JAX's and q agrees to
  atol 1e-5 (float32 sum order), for self-drafting and a 1-layer
  ``draft_model_from`` draft; each step is built once (``draft_traces``
  1, ``ingest_traces`` 1).
* ``draft_model_from``: the draft's embedding, blocks, norm and LM head
  share the target's storage (``data_ptr`` equal); ``num_layers`` outside
  ``[1, L]`` raises ``ValueError``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import draft_model_from as jax_draft_model_from
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.serving.drafter import DraftModelDrafter as JaxDMD
from paddle_tpu.serving.drafter import NgramDrafter as JaxNgram

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     draft_model_from, load_jax_state_dict)
from paddle_tpu_torch.serving.drafter import DraftModelDrafter, NgramDrafter

MAXLEN = 64
K = 3
SLOTS = 3


@pytest.fixture(scope="module")
def pair():
    pt.seed(7)
    jm = JaxLlama(jax_tiny(context_parallel="gspmd"))
    jm.eval()
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in
                             jm.state_dict(include_buffers=True).items()})
    return jm, tm


@pytest.mark.parametrize("k,max_ngram", [(1, 1), (4, 3), (6, 2)])
def test_ngram_proposals_identical_to_jax(k, max_ngram):
    rs = np.random.RandomState(k * 10 + max_ngram)
    port, ref = NgramDrafter(k, max_ngram), JaxNgram(k, max_ngram)
    proposed = 0
    for _ in range(200):
        motif = rs.randint(0, 6, rs.randint(1, 5))
        h = np.concatenate([rs.randint(0, 8, rs.randint(0, 6)),
                            np.tile(motif, rs.randint(1, 4)),
                            rs.randint(0, 8, rs.randint(0, 4))])[:40]
        if h.size == 0:
            h = np.array([1], np.int32)
        got, want = port.propose(h), ref.propose(h)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        proposed += got.size > 0
    assert proposed > 50
    with pytest.raises(ValueError):
        NgramDrafter(0)
    with pytest.raises(ValueError):
        NgramDrafter(2, max_ngram=1, min_ngram=2)


def _histories(seed):
    rs = np.random.RandomState(seed)
    # slot 0: a backlog longer than the ingest width; slot 2: short
    return {0: rs.randint(0, 256, 37).astype(np.int32),
            2: rs.randint(0, 256, 4).astype(np.int32)}


@pytest.mark.parametrize("layers", [None, 1], ids=["self", "layers1"])
def test_draft_model_greedy_identical_to_jax(pair, layers):
    jm, tm = pair
    if layers is None:
        jdm, jparams = jm, jm.state_dict(include_buffers=True)
        tdm = tm
    else:
        jdm, jparams = jax_draft_model_from(jm, num_layers=layers)
        tdm = draft_model_from(tm, num_layers=layers)
    ref = JaxDMD(K, jdm, jparams, SLOTS, MAXLEN)
    port = DraftModelDrafter(K, tdm, SLOTS, MAXLEN, device="cpu")
    temps = np.zeros((SLOTS,), np.float32)
    hist = _histories(3)
    rs = np.random.RandomState(4)
    for tick in range(5):
        dj, qj = ref.propose_batch(dict(hist), temps, seed=tick)
        dp, qp = port.propose_batch(dict(hist), temps)
        dp, qp = dp.numpy(), qp.numpy()
        for i in hist:
            np.testing.assert_array_equal(dp[i], dj[i])
            np.testing.assert_allclose(qp[i], qj[i], atol=1e-5, rtol=0)
        # commit 1 .. k + 1 tokens: a verified draft prefix, then a token
        for i in hist:
            take = int(rs.randint(0, K + 1))
            new = list(dp[i, :take]) + [int(rs.randint(0, 256))]
            hist[i] = np.concatenate([hist[i], np.asarray(new, np.int32)])
    assert port.draft_traces == 1 and port.ingest_traces == 1
    port.reset_slot(0)
    assert port._consumed[0] == 0


def test_draft_model_sampled_rows_draw_from_q(pair):
    """A sampled row's drafts come from the untempered draft softmax q
    (Gumbel noise from the caller's generator): over many draws at one
    history the first draft's histogram matches q[0] (chi-square on the
    top tokens), and greedy rows beside it keep the argmax."""
    _, tm = pair
    port = DraftModelDrafter(1, tm, 2, MAXLEN, device="cpu")
    gen = torch.Generator().manual_seed(5)
    h = np.random.RandomState(8).randint(0, 256, 6).astype(np.int32)
    temps = np.array([1.0, 0.0], np.float32)
    counts = np.zeros((tm.config.vocab_size,))
    q0 = None
    for _ in range(400):
        port.reset_slot(0)
        port.reset_slot(1)
        d, q = port.propose_batch({0: h, 1: h}, temps, gen)
        counts[int(d[0, 0])] += 1
        q0 = q[0, 0].numpy().astype(np.float64)
        assert int(d[1, 0]) == int(np.argmax(q[1, 0].numpy()))
    top = np.argsort(-q0)[:8]
    exp = np.append(q0[top], 1 - q0[top].sum()) * counts.sum()
    obs = np.append(counts[top], counts.sum() - counts[top].sum())
    chi2 = float(((obs - exp) ** 2 / np.maximum(exp, 1e-9)).sum())
    assert chi2 < 21.67                      # df 8, alpha 0.01


def test_draft_model_from_aliases_the_target(pair):
    _, tm = pair
    dm = draft_model_from(tm, num_layers=1)
    assert dm.config.num_hidden_layers == 1
    assert len(dm.model.layers) == 1
    src = dict(tm.named_parameters())
    for name, p in dm.named_parameters():
        assert p.data_ptr() == src[name].data_ptr(), name
    assert dm.model.rope_cos.data_ptr() == tm.model.rope_cos.data_ptr()
    n_target = sum(p.numel() for p in tm.parameters())
    assert sum(p.numel() for p in dm.parameters()) < n_target
    L = tm.config.num_hidden_layers
    assert draft_model_from(tm, num_layers=L).config.num_hidden_layers == L
    for bad in (0, L + 1):
        with pytest.raises(ValueError, match="num_layers"):
            draft_model_from(tm, num_layers=bad)
    # the draft's logits are the truncated target's
    ids = torch.tensor([[3, 7, 11, 2]])
    with torch.no_grad():
        x = dm(ids)
        h = tm.model.embed_tokens[ids]
        rope = (tm.model.rope_cos, tm.model.rope_sin)
        h = tm.model.layers[0](h, rope)
        want = tm.logits(tm.model.norm(h))
    torch.testing.assert_close(x, want, rtol=0, atol=0)
