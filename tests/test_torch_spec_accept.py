"""The port's speculative acceptance (``paddle_tpu_torch/models/
generation.py``: ``_target_probs``, ``accept_draft_tokens``) against the
JAX package's, on the CPU.

* ``_target_probs``: the same logits and knobs through both, rtol 1e-5
  (float32 softmax; the masks are exact).
* Greedy rows: tokens and ``n_accepted`` identical to JAX's on the same
  logits, drafts and masks, with and without ``draft_probs``.
* Sampled rows draw from the port's ``torch.Generator`` (JAX's ``fold_in``
  streams cannot be reproduced), so they are held by distribution: the
  four chi-square cases of ``tests/test_spec_rejection.py`` (k = 1, k = 4,
  the all-rejected resample branch, the zero-q pad column) on the port,
  at that file's threshold (chi-square 18.48: df 7, alpha 0.01), seeded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import accept_draft_tokens as jax_accept
from paddle_tpu.models.generation import _target_probs as jax_target_probs

from paddle_tpu_torch.models import accept_draft_tokens
from paddle_tpu_torch.models.generation import _target_probs

V = 8
CHI2_CRIT = 18.48


def _knobs(b, seed):
    rs = np.random.RandomState(seed)
    temps = rs.uniform(0.3, 1.5, b).astype(np.float32)
    temps[::3] = 0.0
    topk = rs.randint(0, 6, b).astype(np.int32)
    topp = rs.uniform(0.5, 1.0, b).astype(np.float32)
    topp[1::4] = 1.0
    return temps, topk, topp


@pytest.mark.parametrize("vocab", [V, 64])
def test_target_probs_matches_jax(vocab):
    b, s = 7, 5
    rs = np.random.RandomState(3)
    logits = rs.uniform(-3, 3, (b, s, vocab)).astype(np.float32)
    temps, topk, topp = _knobs(b, 4)
    want = np.asarray(jax_target_probs(jnp.asarray(logits), temps, topk,
                                       topp))
    got = _target_probs(torch.from_numpy(logits), temps, topk, topp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # scalar knobs broadcast the same way
    want = np.asarray(jax_target_probs(jnp.asarray(logits), 0.7))
    got = _target_probs(torch.from_numpy(logits), 0.7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("with_q", [False, True], ids=["legacy", "q"])
def test_greedy_accept_identical_to_jax(with_q):
    """Greedy rows: the prefix-match rule, the same tokens and counts as
    JAX; some draft columns match the argmax, some are masked pad."""
    b, s = 12, 5
    rs = np.random.RandomState(31)
    logits = rs.uniform(-2, 2, (b, s, V)).astype(np.float32)
    arg = logits.argmax(-1)
    drafts = rs.randint(0, V, (b, s - 1)).astype(np.int32)
    # plant verified prefixes of every length
    for i in range(b):
        m = i % s
        drafts[i, :m] = arg[i, :m]
    mask = rs.rand(b, s - 1) < 0.85
    q = rs.dirichlet(np.ones(V), (b, s - 1)).astype(np.float32)
    temps = np.zeros((b,), np.float32)
    kw = dict(draft_probs=q) if with_q else {}
    t_j, n_j = jax_accept(jnp.asarray(logits), jnp.asarray(drafts),
                          jnp.asarray(mask), jax.random.PRNGKey(0),
                          temperature=jnp.asarray(temps), pad_token_id=3,
                          **kw)
    kw = dict(draft_probs=torch.from_numpy(q)) if with_q else {}
    t_p, n_p = accept_draft_tokens(torch.from_numpy(logits),
                                   torch.from_numpy(drafts),
                                   torch.from_numpy(mask),
                                   torch.Generator().manual_seed(0),
                                   temperature=temps, pad_token_id=3, **kw)
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    assert len(np.unique(n_p.numpy())) > 2
    # the caller's argmax gives the same result
    t_g, n_g = accept_draft_tokens(torch.from_numpy(logits),
                                   torch.from_numpy(drafts),
                                   torch.from_numpy(mask), pad_token_id=3,
                                   greedy=torch.from_numpy(arg))
    np.testing.assert_array_equal(t_g.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(n_g.numpy(), np.asarray(n_j))


def test_sampled_rows_without_q_accept_column_zero():
    """``draft_probs=None``: a sampled row commits its column-0 sample
    only, even where every draft matches; greedy rows keep the rule."""
    b, s = 6, 4
    rs = np.random.RandomState(5)
    logits = torch.from_numpy(rs.uniform(-2, 2, (b, s, V)).astype(
        np.float32))
    drafts = logits.argmax(-1)[:, :-1].to(torch.int32)
    mask = torch.ones((b, s - 1), dtype=torch.bool)
    temps = np.array([0, 1, 0, 1, 0, 1], np.float32)
    t, n = accept_draft_tokens(logits, drafts, mask,
                               torch.Generator().manual_seed(1),
                               temperature=temps)
    n = n.numpy()
    assert (n[temps > 0] == 1).all() and (n[temps == 0] == s).all()
    assert (t.numpy()[temps > 0, 1:] == 0).all()


def _chi2(counts, p):
    exp = p * counts.sum()
    return float(((counts - exp) ** 2 / np.maximum(exp, 1e-9)).sum())


def _logit_table(s, seed=0):
    return np.random.RandomState(seed).uniform(-2.0, 2.0, (s, V)).astype(
        np.float32)


def _first_token_counts(tbl, q, drafts=None, n_rows=4096, seed=0):
    """The first committed token's histogram over ``n_rows`` rows of one
    call (the reference test's ``_first_token_counts``, on the port's
    generator): drafts drawn from q unless given."""
    s = tbl.shape[0]
    q = np.asarray(q, np.float32).reshape(s - 1, V)
    if drafts is None:
        qn = q.astype(np.float64)
        qn /= qn.sum(-1, keepdims=True)
        rs = np.random.RandomState(seed ^ 0xd12a)
        db = np.stack([rs.choice(V, size=n_rows, p=qn[j])
                       for j in range(s - 1)], axis=1).astype(np.int32)
    else:
        db = np.broadcast_to(np.asarray(drafts, np.int32).reshape(1, s - 1),
                             (n_rows, s - 1)).copy()
    logits = torch.from_numpy(np.broadcast_to(tbl[None], (n_rows, s, V))
                              .copy())
    qb = torch.from_numpy(np.broadcast_to(q[None], (n_rows, s - 1, V))
                          .copy())
    mask = qb.sum(-1) > 0
    toks, n = accept_draft_tokens(
        logits, torch.from_numpy(db), mask,
        torch.Generator().manual_seed(seed),
        temperature=np.ones((n_rows,), np.float32), draft_probs=qb)
    first = toks[:, 0].numpy()
    return np.bincount(first, minlength=V).astype(np.float64), n.numpy()


def _p0(tbl):
    return _target_probs(torch.from_numpy(tbl[None, :1]), 1.0).numpy()[0, 0]


def test_chi_square_k1_matches_target():
    tbl = _logit_table(2, seed=3)
    q = np.random.RandomState(7).dirichlet(np.ones(V), size=1)
    counts, _ = _first_token_counts(tbl, q, seed=11)
    assert _chi2(counts, _p0(tbl)) < CHI2_CRIT


def test_chi_square_k4_matches_target():
    tbl = _logit_table(5, seed=5)
    q = np.random.RandomState(13).dirichlet(np.ones(V), size=4)
    counts, n = _first_token_counts(tbl, q, seed=17)
    assert _chi2(counts, _p0(tbl)) < CHI2_CRIT
    assert len(np.unique(n)) > 1


def test_chi_square_all_rejected_resample_branch():
    tbl = _logit_table(2, seed=9)
    p = _p0(tbl)
    worst = int(np.argmin(p))
    q = np.zeros((1, V), np.float32)
    q[0, worst] = 1.0
    counts, n = _first_token_counts(tbl, q, [[worst]], seed=23)
    assert _chi2(counts, p) < CHI2_CRIT
    assert float((n == 1).mean()) > 0.5


def test_pad_column_all_zero_q_is_plain_sample():
    tbl = _logit_table(2, seed=15)
    p = _p0(tbl)
    q = np.zeros((1, V), np.float32)
    counts, n = _first_token_counts(tbl, q, [[int(np.argmax(p))]], seed=29)
    assert _chi2(counts, p) < CHI2_CRIT
    assert int(n.max()) == 1
