"""The port's whole-sequence generation against the JAX package's, on the
CPU in float32.

One JAX ``tiny_llama_config`` model is carried into the port with
``load_jax_state_dict``; the same numpy prompts go through
``generate`` of both.  Greedy and beam tokens must be identical (JAX's
``lax.top_k`` breaks ties by the lower index, and so does the port's
beam search); sampled tokens come from other PRNG streams, so they are
compared in distribution only (chi-square at alpha 0.01, as
``tests/test_spec_rejection.py`` does).  The reference's own tests of
``tests/test_generation.py`` are ported beside them: greedy equals the
full forward's argmax, EOS padding, the length refusals, one build a key,
beam search against a numpy beam decoder driven by full forwards, the
length penalty, the beam refusal of sampling knobs and the nucleus.
``QuantizedForDecode.generate`` is held against the JAX wrapper's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.models.quantized import \
    quantize_for_decode as jax_quantize_for_decode

from torch_obs_guard import fresh_observability  # noqa: F401
from paddle_tpu_torch.models import (GreedyProgram, LlamaForCausalLM,
                                     config_from, greedy_generate,
                                     load_jax_state_dict,
                                     quantize_for_decode, sample_tokens)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.observability import watchdog
from paddle_tpu_torch.ops import _dispatch
from paddle_tpu_torch.serving import step_graph

# chi-square critical value, df 7, alpha 0.01 (tests/test_spec_rejection.py)
CHI2_DF7 = 18.48


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


# models built by tests that need a program cache of their own, kept alive
# so that no later model reuses their id (a build counter's label)
_KEEP = []


def _fresh(jm):
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, _state(jm))
    _KEEP.append(tm)
    return tm


def _prompt(b, s, vocab=256, seed=3):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _full_logits(tm, ids):
    with torch.no_grad():
        return tm(torch.as_tensor(np.asarray(ids)).long()).numpy()


def _jax_gen(jm, ids, **kw):
    return np.asarray(jm.generate(jnp.asarray(ids), **kw))


# ---- against the JAX package -----------------------------------------------------

@pytest.mark.parametrize("with_eos", [False, True], ids=["no_eos", "eos"])
def test_greedy_tokens_identical_to_jax(pair, with_eos):
    """Greedy ``generate`` token for token; the EOS case takes a token the
    greedy run emits mid-way, so rows really finish early and pad."""
    jm, tm = pair
    ids = _prompt(3, 6, seed=9)
    kw = dict(max_new_tokens=10)
    if with_eos:
        plain = _jax_gen(jm, ids, **kw)
        kw.update(eos_token_id=int(plain[0, 6 + 3]), pad_token_id=0)
    want = _jax_gen(jm, ids, **kw)
    got = tm.generate(ids, **kw).numpy()
    assert got.dtype == np.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got, want)
    if with_eos:
        gen = got[0, 6:]
        first = int(np.nonzero(gen == kw["eos_token_id"])[0][0])
        assert first == 3 and np.all(gen[first + 1:] == 0)


@pytest.mark.parametrize("eos", [None, 5])
def test_beam_tokens_identical_to_jax(pair, eos):
    jm, tm = pair
    ids = _prompt(2, 5, seed=43)
    kw = dict(max_new_tokens=6, num_beams=4, eos_token_id=eos,
              pad_token_id=0)
    np.testing.assert_array_equal(tm.generate(ids, **kw).numpy(),
                                  _jax_gen(jm, ids, **kw))


def test_quantized_generate_identical_to_jax_wrapper(pair):
    """``QuantizedForDecode.generate``: the port's int8 weights (bit-equal
    to the reference's) through ``weight_only_linear``, the reference's
    through its in-graph dequant; greedy tokens identical."""
    jm, tm = pair
    jw = jax_quantize_for_decode(jm, min_elems=2048)
    tw = quantize_for_decode(tm, min_elems=2048)
    assert tw.quantized_names == jw.quantized_names
    ids = _prompt(2, 7, seed=21)
    want = np.asarray(jw.generate(jnp.asarray(ids), max_new_tokens=8))
    _dispatch.reset_kernel_paths()
    got = tw.generate(ids, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    # every projection and the LM head a pass through weight_only_linear
    # (7 a layer + 1; plain on the CPU), the program cached on the wrapper
    layers = tm.config.num_hidden_layers
    assert _dispatch.kernel_paths[("int8_matmul", "plain")] == \
        8 * (7 * layers + 1)
    assert len(vars(tw)["_generate_jit_cache"]) == 1


def test_first_sampled_token_follows_the_target_distribution(pair):
    """temperature 0.8 and top_k 8: the first sampled token of 4000 rows of
    one prompt, port and JAX each against the target distribution (the
    softmax of the top 8 of the JAX full forward's last logits / 0.8),
    chi-square over the 8 tokens (df 7, alpha 0.01)."""
    jm, tm = pair
    n = 4000
    ids = np.repeat(_prompt(1, 4, seed=13), n, axis=0)
    logits = np.asarray(jm(jnp.asarray(ids[:1])))[0, -1].astype(np.float64)
    top = np.argsort(-logits)[:8]
    z = logits[top] / 0.8
    p = np.exp(z - z.max())
    p /= p.sum()
    kw = dict(max_new_tokens=1, temperature=0.8, top_k=8, seed=0)
    for name, toks in (("port", tm.generate(ids, **kw).numpy()[:, 4]),
                       ("jax", _jax_gen(jm, ids, **kw)[:, 4])):
        assert set(toks.tolist()) <= set(top.tolist()), name
        counts = np.array([(toks == t).sum() for t in top])
        chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
        assert chi2 < CHI2_DF7, (name, chi2, counts, n * p)


def test_sample_tokens_static_regime_matches_reference_rules():
    """The static-knob regime: temperature 0 is the argmax; top_k keeps the
    k largest; a tiny top_p keeps the argmax only."""
    g = torch.Generator().manual_seed(0)
    logits = torch.from_numpy(np.random.RandomState(5).normal(
        size=(64, 50)).astype(np.float32))
    assert torch.equal(sample_tokens(logits), logits.argmax(-1).int())
    assert sample_tokens(logits).dtype == torch.int32
    top3 = torch.topk(logits, 3, dim=-1).indices
    got = sample_tokens(logits, 1.0, top_k=3, generator=g)
    assert bool((top3 == got[:, None].long()).any(-1).all())
    got = sample_tokens(logits, 1.0, top_p=1e-9, generator=g)
    assert torch.equal(got, logits.argmax(-1).int())


# ---- the reference's own tests (tests/test_generation.py), ported ----------------

def test_greedy_generate_matches_full_forward_argmax(pair):
    """Every generated token equals the argmax of a full forward over the
    prefix that produced it (reference :66)."""
    _, tm = pair
    ids = _prompt(2, 6, seed=9)
    n_new = 8
    out = tm.generate(ids, max_new_tokens=n_new).numpy()
    assert out.shape == (2, 6 + n_new)
    np.testing.assert_array_equal(out[:, :6], ids)
    for t in range(n_new):
        want = _full_logits(tm, out[:, :6 + t])[:, -1].argmax(-1)
        np.testing.assert_array_equal(out[:, 6 + t], want,
                                      err_msg=f"greedy token {t}")


def test_generate_eos_padding(pair):
    """Rows that emit EOS keep emitting pad afterwards (reference :83)."""
    _, tm = pair
    out = tm.generate(_prompt(3, 4, seed=11), max_new_tokens=12,
                      eos_token_id=5, pad_token_id=0).numpy()
    for row in out:
        gen = row[4:]
        hits = np.where(gen == 5)[0]
        if hits.size:
            after = gen[hits[0] + 1:]
            assert np.all((after == 0) | (after == 5)), gen


def test_generate_length_validation(pair):
    """``max_length`` below the prompt + new tokens and ``max_new_tokens``
    below 1 raise (reference :109)."""
    _, tm = pair
    with pytest.raises(ValueError, match="max_length"):
        tm.generate(_prompt(1, 4), max_new_tokens=8, max_length=6)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tm.generate(_prompt(1, 4), max_new_tokens=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tm.generate(_prompt(1, 4), max_new_tokens=0, num_beams=2)


def test_generate_rejects_past_rope_cache(pair):
    """The tiny config's RoPE table holds 128 positions (reference :170)."""
    _, tm = pair
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.generate(_prompt(1, 120), max_new_tokens=20)


def test_generate_builds_once_per_key(pair):
    """Two calls of one key: one program, built once (the watchdog counts
    1), the same tokens; another key is a second program (reference
    :214)."""
    tm = _fresh(pair[0])
    ids = _prompt(2, 6, seed=41)
    a = tm.generate(ids, max_new_tokens=4)
    (prog,) = tm._generate_jit_cache.values()
    b = tm.generate(ids, max_new_tokens=4)
    assert isinstance(prog, GreedyProgram)
    assert list(tm._generate_jit_cache.values()) == [prog]
    assert prog.traces == 1 and not prog.graphed
    assert watchdog._counts[prog._tracked.key] == 1
    assert torch.equal(a, b)
    tm.generate(ids, max_new_tokens=5)
    assert len(tm._generate_jit_cache) == 2


def test_moved_weights_build_a_new_program(pair):
    """A model whose tensors were given new storage gets a new program
    (the key carries the weights' data pointers) and the old one is
    dropped; the tokens are unchanged."""
    tm = _fresh(pair[0])
    ids = _prompt(2, 6, seed=41)
    before = tm.generate(ids, max_new_tokens=4)
    (old,) = tm._generate_jit_cache.values()
    held = [p.data for p in tm.parameters()]    # no pointer is reused
    for p in tm.parameters():
        p.data = p.data.clone()
    after = tm.generate(ids, max_new_tokens=4)
    (new,) = tm._generate_jit_cache.values()
    assert new is not old and new.traces == 1 and old.traces == 1
    assert torch.equal(before, after)
    del held


def test_cpu_generation_takes_the_plain_routes(pair):
    """On the CPU the prefill (s > 1 at pos 0) goes to flash-attention's
    plain version and every decode step to flash-decode's, once a layer."""
    tm = _fresh(pair[0])
    _dispatch.reset_kernel_paths()
    tm.generate(_prompt(2, 6, seed=3), max_new_tokens=5)
    layers = tm.config.num_hidden_layers
    assert dict(_dispatch.kernel_paths) == {
        ("flash_attention", "plain"): layers,
        ("decode_attention", "plain"): 4 * layers,
        ("rms_norm", "plain"): 5 * (2 * layers + 1)}


def _np_beam_search(full_forward, ids, n_new, k, eos=None, pad=0, lp=1.0):
    """The reference's numpy beam decoder (tests/test_generation.py:310),
    driven by teacher-forced full forwards: summed log-probs, finished
    beams extend with pad at probability 1, GNMT length normalisation."""
    def log_softmax(x):
        x = x.astype(np.float64)
        m = x.max(-1, keepdims=True)
        e = np.exp(x - m)
        return (x - m) - np.log(e.sum(-1, keepdims=True))

    b, s = ids.shape
    outs = []
    for r in range(b):
        prompt = list(ids[r])
        seqs = [list() for _ in range(k)]
        scores = np.full(k, -np.inf)
        scores[0] = 0.0
        done = np.zeros(k, bool)
        lengths = np.zeros(k, np.int64)
        for t in range(n_new):
            cands = []
            for bi in range(k):
                if scores[bi] == -np.inf and t > 0:
                    continue
                if done[bi]:
                    cands.append((scores[bi], bi, pad))
                    continue
                logits = full_forward(
                    np.asarray([prompt + seqs[bi]], np.int32))[0, -1]
                lp_row = log_softmax(logits)
                for tok in range(len(lp_row)):
                    cands.append((scores[bi] + lp_row[tok], bi, tok))
                if t == 0:
                    break  # only beam 0 is live at the first expansion
            cands.sort(key=lambda c: (-c[0], c[1], c[2]))
            top = cands[:k]
            seqs = [seqs[bi] + [tok] for _, bi, tok in top]
            new_done, new_len = [], []
            for score, bi, tok in top:
                d = done[bi]
                new_len.append(lengths[bi] if d else lengths[bi] + 1)
                new_done.append(d or (eos is not None and tok == eos))
            scores = np.asarray([c[0] for c in top])
            done = np.asarray(new_done)
            lengths = np.asarray(new_len)
        norm = scores / (lengths.astype(np.float64) ** lp)
        outs.append(prompt + seqs[int(np.argmax(norm))])
    return np.asarray(outs, np.int32)


@pytest.mark.parametrize("eos", [None, 5])
def test_beam_search_matches_numpy_reference(pair, eos):
    """Reference :404, both EOS settings."""
    _, tm = pair
    ids = _prompt(2, 5, seed=43)
    got = tm.generate(ids, max_new_tokens=6, num_beams=4, eos_token_id=eos,
                      pad_token_id=0).numpy()
    want = _np_beam_search(lambda a: _full_logits(tm, a), ids, 6, 4,
                           eos=eos, pad=0)
    np.testing.assert_array_equal(got, want)


def test_beam_search_length_penalty_changes_choice(pair):
    """length_penalty is live (reference :429): at 2.0 the search equals
    the numpy decoder at 2.0, and the JAX search."""
    jm, tm = pair
    ids = _prompt(2, 4, seed=59)
    kw = dict(max_new_tokens=5, num_beams=3, eos_token_id=5)
    got = tm.generate(ids, length_penalty=2.0, **kw).numpy()
    want = _np_beam_search(lambda a: _full_logits(tm, a), ids, 5, 3, eos=5,
                           lp=2.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _jax_gen(jm, ids, length_penalty=2.0, **kw))


def test_beam_search_rejects_sampling_knobs(pair):
    """Reference :443."""
    _, tm = pair
    for knobs in (dict(temperature=0.8), dict(top_k=4), dict(top_p=0.5)):
        with pytest.raises(ValueError, match="deterministic"):
            tm.generate(_prompt(1, 4), max_new_tokens=4, num_beams=4,
                        **knobs)
    with pytest.raises(ValueError, match="num_beams"):
        tgen.beam_search_generate(tm, _prompt(1, 4), 4, num_beams=1)


def test_top_p_sampling_stays_in_nucleus(pair):
    """Every sampled token lies inside the 0.8-nucleus of the full
    forward's distribution at its position (reference :449)."""
    _, tm = pair
    ids = _prompt(1, 4, seed=61)
    p = 0.8
    out = tm.generate(ids, max_new_tokens=6, temperature=1.0, top_p=p,
                      seed=3).numpy()
    for t in range(6):
        logits = _full_logits(tm, out[:, :4 + t])[0, -1].astype(np.float64)
        e = np.exp(logits - logits.max())
        probs = e / e.sum()
        order = np.argsort(-logits)
        cum = np.cumsum(probs[order])
        keep = order[np.concatenate([[True], cum[:-1] < p])]
        assert out[0, 4 + t] in keep, (t, out[0, 4 + t])


def test_top_p_tiny_p_is_greedy(pair):
    """p -> 0 keeps only the argmax: sampling equals greedy (reference
    :468)."""
    _, tm = pair
    ids = _prompt(2, 4, seed=67)
    greedy = tm.generate(ids, max_new_tokens=5)
    nucl = tm.generate(ids, max_new_tokens=5, temperature=1.0, top_p=1e-9,
                       seed=11)
    assert torch.equal(greedy, nucl)


def test_sampling_seeds_differ_and_repeat(pair):
    """The same seed repeats a sampled generation, another seed differs
    (reference :93, plus the repeat the generator's seed gives)."""
    _, tm = pair
    ids = _prompt(1, 4, seed=13)
    kw = dict(max_new_tokens=6, temperature=0.8, top_k=8)
    a = tm.generate(ids, seed=0, **kw)
    assert a.shape == (1, 10)
    assert torch.equal(a, tm.generate(ids, seed=0, **kw))
    assert not torch.equal(a, tm.generate(ids, seed=1, **kw))


def test_gather_state_reorders_the_batch_axis():
    """The stacked cache along axis 2 and a recurrent state along axis 1,
    each into the second buffer given."""
    cache = torch.arange(2 * 2 * 3 * 4, dtype=torch.float32).view(
        2, 2, 3, 4, 1, 1)
    idx = torch.tensor([2, 2, 0])
    out = torch.empty_like(cache)
    assert tgen._gather_state(cache, idx, out) is out
    assert torch.equal(out, cache[:, :, idx])
    state = {"conv": torch.arange(6.).view(2, 3), "ssm": torch.ones(2, 3)}
    got = tgen._gather_state(state, idx, {k: torch.empty_like(v)
                                          for k, v in state.items()})
    assert torch.equal(got["conv"], state["conv"][:, idx])


def test_extra_inputs_are_static_buffers(pair):
    """A program copies ``extra_inputs`` into buffers of its own each call
    (the key carries their shapes, not their values)."""
    _, tm = pair

    class WithExtra(torch.nn.Module):
        def __init__(self, lm):
            super().__init__()
            self.lm = lm
            self.config = lm.config
            self.seen = []

        def decode_step(self, ids, cache, pos, bias):
            self.seen.append(bias)
            logits, cache = self.lm.decode_step(ids, cache, pos)
            return logits + bias[:, None, :], cache

    m = WithExtra(tm)
    ids = _prompt(2, 4, seed=5)
    bias = torch.zeros(2, 256)
    bias[:, 7] = 1e4
    out = greedy_generate(m, ids, 3, extra_inputs={"bias": bias})
    assert (out[:, 4:] == 7).all()
    bias2 = torch.zeros(2, 256)
    bias2[:, 9] = 1e4
    out = greedy_generate(m, ids, 3, extra_inputs={"bias": bias2})
    assert (out[:, 4:] == 9).all()
    assert len(m._generate_jit_cache) == 1
    assert all(t is m.seen[0] for t in m.seen)


def test_a_copy_of_the_model_starts_with_no_program(pair):
    """``copy.deepcopy`` of a model that has generated (as
    ``quantize_for_decode`` and the chip checks' float32 copies do) gives
    an empty program cache: a program holds buffers, and on the card CUDA
    graphs, of the original."""
    import copy
    tm = _fresh(pair[0])
    tm.generate(_prompt(1, 4), max_new_tokens=2)
    assert len(tm._generate_jit_cache) == 1
    dup = copy.deepcopy(tm)
    assert isinstance(dup._generate_jit_cache, step_graph.ProgramCache)
    assert len(dup._generate_jit_cache) == 0
    assert len(quantize_for_decode(tm, min_elems=2048).unwrapped
               ._generate_jit_cache) == 0
