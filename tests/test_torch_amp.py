"""The port's ``amp`` against the JAX package's, on the CPU
(``tests/test_amp.py`` ported): the white and black lists, custom lists,
O2 ``decorate`` (parameters, buffers, master weights), the scaler's scale
/ unscale (bit-equal to JAX's), inf and NaN detection and the scale's
decay, growth, the functional skip, ``step`` unscaling internally and
skipping on inf, the update rule against JAX's over a seeded sequence of
found_inf values, O1 through the model's seam (``nn.quant.linear``, an
int8 weight included), O1 on a float32 tiny Llama (float16 logits within
2^-8 of the largest of JAX's O1 logits), and loss scaling in
``build_train_step`` on a float32 model: with and without a scaler the
parameters come out bit-equal (a power-of-two scale commutes with every
rounding of the backward), and a scale that overflows skips the step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.nn.layer import functional_call

from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.nn import quant
from paddle_tpu_torch.optimizer import SGD, AdamW

F16 = torch.float16


def test_lists_are_the_reference_lists():
    assert amp.WHITE_LIST == jamp.WHITE_LIST
    assert amp.BLACK_LIST == jamp.BLACK_LIST


def test_autocast_casts_whitelist():
    x, w = torch.ones(2, 4), torch.ones(4, 3)
    with amp.auto_cast(dtype="float16"):
        assert quant.linear(x, w).dtype == F16
        assert amp.compute_dtype("matmul", x, w) == F16
    assert quant.linear(x, w).dtype == torch.float32
    assert amp.get_policy() is None


def test_autocast_blacklist_and_non_float_untouched():
    x = torch.ones(2, 8)
    with amp.auto_cast(dtype="float16"):
        assert amp.compute_dtype("softmax", x) is None
        assert amp.compute_dtype("not_listed", x) is None
        assert amp.compute_dtype("matmul", x, torch.ones(8, dtype=torch.int8)) \
            is None
        assert amp.cast_inputs("softmax", x)[0].dtype == torch.float32


@pytest.mark.parametrize("kw,want", [
    (dict(custom_black_list={"matmul"}), torch.float32),
    (dict(custom_white_list={"softmax"}), F16),
    (dict(enable=False), torch.float32)])
def test_autocast_custom_lists(kw, want):
    """Custom lists move ops across, as the reference's do; a disabled
    policy casts nothing."""
    x = torch.ones(2, 4)
    op = "softmax" if "custom_white_list" in kw else "matmul"
    with amp.auto_cast(dtype="float16", **kw):
        jax_dt = None
        with jamp.auto_cast(dtype="float16", **kw):
            jax_dt = jamp.compute_dtype(op, jnp.ones((2, 4)))
        got = amp.cast_inputs(op, x)[0].dtype
    assert got == want
    assert (jax_dt is None) == (want == torch.float32)


def test_decorate_o2_casts_parameters_buffers_and_sets_masters():
    m = LlamaForCausalLM(config_from(jax_tiny()), device="cpu")
    opt = AdamW(1e-3, multi_precision=False)
    m2, opt2 = amp.decorate(m, opt, level="O2", dtype="float16")
    assert m2 is m and opt2 is opt and opt._multi_precision
    assert all(p.dtype == F16 for p in m.parameters())
    assert m.model.rope_cos.dtype == F16      # as the reference's astype
    m3 = LlamaForCausalLM(config_from(jax_tiny()), device="cpu")
    amp.decorate([m3], [AdamW(1e-3)], level="O1", dtype="float16",
                 master_weight=False)
    assert all(p.dtype == torch.float32 for p in m3.parameters())


def test_grad_scaler_scale_unscale_match_jax():
    s, js = amp.GradScaler(init_loss_scaling=1024.0), \
        jamp.GradScaler(init_loss_scaling=1024.0)
    assert float(s.scale(torch.tensor(2.0))) == 2048.0
    g = np.random.default_rng(0).normal(size=(64,)).astype(np.float16) * 1024
    un = s.unscale_({"w": torch.from_numpy(g.copy())})
    jun = js.unscale_({"w": jnp.asarray(g)})
    assert un["w"].dtype == F16
    np.testing.assert_array_equal(un["w"].numpy().view(np.uint16),
                                  np.asarray(jun["w"]).view(np.uint16))
    assert not bool(s._found_inf)


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_grad_scaler_inf_detection_and_decay(bad):
    s = amp.GradScaler(init_loss_scaling=1024.0, decr_ratio=0.5,
                       decr_every_n_nan_or_inf=1)
    s.unscale_({"a": torch.ones(3), "w": torch.tensor([1.0, bad])})
    assert bool(s._found_inf)
    s.update()
    assert float(s.loss_scaling) == 512.0
    assert int(s._state["bad_steps"]) == 0


def test_grad_scaler_growth():
    s = amp.GradScaler(init_loss_scaling=2.0, incr_every_n_steps=2,
                       incr_ratio=2.0)
    for _ in range(2):
        s.unscale_({"w": torch.tensor([1.0])})
        s.update()
    assert float(s.loss_scaling) == 4.0


def test_grad_scaler_functional_skip():
    s = amp.GradScaler(init_loss_scaling=1.0)
    _, found = s.unscale_with(s.init_state(), {"w": torch.tensor([np.nan])})
    assert bool(found)


@pytest.mark.parametrize("incr,decr", [(2, 1), (3, 2), (2000, 1)])
def test_update_rule_matches_jax(incr, decr):
    """The state after each of 40 seeded found_inf values equals JAX's."""
    kw = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=incr,
              decr_every_n_nan_or_inf=decr)
    s, js = amp.GradScaler(**kw), jamp.GradScaler(**kw)
    st, jst = s.init_state(), js.init_state()
    for f in np.random.default_rng(incr + decr).random(40) < 0.3:
        st = s.update_state(st, bool(f))
        jst = js.update_state(jst, jnp.asarray(bool(f)))
        assert float(st["scale"]) == float(jst["scale"])
        assert int(st["good_steps"]) == int(jst["good_steps"])
        assert int(st["bad_steps"]) == int(jst["bad_steps"])
        assert st["scale"].dtype == torch.float32
        assert st["good_steps"].dtype == torch.int32


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(2, 2))


def test_grad_scaler_step_unscales_internally():
    model = _Linear()
    o = SGD(learning_rate=1.0, parameters=model)
    s = amp.GradScaler(init_loss_scaling=1024.0)
    w0 = model.weight.detach().clone()
    s.step(o, {"weight": torch.full((2, 2), 1024.0)})   # true grad 1.0
    s.update()
    torch.testing.assert_close(model.weight.detach(), w0 - 1.0)


def test_grad_scaler_step_skips_on_inf():
    model = _Linear()
    o = SGD(learning_rate=1.0, parameters=model)
    s = amp.GradScaler(init_loss_scaling=2.0)
    w0 = model.weight.detach().clone()
    s.step(o, {"weight": torch.full((2, 2), float("inf"))})
    s.update()
    assert torch.equal(model.weight.detach(), w0)
    assert float(s.loss_scaling) == 1.0


def test_o1_through_linear_int8_weight():
    """Under O1 an int8 weight is dequantized in x's dtype and multiplied
    in the policy's (the reference's int8 model under a policy); without
    a policy it keeps the weight-only path."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 64)).astype(np.float32))
    w8, sc = quant.weight_quantize(torch.from_numpy(
        np.random.default_rng(2).normal(size=(64, 32)).astype(np.float32)))
    w = quant.Int8Weight(w8, sc)
    with amp.auto_cast(dtype="float16"):
        got = quant.linear(x, w)
    want = x.to(F16) @ w.dequantize(torch.float32).to(F16)
    assert got.dtype == F16 and torch.equal(got, want)
    plain = quant.linear(x, w)
    assert plain.dtype == torch.float32
    assert torch.equal(plain, quant.weight_only_linear(x, w8,
                                                       weight_scale=sc))


@pytest.fixture(scope="module")
def tiny_f32():
    pt.seed(0)
    jm = JaxLlama(jax_tiny(dtype="float32", context_parallel="gspmd"))
    jm.eval()
    state = {k: np.asarray(v)
             for k, v in jm.state_dict(include_buffers=True).items()}
    tm = LlamaForCausalLM(config_from(jm.config), device="cpu")
    load_jax_state_dict(tm, state)
    return jm, tm


@pytest.mark.parametrize("tied", [False, True])
def test_o1_tiny_llama_logits_match_jax(tiny_f32, tied):
    """A float32 tiny Llama under ``auto_cast(dtype="float16")``: every
    projection and the head compute in float16 (float16 logits), within
    2^-8 of the largest of JAX's O1 logits; outside the policy float32
    again.  ``tied``: the head through the embedding table."""
    jm, tm = tiny_f32
    ids = np.random.RandomState(3).randint(0, 256, (2, 16)).astype(np.int32)
    params = jm.state_dict(include_buffers=True)
    if tied:
        jm.config.tie_word_embeddings = tm.config.tie_word_embeddings = True
    try:
        with jamp.auto_cast(dtype="float16"):
            jl = functional_call(jm, params, jnp.asarray(ids))
        with amp.auto_cast(dtype="float16"), torch.no_grad():
            tl = tm(torch.from_numpy(ids))
        with torch.no_grad():
            t32 = tm(torch.from_numpy(ids))
    finally:
        jm.config.tie_word_embeddings = tm.config.tie_word_embeddings = False
    assert jl.dtype == jnp.float16 and tl.dtype == F16
    assert t32.dtype == torch.float32
    want = np.asarray(jl, np.float32)
    err = np.abs(tl.float().numpy() - want).max()
    assert err <= 2 ** -8 * np.abs(want).max(), err


def _batch(seed):
    ids = np.random.RandomState(seed).randint(0, 256, (4, 17))
    return {"input_ids": torch.from_numpy(ids[:, :-1]),
            "labels": torch.from_numpy(ids[:, 1:])}


@pytest.mark.parametrize("accum", [1, 2])
def test_scaled_float32_step_is_bit_equal_to_the_unscaled(accum):
    """``build_train_step`` with an enabled scaler on a float32 tiny Llama:
    the loss times 2^15, the gradients unscaled after the (float32)
    accumulation, gives the parameters and the loss of the step without a
    scaler bit for bit; the scaler counts good steps.  At 2^127 the scaled
    loss is inf: the step is skipped (parameters and optimizer state
    bit-equal), the scale halves, the unscaled loss is returned."""
    base = LlamaForCausalLM(config_from(jax_tiny()), device="cpu", seed=4)
    runs = []
    for scaler in (None, amp.GradScaler()):
        m = LlamaForCausalLM(config_from(jax_tiny()), device="cpu")
        m.load_state_dict(base.state_dict())
        opt = AdamW(1e-3, weight_decay=0.01)
        step = build_train_step(m, opt, grad_accum_steps=accum,
                                scaler=scaler)
        losses = [step(_batch(i)) for i in range(2)]
        runs.append((losses, m, opt, step, scaler))
    (l0, m0, _, _, _), (l1, m1, opt, step, scaler) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(m0.parameters(),
                                                  m1.parameters()))
    assert int(scaler._state["good_steps"]) == 2
    scaler._state = dict(scaler._state, scale=torch.tensor(2.0 ** 127))
    before = [p.detach().clone() for p in m1.parameters()]
    m1_state = {k: dict(v) if isinstance(v, dict) else v
                for k, v in opt.state_dict().items()}
    loss = step(_batch(9))
    assert torch.isfinite(loss)
    assert all(torch.equal(a, b) for a, b in zip(before, m1.parameters()))
    assert opt.state_dict()["step"] == m1_state["step"] == 2
    assert all(opt.state_dict()["moment1"][k] is v
               for k, v in m1_state["moment1"].items())
    assert float(scaler.loss_scaling) == 2.0 ** 126
    assert int(scaler._state["good_steps"]) == 0
