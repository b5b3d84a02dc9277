"""The port's optimizers, gradient clipping and lr schedulers against the
JAX package's, on the CPU.

The same numpy parameters and gradients go through both functional cores
(``init`` / ``update``) for 5 steps: float32 parameters, one bf16
parameter with float32 master weights, and an ``apply_decay_param_fun``
that exempts one name.  Master weights, float32 parameters and slots agree
to 1e-6 relative (elementwise float32 math, the same inputs; the bias
corrections are float32 powers as in the reference); a bf16 parameter is
its master rounded to bf16 (compared at one bf16 ulp, 2^-8 relative).
Schedulers: every value at steps 0..12 to 1e-6 relative (the reference
computes in float32, the port in float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.optimizer import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr

TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=2 ** -8, atol=1e-6)
SHAPES = {"w": (4, 6), "b": (6,), "norm.weight": (5,), "h": (3, 5)}
BF16 = {"h"}


def _no_decay(name):
    return not name.endswith("norm.weight")


# name -> (constructor args shared by both packages); each also gets
# apply_decay_param_fun (not Lamb, which has its own exclusion knob too)
OPTIMIZERS = {
    "SGD": ("SGD", dict(learning_rate=0.1, weight_decay=0.01)),
    "Momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  weight_decay=0.01)),
    "Momentum_nesterov": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                           use_nesterov=True)),
    "Adam": ("Adam", dict(learning_rate=0.01, weight_decay=0.01)),
    "AdamW": ("AdamW", dict(learning_rate=0.01, beta2=0.95, epsilon=1e-5,
                            weight_decay=0.1)),
    "AdamW_warmup_clip": ("AdamW", dict(weight_decay=0.1)),
    "Adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1)),
    "Adamax": ("Adamax", dict(learning_rate=0.01, weight_decay=0.01)),
    "RMSProp": ("RMSProp", dict(learning_rate=0.01, momentum=0.5)),
    "RMSProp_centered": ("RMSProp", dict(learning_rate=0.01, centered=True)),
    "Lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.01)),
}


def _make(pkg, name):
    cls, kw = OPTIMIZERS[name]
    kw = dict(kw, apply_decay_param_fun=_no_decay)
    if name == "Lamb":
        kw["exclude_from_weight_decay_fn"] = lambda n: n == "b"
    if name == "AdamW_warmup_clip":
        sched = (jlr if pkg is jopt else tlr).LinearWarmup(
            (jlr if pkg is jopt else tlr).CosineAnnealingDecay(0.01, 10), 2)
        clip = (jclip if pkg is jopt else tclip).ClipGradByGlobalNorm(0.5)
        kw.update(learning_rate=sched, grad_clip=clip)
    return getattr(pkg, cls)(**kw)


def _inputs():
    rng = np.random.RandomState(0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]
    return params, grads


def _jax_tree(d):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in BF16 else jnp.float32)
            for k, v in d.items()}


def _torch_tree(d):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k in BF16
                                      else torch.float32)
            for k, v in d.items()}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_update_matches_jax(name):
    p0, grads = _inputs()
    jo, to = _make(jopt, name), _make(topt, name)
    jp, tp = _jax_tree(p0), _torch_tree(p0)
    js, ts = jo.init(jp), to.init(tp)
    assert sorted(ts) == sorted(js)
    for step, g in enumerate(grads):
        jp, js = jo.update(_jax_tree(g), js, jp)
        tp, ts = to.update(_torch_tree(g), ts, tp)
        assert ts["step"] == int(js["step"]) == step + 1
        for k in SHAPES:
            tol = BF16_TOL if k in BF16 else TOL
            np.testing.assert_allclose(_f32(tp[k]), _f32(jp[k]), **tol,
                                       err_msg=f"{name} step {step} {k}")
            assert tp[k].dtype == (torch.bfloat16 if k in BF16
                                   else torch.float32)
        for slot in ts:
            if slot == "step":
                continue
            assert sorted(ts[slot]) == sorted(js[slot]), slot
            for k in ts[slot]:
                np.testing.assert_allclose(
                    _f32(ts[slot][k]), _f32(js[slot][k]), **TOL,
                    err_msg=f"{name} step {step} {slot}.{k}")
    assert sorted(ts["master"]) == sorted(BF16)


def test_imperative_step_updates_module_in_place():
    """``step()`` on a bound module equals the functional ``update`` and
    keeps the parameter tensors (in place)."""
    torch.manual_seed(0)
    mod = torch.nn.Linear(4, 3).to(torch.bfloat16)
    ref = {k: p.detach().clone() for k, p in mod.named_parameters()}
    opt = topt.AdamW(0.01, parameters=mod, weight_decay=0.1)
    fopt = topt.AdamW(0.01, weight_decay=0.1)
    state = fopt.init(ref)
    ids = {k: id(p) for k, p in mod.named_parameters()}
    for _ in range(3):
        mod(torch.randn(2, 4, dtype=torch.bfloat16)).float().sum().backward()
        grads = {k: p.grad.clone() for k, p in mod.named_parameters()}
        opt.step()
        opt.clear_grad()
        ref, state = fopt.update(grads, state, ref)
    for k, p in mod.named_parameters():
        assert id(p) == ids[k] and p.grad is None
        torch.testing.assert_close(p.detach(), ref[k], rtol=0, atol=0)
        torch.testing.assert_close(opt.state_dict()["master"][k],
                                   state["master"][k], rtol=0, atol=0)
    assert opt.state_dict()["step"] == 3 and opt.get_lr() == 0.01


def _grads():
    rng = np.random.RandomState(3)
    return {"a": rng.normal(size=(5, 7)).astype(np.float32) * 3,
            "b": rng.normal(size=(7,)).astype(np.float32),
            "h": rng.normal(size=(2, 3)).astype(np.float32)}


@pytest.mark.parametrize("clip", [
    ("ClipGradByGlobalNorm", (1.0,)), ("ClipGradByGlobalNorm", (1e3,)),
    ("ClipGradByNorm", (2.0,)), ("ClipGradByValue", (0.5,)),
    ("ClipGradByValue", (1.0, -0.25))], ids=str)
def test_clip_matches_jax(clip):
    cls, args = clip
    g = _grads()
    want = getattr(jclip, cls)(*args)(_jax_tree(g))
    got = getattr(tclip, cls)(*args)(_torch_tree(g))
    for k in g:
        tol = BF16_TOL if k in BF16 else TOL
        np.testing.assert_allclose(_f32(got[k]), _f32(want[k]), **tol,
                                   err_msg=k)
        assert got[k].dtype == (torch.bfloat16 if k in BF16
                                else torch.float32)
    np.testing.assert_allclose(
        float(tclip.global_norm(_torch_tree(g))),
        float(jclip.global_norm(_jax_tree(g))), **TOL)


def test_psum_axes_raise():
    with pytest.raises(NotImplementedError, match="A9/A10"):
        tclip.ClipGradByGlobalNorm(1.0, psum_axes=("dp",))
    with pytest.raises(NotImplementedError, match="A9/A10"):
        tclip.global_norm({}, psum_axes=("dp",))


def _schedulers(m):
    return {
        "constant": m.ConstantLR(0.3),
        "warmup_constant": m.LinearWarmup(0.1, 4, start_lr=0.01),
        "warmup_cosine": m.LinearWarmup(m.CosineAnnealingDecay(0.1, 6), 3),
        "cosine": m.CosineAnnealingDecay(0.1, 8, eta_min=0.01),
        "step": m.StepDecay(0.1, 3, gamma=0.5),
        "multistep": m.MultiStepDecay(0.1, [2, 5, 9], gamma=0.3),
        "exponential": m.ExponentialDecay(0.1, 0.9),
        "noam": m.NoamDecay(64, 4, learning_rate=2.0),
        "polynomial": m.PolynomialDecay(0.1, 8, end_lr=0.001, power=2.0),
    }


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_scheduler_values_match_jax(name):
    js, ts = _schedulers(jlr)[name], _schedulers(tlr)[name]
    steps = range(13)
    want = [float(js.value(jnp.asarray(s, jnp.int32))) for s in steps]
    got = [ts.value(s) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    # the imperative mirror walks the same values
    for s in steps:
        assert ts.get_lr() == pytest.approx(got[s], rel=1e-12)
        ts.step()
