"""The port's single-device train step against the JAX package's
``build_train_step``, on the CPU.

One JAX tiny Llama (float32) is bridged into the port with
``load_jax_state_dict``; the same numpy batches (the dryrun's (8, 17) ids)
go through 4 steps of both train steps.  Losses agree to float32 rounding
(rtol 1e-5; measured <= 2e-7: the libraries sum in other orders).  Final
parameters agree to rtol 1e-5 with atol 5e-5, 5 % of one step's lr (1e-3):
Adam divides each element's mean gradient by its own RMS, so where two
steps' gradients nearly cancel, the float32 sum-order noise of the
gradient reaches the update at up to a few percent of lr (measured: 2-5
elements of ~50k beyond 1e-5, all below 3e-5).  Variants: plain,
recompute (full and "dots"), gradient accumulation, a packed batch
(segment ids, restarting positions, boundary labels), global-norm clipping
with a linear warmup, and a run resumed from a JAX optimizer state.  Each
JAX run is compiled once per module.
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
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import lr as jax_lr

from paddle_tpu_torch import amp, flags
from paddle_tpu_torch.distributed import build_eval_step, build_train_step
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_optimizer_state,
                                     load_jax_state_dict)
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, SGD, lr

STEPS = 4
ROWS, SEQ = 8, 16
TOL = dict(rtol=1e-5, atol=1e-6)           # losses
PARAM_TOL = dict(rtol=1e-5, atol=5e-5)     # parameters (module docstring)


def _batches(packed: bool):
    rng = np.random.RandomState(42)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(0, 256, (ROWS, SEQ + 1)).astype(np.int32)
        b = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
        if packed:
            # 1-3 documents a row at seeded boundaries, positions restart
            seg = np.zeros((ROWS, SEQ), np.int32)
            pos = np.zeros((ROWS, SEQ), np.int32)
            for r in range(ROWS):
                cuts = sorted(rng.choice(np.arange(2, SEQ - 1),
                                         rng.randint(0, 3), replace=False))
                for c in cuts:
                    seg[r, c:] += 1
                start = 0
                for c in list(cuts) + [SEQ]:
                    pos[r, start:c] = np.arange(c - start)
                    start = c
            b.update(segment_ids=seg, position_ids=pos)
        out.append(b)
    return out


VARIANTS = {
    "plain": dict(),
    "recompute": dict(recompute=True),
    "recompute_dots": dict(recompute=True, policy="dots"),
    "grad_accum": dict(grad_accum=2),
    "packed": dict(packed=True),
    "clip_warmup": dict(clip=0.1, warmup=2),
}


def _jax_opt(v):
    lr_ = 1e-3 if "warmup" not in v else jax_lr.LinearWarmup(1e-3, v["warmup"])
    clip = JaxClip(v["clip"]) if "clip" in v else None
    return JaxAdamW(lr_, weight_decay=0.01, grad_clip=clip)


def _port_opt(v):
    lr_ = 1e-3 if "warmup" not in v else lr.LinearWarmup(1e-3, v["warmup"])
    clip = ClipGradByGlobalNorm(v["clip"]) if "clip" in v else None
    return AdamW(lr_, weight_decay=0.01, grad_clip=clip)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_run(v, steps=STEPS, start=None):
    """(initial state_dict, losses, final params, opt_states by step);
    ``start`` = (params, opt_state) resumes."""
    hcg = jdist.HybridCommunicateGroup(devices=jax.devices()[:1])
    jdist.set_hybrid_group(hcg)
    try:
        pt.seed(123)
        model = JaxLlama(jax_tiny(**_cfg(v)))
        init = _np(model.state_dict(include_buffers=True))
        step, params, opt_state = jdist.build_train_step(
            model, _jax_opt(v), hcg=hcg, grad_accum_steps=v.get("grad_accum",
                                                                1))
        if start is not None:
            params, opt_state = jax.tree.map(jnp.asarray, start)
        losses, states = [], []
        key = jax.random.key(0)
        for i, b in enumerate(_batches(v.get("packed", False))[:steps]):
            batch = jdist.shard_batch({k: jnp.asarray(a) for k, a in b.items()},
                                      hcg)
            loss, params, opt_state = step(params, opt_state, batch,
                                           jax.random.fold_in(key, i))
            losses.append(float(loss))
            states.append((_np(params), _np(opt_state)))
        return init, losses, _np(params), states
    finally:
        jdist.set_hybrid_group(None)


def _cfg(v):
    return dict(recompute=v.get("recompute", False),
                recompute_policy=v.get("policy", "full"))


def _port_model(jax_cfg_kw, init):
    m = LlamaForCausalLM(config_from(jax_tiny(**jax_cfg_kw)), device="cpu")
    return load_jax_state_dict(m, init)


def _port_run(v, init, batches, opt=None, model=None):
    model = model or _port_model(_cfg(v), init)
    opt = opt or _port_opt(v)
    step = build_train_step(model, opt, grad_accum_steps=v.get("grad_accum",
                                                               1))
    losses = []
    for b in batches:
        losses.append(float(step({k: torch.from_numpy(a)
                                  for k, a in b.items()})))
    return losses, model, opt


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant_runs(request):
    v = VARIANTS[request.param]
    init, jl, jp, _ = _jax_run(v)
    tl, tm, _ = _port_run(v, init, _batches(v.get("packed", False)))
    return request.param, jl, jp, tl, tm


def test_train_step_matches_jax(variant_runs):
    name, jl, jp, tl, tm = variant_runs
    np.testing.assert_allclose(tl, jl, **TOL, err_msg=name)
    got = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(jp)
    for k in jp:
        np.testing.assert_allclose(got[k], jp[k], **PARAM_TOL,
                                   err_msg=f"{name}: {k}")


def test_resume_from_jax_optimizer_state():
    """Two JAX steps, then the port resumes from JAX's parameters and
    optimizer state and takes steps 3-4: it must land where JAX's own 4
    steps land."""
    v = {"clip": 0.1, "warmup": 2}
    init, jl, jp, states = _jax_run(v)
    params2, opt2 = states[1]
    model = _port_model({}, {**init, **params2})
    opt = _port_opt(v)
    build_train_step(model, opt)          # binds the optimizer to the model
    load_jax_optimizer_state(opt, opt2)
    assert opt.state_dict()["step"] == 2
    tl, tm, _ = _port_run(v, None, _batches(False)[2:], opt=opt, model=model)
    np.testing.assert_allclose(tl, jl[2:], **TOL)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[k], **PARAM_TOL,
                                   err_msg=k)


def test_load_jax_optimizer_state_checks_names():
    m = LlamaForCausalLM(config_from(jax_tiny()), device="cpu")
    opt = AdamW(1e-3, parameters=m)
    state = {"step": np.int32(0), "moment1": {}, "moment2": {}}
    with pytest.raises(KeyError, match="names do not match"):
        load_jax_optimizer_state(opt, state)
    with pytest.raises(KeyError, match="keys"):
        load_jax_optimizer_state(opt, {"step": 0})


def test_refusals_and_nan_check():
    m = LlamaForCausalLM(config_from(jax_tiny()), device="cpu")
    with pytest.raises(NotImplementedError, match="A9/A10"):
        build_train_step(m, SGD(0.1), hcg={"dp": 2, "mp": 1})
    build_train_step(m, SGD(0.1), hcg={"dp": 1, "mp": 1})   # one device

    ids = torch.zeros(2, 5, dtype=torch.long)
    # an enabled loss scaler is taken (``amp``, once refused); with it the
    # check runs on the unscaled gradients, before the scaler's update, as
    # the reference orders them
    scaler = amp.GradScaler()
    for sc in (None, scaler):
        step = build_train_step(
            m, SGD(0.1), loss_fn=lambda mod, b: mod(b["input_ids"]).sum()
            * float("nan"), scaler=sc)
        flags.set_flags({"check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError, match="non-finite"):
                step({"input_ids": ids})
        finally:
            flags.set_flags({"check_nan_inf": False})
    assert float(scaler.loss_scaling) == 2.0 ** 15


def test_eval_step_restores_mode():
    m = LlamaForCausalLM(config_from(jax_tiny()), device="cpu")
    m.train()
    run = build_eval_step(m)
    out = run({"input_ids": torch.zeros(1, 4, dtype=torch.long)})
    assert out.shape == (1, 4, 256) and not out.requires_grad
    assert m.training
