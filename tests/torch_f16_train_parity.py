"""What ``tests/test_torch_f16_train*.py`` share: the float16 train step
with an enabled ``GradScaler`` run through the JAX package and through
the port from one set of weights, and the checks held between them.

Both sides take the reference's float16 path: the model at float16,
``amp.decorate(model, opt, level="O2", dtype="float16")`` (the RoPE
tables too, float32 master weights), a ``GradScaler`` in
``build_train_step``.  The JAX step is compiled once per model and run
from three initial scales by setting ``opt_state["grad_scaler"]["scale"]``
(a traced value): 2^15, the default, where no step overflows; MIXED,
where the first steps overflow and halve the scale until one is taken;
2^40, where every step overflows.  The optimizer is Momentum: its update
is linear in the gradient, so the float16 rounding noise of the two
backwards (the gradients agree to ~1e-3 relative L2, each ~1e-3 from a
float32 truth) moves a parameter by ~1e-3 of one update, well below a
float16 ulp; Adam's per-element normalisation lifts that noise to
whole updates wherever an element's gradient is near zero (2.4 % of the
narrow Llama's head after 2 steps at lr 1e-3 differed by 2 lr), which
no ulp bound can hold.  Bars: the scaler's scale, good and bad steps
identical after every step; losses within 2^-9 relative; a skipped step
leaves the port's parameters, float32 masters, velocity and step counter
bit-equal; parameters within ULPS float16 ulps of JAX's, an ulp taken at
the larger of the two values' magnitudes and the tensor's median
magnitude.  Two widenings of "2 ulps", both for the same noise: the
floor, because a float16 ulp shrinks toward zero (to 6e-8 among the
subnormals) while the update's noise does not (elements below 1e-4 sat
13-62 ulps of their own apart, 3e-6 absolute); and 4 ulps, because the
noise of 4 momentum steps at lr 0.05 adds up (measured at the floor:
at most 1.5 ulps on the tiny Llama, 1.0 / 1.5 / 2.0 / 2.75 after steps
1-4 on the narrow one); a wrong update is off by whole updates, ~100
ulps a step."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu import amp as jamp
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.optimizer import Momentum as JaxMomentum

from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.models import (LlamaForCausalLM, config_from,
                                     load_jax_state_dict)
from paddle_tpu_torch.optimizer import Momentum

STEPS = 4
LR, MOMENTUM = 0.05, 0.9
MIXED = 2.0 ** 22
SCALES = {"2^15": 2.0 ** 15, "mixed": MIXED, "2^40": 2.0 ** 40}
LOSS_RTOL = 2.0 ** -9
ULPS = 4


def _batches():
    rng = np.random.RandomState(42)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(0, 256, (8, 17)).astype(np.int32)
        out.append({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    return out


def _cfg(**widths):
    return jax_tiny(dtype="float16", context_parallel="gspmd", **widths)


def jax_runs(**widths):
    """(initial state_dict, {run: [(loss, scale, good, bad, params)]})."""
    hcg = jdist.HybridCommunicateGroup(devices=jax.devices()[:1])
    jdist.set_hybrid_group(hcg)
    try:
        pt.seed(123)
        model = JaxLlama(_cfg(**widths))
        opt = JaxMomentum(LR, momentum=MOMENTUM)
        model, opt = jamp.decorate(model, opt, level="O2", dtype="float16")
        init = {k: np.asarray(v)
                for k, v in model.state_dict(include_buffers=True).items()}
        step, params0, opt0 = jdist.build_train_step(
            model, opt, hcg=hcg, scaler=jamp.GradScaler(), donate=False)
        runs = {}
        for run, scale in SCALES.items():
            params, o = params0, dict(opt0)
            o["grad_scaler"] = dict(o["grad_scaler"],
                                    scale=jnp.float32(scale))
            out = []
            for i, b in enumerate(_batches()):
                batch = jdist.shard_batch(
                    {k: jnp.asarray(a) for k, a in b.items()}, hcg)
                loss, params, o = step(params, o, batch, jax.random.key(i))
                g = o["grad_scaler"]
                out.append((float(loss), float(g["scale"]),
                            int(g["good_steps"]), int(g["bad_steps"]),
                            {k: np.asarray(v) for k, v in params.items()}))
            runs[run] = out
        return init, runs
    finally:
        jdist.set_hybrid_group(None)


def port_run(init, scale, **widths):
    """[(loss, scale, good, bad, params, masters, velocity, opt step)]
    of the port's step from ``init`` at ``scale``."""
    model = LlamaForCausalLM(config_from(_cfg(**widths)), device="cpu")
    load_jax_state_dict(model, init)
    opt = Momentum(LR, momentum=MOMENTUM)
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=scale)
    step = build_train_step(model, opt, scaler=scaler)
    out = []
    for b in _batches():
        loss = step({k: torch.from_numpy(a) for k, a in b.items()})
        st, ost = scaler._state, opt.state_dict() or {}
        out.append((float(loss), float(st["scale"]), int(st["good_steps"]),
                    int(st["bad_steps"]),
                    {k: p.detach().clone()
                     for k, p in model.named_parameters()},
                    {k: v.clone() for k, v in ost.get("master", {}).items()},
                    {k: v.clone() for k, v in ost.get("velocity",
                                                      {}).items()},
                    ost.get("step", 0)))
    return out


def check_scaler_states(jax_out, port_out):
    assert [r[1:4] for r in port_out] == [r[1:4] for r in jax_out]


def check_losses(jax_out, port_out):
    for (jl, *_), (tl, *_) in zip(jax_out, port_out):
        assert np.isfinite(tl)
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)


def check_params(jax_out, port_out):
    for j, t in zip(jax_out, port_out):
        for k, jv in j[4].items():
            tv = t[4][k].numpy()
            assert tv.dtype == np.float16 and jv.dtype == np.float16
            mag = np.maximum(np.maximum(np.abs(jv), np.abs(tv)),
                             np.median(np.abs(jv)).astype(np.float16))
            ulp = np.spacing(mag).astype(np.float32)
            diff = np.abs(tv.astype(np.float32) - jv.astype(np.float32))
            assert (diff <= ULPS * ulp).all(), (k, float((diff / ulp).max()))


def check_skips(jax_out, port_out, init):
    """A step the JAX scaler counted as skipped (its scale halved) leaves
    the port's parameters, masters, velocity and step counter bit-equal
    to the step before's (the initial weights before the first)."""
    prev = None
    skipped = 0
    for j, t in zip(jax_out, port_out):
        if j[2] == 0:       # no good step counted: the step was skipped
            skipped += 1
            if prev is None:
                assert all(np.array_equal(t[4][k].numpy().view(np.uint16),
                                          init[k].view(np.uint16))
                           for k in t[4])
                assert t[7] == 0 and not t[5] and not t[6]
            else:
                assert all(torch.equal(prev[4][k], t[4][k]) for k in t[4])
                assert all(torch.equal(prev[5][k], t[5][k]) for k in t[5])
                assert all(torch.equal(prev[6][k], t[6][k]) for k in t[6])
                assert t[7] == prev[7]
        else:
            assert t[7] == (prev[7] if prev is not None else 0) + 1
        prev = t
    return skipped
