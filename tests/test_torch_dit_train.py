"""The port's DiT train step against the JAX package's ``build_train_step``,
on the CPU in float32.

The tiny DiT (head_dim 16) and a narrow one at DiT-XL/2's head_dim 72
(hidden 144, 2 heads) are built by JAX, moved off AdaLN-Zero (every gate
and the final projection nonzero, so attention reaches the loss) and
carried into the port by ``load_jax_state_dict``.  The same numpy batches
(noised latents x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps, the
target eps, t uniform, one label in 8 the null class, as the reference's
test builds them) go through 4 steps of both train steps with AdamW:
plain, ``recompute=True`` (the reference's ``jax.checkpoint`` of each
block, the port's ``torch.utils.checkpoint``) and ``grad_accum_steps=2``.
Tolerances are ``tests/test_torch_train.py``'s: losses rtol 1e-5 (float32
sum order), parameters rtol 1e-5 with atol 5e-5 (5 % of one step's lr:
Adam divides each element's gradient by its own RMS, so where two steps'
gradients nearly cancel, sum-order noise reaches the update).  Also: one
step's gradients of ``compute_loss`` against ``jax.grad`` at 1e-5, and an
import guard (the train path imports no JAX).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.models import diffusion as jdiff
from paddle_tpu.models import dit as jdit
from paddle_tpu.nn.layer import bind_params
from paddle_tpu.optimizer import AdamW as JaxAdamW

from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.models import DiT, load_jax_state_dict, tiny_dit_config
from paddle_tpu_torch.ops import _dispatch
from paddle_tpu_torch.optimizer import AdamW

REPO = Path(__file__).resolve().parents[1]
STEPS, ROWS, LR = 4, 8, 1e-3
TOL = dict(rtol=1e-5, atol=1e-6)           # losses
PARAM_TOL = dict(rtol=1e-5, atol=5e-5)     # parameters (module docstring)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)

# the tiny DiT (head_dim 16) and a narrow one at DiT-XL/2's head_dim 72
CONFIGS = {"tiny": {}, "d72": dict(hidden_size=144, num_heads=2)}
VARIANTS = {"plain": {}, "recompute": {"recompute": True},
            "grad_accum": {"grad_accum": 2}}


def _batches(cfg, n=STEPS, seed=42):
    """Seeded numpy batches of the DiT objective."""
    rng = np.random.RandomState(seed)
    abar = np.asarray(jdiff.diffusion_schedule())
    shape = (ROWS, cfg.in_channels, cfg.input_size, cfg.input_size)
    out = []
    for _ in range(n):
        x0 = rng.standard_normal(shape).astype(np.float32)
        eps = rng.standard_normal(shape).astype(np.float32)
        t = rng.randint(0, len(abar), ROWS).astype(np.int32)
        y = rng.randint(0, cfg.num_classes, ROWS).astype(np.int32)
        y[rng.randint(ROWS)] = cfg.num_classes       # the null class
        a = abar[t][:, None, None, None]
        out.append({"x": (np.sqrt(a) * x0 + np.sqrt(1 - a) * eps).astype(
                        np.float32),
                    "t": t, "y": y, "target": eps})
    return out


def _jax_model(kw):
    """The JAX DiT off AdaLN-Zero, in training mode."""
    pt.seed(0)
    jm = jdit.DiT(jdit.tiny_dit_config(**kw))
    rng = np.random.RandomState(0)
    jm.set_state_dict({k: jnp.asarray(np.asarray(v) + 0.02 * rng
                                      .standard_normal(v.shape)
                                      .astype(np.float32))
                       for k, v in jm.state_dict().items()}, strict=False)
    jm.train()
    return jm


def _port_model(kw, jm):
    tm = DiT(tiny_dit_config(**kw), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict(
        include_buffers=True).items()})
    tm.train()
    return tm


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module",
                params=[(c, v) for c in sorted(CONFIGS) for v in
                        sorted(VARIANTS)], ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request):
    """Both train steps over the same batches from the same weights:
    (name, jax losses, jax params, port losses, port model)."""
    name, variant = request.param
    v = VARIANTS[variant]
    kw = dict(CONFIGS[name], recompute=v.get("recompute", False))
    jm = _jax_model(kw)
    tm = _port_model(kw, jm)
    batches = _batches(tm.config)
    accum = v.get("grad_accum", 1)
    hcg = jdist.HybridCommunicateGroup(devices=jax.devices()[:1])
    jdist.set_hybrid_group(hcg)
    try:
        step, params, opt_state = jdist.build_train_step(
            jm, JaxAdamW(LR, weight_decay=0.0), hcg=hcg,
            grad_accum_steps=accum)
        jl = []
        key = jax.random.key(0)
        for i, b in enumerate(batches):
            batch = jdist.shard_batch({k: jnp.asarray(a) for k, a in
                                       b.items()}, hcg)
            loss, params, opt_state = step(params, opt_state, batch,
                                           jax.random.fold_in(key, i))
            jl.append(float(loss))
        jp = _np(params)
    finally:
        jdist.set_hybrid_group(None)
    tstep = build_train_step(tm, AdamW(LR, weight_decay=0.0),
                             grad_accum_steps=accum)
    _dispatch.reset_kernel_paths()
    tl = [float(tstep({k: torch.from_numpy(a) for k, a in b.items()}))
          for b in batches]
    paths = dict(_dispatch.kernel_paths)
    return f"{name}-{variant}", jl, jp, tl, tm, paths


def test_dit_train_step_matches_jax(runs):
    name, jl, jp, tl, tm, _ = runs
    np.testing.assert_allclose(tl, jl, **TOL, err_msg=name)
    got = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(jp)
    for k in jp:
        np.testing.assert_allclose(got[k], jp[k], **PARAM_TOL,
                                   err_msg=f"{name}: {k}")


def test_dit_train_step_routes(runs):
    """Every block's attention went through ``flash_attention`` on its
    plain route (the CPU), once a block and micro-batch, twice with
    recompute (the checkpoint runs the block's forward again)."""
    name, _, _, _, tm, paths = runs
    accum = VARIANTS[name.split("-")[1]].get("grad_accum", 1)
    per_step = tm.config.depth * accum * (2 if tm.config.recompute else 1)
    assert paths == {("flash_attention", "plain"): per_step * STEPS}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_compute_loss_grad_matches_jax(name):
    """One step's gradients of ``compute_loss`` against ``jax.grad`` of the
    reference's, every parameter."""
    jm = _jax_model(CONFIGS[name])
    tm = _port_model(CONFIGS[name], jm)
    b = _batches(tm.config, n=1, seed=7)[0]
    params = jm.trainable_state()

    def jloss(p):
        with bind_params(jm, p):
            return jm.compute_loss(*(jnp.asarray(b[k]) for k in
                                     ("x", "t", "y", "target")))

    jval, want = jax.value_and_grad(jloss)(params)
    names = [n for n, _ in tm.named_parameters()]
    loss = tm.compute_loss(*(torch.from_numpy(b[k]) for k in
                             ("x", "t", "y", "target")))
    got = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    assert float(loss.detach()) == pytest.approx(float(jval),
                                                 rel=1e-5)
    assert set(names) == set(want)
    for n, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[n]),
                                   **GRAD_TOL, err_msg=n)
    assert float(got[names.index("blocks.0.qkv")].abs().max()) > 0


def test_train_path_imports_no_jax():
    code = ("import sys, paddle_tpu_torch.models.dit, "
            "paddle_tpu_torch.distributed, paddle_tpu_torch.optimizer; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
