"""The port's Qwen2-VL against the JAX package's, on the CPU in float32.

Two configurations: the reference's ``tiny_qwen2_vl_config`` (vision
head_dim 16, decoder head_dim 16) and a variant whose vision tower attends
at head_dim 64 (vision width 128, 2 heads: the default widths' D, so the
plain route of K2 / K5 / K6 at 64 runs here).  The JAX model's weights are
carried into the port by ``load_jax_state_dict``, with every cross gate set
to 0.5 first (at init ``tanh(0) = 0`` makes the decoder text-only, and the
image would not reach the logits).  The same numpy ids and pixels go
through both:

  * ``ViTBlock``, ``VisionTower``, ``CrossAttention``, ``forward`` and
    ``compute_loss`` at rtol 1e-5 (float32 sum order);
  * one step's gradients of ``compute_loss`` against ``jax.grad``, with
    and without ``recompute``, at 1e-5;
  * the train step (``build_train_step`` with AdamW) against the JAX
    package's, 3 steps: losses rtol 1e-5, parameters rtol 1e-5 + atol
    5e-5 (``tests/test_torch_train.py``'s tolerances);
  * greedy and beam ``generate`` token-identical to the JAX model's, and
    the reference's own tests (``tests/test_generation.py:246``: greedy
    equals the full forward's argmax, a second image reuses the program;
    :477: beam search tiles the vision features to B·K rows).
"""

import dataclasses
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
from paddle_tpu.models import qwen2_vl as jvl
from paddle_tpu.nn.layer import bind_params
from paddle_tpu.optimizer import AdamW as JaxAdamW

from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.models import (Qwen2VLConfig,
                                     Qwen2VLForConditionalGeneration,
                                     load_jax_state_dict,
                                     tiny_qwen2_vl_config)
from paddle_tpu_torch.ops import _dispatch
from paddle_tpu_torch.optimizer import AdamW

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=5e-5)
CONFIGS = {"tiny": {}, "d64": dict(vision_hidden_size=128, vision_heads=2)}
GATE = 0.5
LR = 1e-3


def _state(model):
    return {k: np.asarray(v)
            for k, v in model.state_dict(include_buffers=True).items()}


def _jax_model(kw, seed=43):
    pt.seed(seed)
    jm = jvl.Qwen2VLForConditionalGeneration(jvl.tiny_qwen2_vl_config(**kw))
    jm.set_state_dict({k: jnp.full_like(v, GATE) for k, v in
                       jm.state_dict().items() if k.endswith(".gate")},
                      strict=False)
    jm.eval()
    return jm


def _port_model(jm):
    tm = Qwen2VLForConditionalGeneration(
        Qwen2VLConfig(**dataclasses.asdict(jm.config)), device="cpu")
    load_jax_state_dict(tm, _state(jm))
    tm.eval()
    return tm


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    jm = _jax_model(CONFIGS[request.param])
    return request.param, jm, _port_model(jm)


def _inputs(cfg, b=2, s=5, seed=45):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pix = rng.standard_normal((b, cfg.in_channels, cfg.image_size,
                               cfg.image_size)).astype(np.float32)
    return ids, pix


def _t(a):
    return torch.from_numpy(np.array(a))


def test_config_and_default_widths_match_reference():
    for ours, ref in ((tiny_qwen2_vl_config(), jvl.tiny_qwen2_vl_config()),
                      (Qwen2VLConfig(), jvl.Qwen2VLConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert (ours.num_patches, ours.head_dim) == (ref.num_patches,
                                                     ref.head_dim)
    default = Qwen2VLConfig()
    assert default.vision_hidden_size // default.vision_heads == 64
    assert default.head_dim == 128 and default.num_patches == 256
    assert Qwen2VLConfig().as_llama().context_parallel == "gspmd"


def test_parameter_names_equal_both_ways(models):
    """JAX -> port by ``load_jax_state_dict`` (names and shapes checked
    there), then port -> JAX: the port's state put into a fresh JAX model
    gives the port's logits."""
    _, jm, tm = models
    want = _state(jm)
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert set(got) == set(want)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert sorted(n for n, _ in tm.named_parameters()) == \
        sorted(jm.trainable_state())
    back = jvl.Qwen2VLForConditionalGeneration(jm.config)
    back.set_state_dict({k: jnp.asarray(v) for k, v in got.items()})
    ids, pix = _inputs(jm.config)
    with torch.no_grad():
        mine = tm(_t(ids), _t(pix)).numpy()
    np.testing.assert_allclose(np.asarray(back(jnp.asarray(ids),
                                               jnp.asarray(pix))),
                               mine, **TOL)


def test_vit_block_matches_jax(models):
    _, jm, tm = models
    w = jm.config.vision_hidden_size
    x = np.random.RandomState(1).standard_normal(
        (2, jm.config.num_patches, w)).astype(np.float32)
    want = np.asarray(jm.visual.blocks[0](jnp.asarray(x)))
    with torch.no_grad():
        got = tm.visual.blocks[0](_t(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_vision_tower_matches_jax(models):
    _, jm, tm = models
    _, pix = _inputs(jm.config)
    want = np.asarray(jm.visual(jnp.asarray(pix)))
    with torch.no_grad():
        got = tm.visual(_t(pix)).numpy()
    assert got.shape == (2, jm.config.num_patches, jm.config.hidden_size)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("s", [1, 5])
def test_cross_attention_matches_jax(models, s):
    """Text queries over the patches: the prefill's Sq = 5 and a decode
    step's Sq = 1."""
    _, jm, tm = models
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, s, jm.config.hidden_size)).astype(np.float32)
    vis = rng.standard_normal((2, jm.config.num_patches,
                               jm.config.hidden_size)).astype(np.float32)
    want = np.asarray(jm.cross[0](jnp.asarray(x), jnp.asarray(vis)))
    with torch.no_grad():
        got = tm.cross[0](_t(x), _t(vis)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got - x).max() > 1e-3          # the gate is open


def test_forward_and_loss_match_jax(models):
    _, jm, tm = models
    ids, pix = _inputs(jm.config, s=9)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -1
    want = np.asarray(jm(jnp.asarray(ids), jnp.asarray(pix)))
    want_loss = float(jm.compute_loss(jnp.asarray(ids), jnp.asarray(pix),
                                      jnp.asarray(labels)))
    with torch.no_grad():
        got = tm(_t(ids), _t(pix)).numpy()
        got_loss = float(tm.compute_loss(_t(ids), _t(pix), _t(labels)))
    np.testing.assert_allclose(got, want, **TOL)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)


def test_cpu_forward_takes_the_plain_routes(models):
    """Every attention of the tower, the decoder and the cross layers goes
    through ``flash_attention``'s plain version on the CPU."""
    _, jm, tm = models
    c = tm.config
    ids, pix = _inputs(c)
    _dispatch.reset_kernel_paths()
    with torch.no_grad():
        tm(_t(ids), _t(pix))
    n_cross = len(tm.cross)
    assert dict(_dispatch.kernel_paths) == {
        ("flash_attention", "plain"): c.vision_layers + c.num_hidden_layers
        + n_cross,
        ("rms_norm", "plain"): 2 * c.num_hidden_layers + n_cross + 1}


@pytest.mark.parametrize("recompute", [False, True],
                         ids=["plain", "recompute"])
def test_compute_loss_grads_match_jax(models, recompute):
    """One step's gradients of every parameter against ``jax.grad`` of the
    reference's ``compute_loss`` (both in training mode; ``recompute``
    checkpoints each decoder block and its cross layer)."""
    name, jm0, _ = models
    jm = _jax_model(dict(CONFIGS[name], recompute=recompute))
    tm = _port_model(jm)
    jm.train()
    tm.train()
    ids, pix = _inputs(jm.config, s=9, seed=7)
    labels = np.roll(ids, -1, axis=1)
    params = jm.trainable_state()

    def jloss(p):
        with bind_params(jm, p):
            return jm.compute_loss(jnp.asarray(ids), jnp.asarray(pix),
                                   jnp.asarray(labels))

    jval, want = jax.value_and_grad(jloss)(params)
    names = [n for n, _ in tm.named_parameters()]
    loss = tm.compute_loss(_t(ids), _t(pix), _t(labels))
    got = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-5)
    assert set(names) == set(want)
    for n, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[n]), **TOL,
                                   err_msg=n)
    for n in ("visual.blocks.0.qkv", "cross.0.kv_proj", "cross.0.gate"):
        assert float(got[names.index(n)].abs().max()) > 0, n


@pytest.mark.parametrize("recompute", [False, True],
                         ids=["plain", "recompute"])
def test_train_step_matches_jax(recompute):
    """3 AdamW steps of ``build_train_step`` from the same weights over the
    same batches (the reference's ``tests/test_breadth_models.py:209``
    batch: ids[:, :-1], the pixels, ids[:, 1:]) against the JAX package's
    train step."""
    jm = _jax_model(dict(recompute=recompute))
    tm = _port_model(jm)
    jm.train()
    tm.train()
    rng = np.random.RandomState(8)
    batches = []
    for _ in range(3):
        ids = rng.randint(0, 256, (4, 17)).astype(np.int32)
        batches.append({"input_ids": ids[:, :-1],
                        "pixel_values": rng.standard_normal(
                            (4, 3, 16, 16)).astype(np.float32),
                        "labels": ids[:, 1:]})
    hcg = jdist.HybridCommunicateGroup(devices=jax.devices()[:1])
    jdist.set_hybrid_group(hcg)
    try:
        step, params, opt_state = jdist.build_train_step(
            jm, JaxAdamW(LR, weight_decay=0.0), hcg=hcg)
        jl = []
        key = jax.random.key(0)
        for i, b in enumerate(batches):
            batch = jdist.shard_batch({k: jnp.asarray(a) for k, a in
                                       b.items()}, hcg)
            loss, params, opt_state = step(params, opt_state, batch,
                                           jax.random.fold_in(key, i))
            jl.append(float(loss))
        jp = jax.tree.map(np.asarray, params)
    finally:
        jdist.set_hybrid_group(None)
    tstep = build_train_step(tm, AdamW(LR, weight_decay=0.0))
    tl = [float(tstep({k: _t(a) for k, a in b.items()})) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    got = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(jp)
    for k in jp:
        np.testing.assert_allclose(got[k], jp[k], **PARAM_TOL, err_msg=k)


# ---- generation ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(eos_token_id=5),
                                dict(num_beams=2),
                                dict(num_beams=4, eos_token_id=5)],
                         ids=["greedy", "greedy-eos", "beam2", "beam4-eos"])
def test_generate_identical_to_jax(models, kw):
    _, jm, tm = models
    ids, pix = _inputs(jm.config)
    want = np.asarray(jm.generate(jnp.asarray(ids), jnp.asarray(pix),
                                  max_new_tokens=6, **kw))
    got = tm.generate(ids, pix, max_new_tokens=6, **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_generate_matches_full_forward(models):
    """Self-attention cache plus per-step cross-attention to the fixed
    features reproduce the full forward (reference
    ``tests/test_generation.py:246``); a second image reuses the
    program, and the image reaches the logits."""
    _, jm, tm = models
    ids, pix = _inputs(jm.config, seed=47)
    n_new = 4
    out = tm.generate(ids, pix, max_new_tokens=n_new).numpy()
    assert out.shape == (2, 5 + n_new)
    for t in range(n_new):
        with torch.no_grad():
            want = tm(_t(out[:, :5 + t]), _t(pix))[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(out[:, 5 + t], want, err_msg=str(t))
    n_entries = len(tm._generate_jit_cache)
    pix2 = (100.0 * np.random.RandomState(3).standard_normal(
        pix.shape)).astype(np.float32)
    out2 = tm.generate(ids, pix2, max_new_tokens=n_new)
    assert out2.shape == (2, 5 + n_new)
    assert len(tm._generate_jit_cache) == n_entries
    with torch.no_grad():
        l1, l2 = tm(_t(ids), _t(pix)), tm(_t(ids), _t(pix2))
    assert float((l1 - l2).abs().max()) > 1e-3


def test_beam_search_tiles_extra_inputs(models):
    """The decode step sees B·K rows, so the vision features are repeated
    K times along the batch (reference ``tests/test_generation.py:477``);
    each beam row holds its own prompt's image."""
    _, jm, tm = models
    ids, pix = _inputs(jm.config, b=2, s=4, seed=55)
    out = tm.generate(ids, pix, max_new_tokens=3, num_beams=2).numpy()
    assert out.shape == (2, 7)
    prog = next(p for k, p in tm._generate_jit_cache.items()
                if k[0] == "beam" and k[1:3] == (2, 4))
    vis = prog.extra["vision"]
    assert vis.shape == (4, jm.config.num_patches, jm.config.hidden_size)
    with torch.no_grad():
        feats = tm.visual(_t(pix))
    assert torch.equal(vis, feats.repeat_interleave(2, dim=0))


def test_new_modules_import_no_jax():
    code = ("import sys, paddle_tpu_torch.models.qwen2_vl, "
            "paddle_tpu_torch.models.generation; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
