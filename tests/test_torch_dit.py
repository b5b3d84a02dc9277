"""The port's DiT sampling path against the JAX package, on the CPU.

One seeded numpy state feeds both packages, in float32: the plain version
of K2 (``flash_attention_reference``) at DiT's head dims 72 and 64 against
the Pallas kernel in interpret mode; LayerNorm, tanh-GELU, the timestep
and 2-D positional embeddings; the tiny DiT (head_dim 16) and a narrow
DiT at head_dim 72 (DiT-XL/2's), weights perturbed off AdaLN-Zero and
carried across by ``load_jax_state_dict``; the DDIM schedule tables and
``ddim_sample`` from a shared ``x_init`` with and without guidance.  Noise
streams cannot be shared between the libraries, so samples drawn from
noise (``x_init=None``, ``eta=1``) are held to their known moments.  Also
here: the sampler's build-once contract (watchdog site ``diffusion.ddim``),
the CPU route, and the head dims of the contiguous K2 and of K5 / K6
(one set) against the builds that stay at 128 (K2-paged, K1: ROADMAP
B2).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import diffusion as jdiff
from paddle_tpu.models import dit as jdit
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas.flash_attention import flash_attention_pallas

from paddle_tpu_torch.models import (DiT, ddim_sample, ddim_timesteps,
                                     diffusion_schedule, load_jax_state_dict,
                                     tiny_dit_config)
from paddle_tpu_torch.models import dit as tdit
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.observability import watchdog
from paddle_tpu_torch.ops import (_dispatch, cached_decode_attention,
                                  flash_attention, flash_attention_reference)
from paddle_tpu_torch.ops import cuda as pt_cuda
from paddle_tpu_torch.ops.attention import FlashAttention
from paddle_tpu_torch.ops.cuda import decode_attention as k1
from paddle_tpu_torch.ops.cuda import flash_attention as k2
from paddle_tpu_torch.ops.cuda import flash_attention_bwd as k56

REPO = Path(__file__).resolve().parents[1]
# float32 on both sides, sums in other orders: a few ulps of O(1) values
TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- K2's plain version at DiT's head dims vs the Pallas kernel -------------

FLASH_CASES = [
    # (b, sq, skv, hq, hkv, d, causal)
    (2, 256, 256, 4, 4, 72, False),    # DiT's: full attention, MHA
    (1, 128, 256, 4, 2, 72, True),     # GQA, Sq < Skv (bottom-right)
    (1, 256, 128, 4, 1, 72, True),     # Sq > Skv: rows 0..127 see nothing
    (2, 128, 128, 4, 4, 64, False),
    (1, 256, 256, 4, 2, 64, True),
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", FLASH_CASES)
def test_flash_plain_matches_pallas_at_dit_head_dims(b, sq, skv, hq, hkv, d,
                                                     causal):
    q, k, v = (_rand((b, sq, hq, d), 21), _rand((b, skv, hkv, d), 22),
               _rand((b, skv, hkv, d), 23))
    jout, jlse = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        interpret=True)
    out, lse = flash_attention_reference(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    if causal and sq > skv:
        dead = sq - skv
        assert torch.equal(out[:, :dead], torch.zeros_like(out[:, :dead]))
        assert bool((lse[:, :, :dead] == -1e30).all())


# ---- the layer ops ------------------------------------------------------------

@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm_matches_jax(affine):
    x = _rand((3, 5, 72), 1) * 3.0 + 0.5
    w = _rand((72,), 2) if affine else None
    b = _rand((72,), 3) if affine else None
    want = JF.layer_norm(jnp.asarray(x), (72,),
                         None if w is None else jnp.asarray(w),
                         None if b is None else jnp.asarray(b), 1e-6)
    got = TF.layer_norm(_t(x), (72,), None if w is None else _t(w),
                        None if b is None else _t(b), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layer_norm_layer_and_bf16_round_trip():
    """``weight_attr=False`` / ``bias_attr=False`` mean no parameter; a
    bf16 input is normalised in float32 and cast back."""
    ln = LayerNorm(16, epsilon=1e-6, weight_attr=False, bias_attr=False)
    assert ln.weight is None and ln.bias is None
    assert list(ln.state_dict()) == []
    assert sorted(LayerNorm(16).state_dict()) == ["bias", "weight"]
    x = _t(_rand((4, 16), 4)).bfloat16()
    got = ln(x)
    assert got.dtype == torch.bfloat16
    want = TF.layer_norm(x.float(), None, None, None, 1e-6).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_matches_jax(approximate):
    x = _rand((1000,), 5) * 4.0
    want = JF.gelu(jnp.asarray(x), approximate=approximate)
    got = TF.gelu(_t(x), approximate=approximate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_timestep_embedding_matches_jax():
    """Arguments reach 999 radians, whose float32 ulp is 6e-5: sin / cos
    of the same float32 argument differ in the last bits between the
    libraries, hence the absolute tolerance."""
    t = np.array([0, 1, 17, 250, 500, 998, 999], np.int32)
    want = jdit.timestep_embedding(jnp.asarray(t), 256)
    got = tdit.timestep_embedding(_t(t), 256)
    assert got.dtype == torch.float32 and got.shape == (7, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("grid,dim", [(4, 64), (16, 1152)])
def test_pos_embed_2d_matches_jax(grid, dim):
    want = jdit._pos_embed_2d(grid, dim)
    got = tdit._pos_embed_2d(grid, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---- the model --------------------------------------------------------------

# the tiny DiT (head_dim 16) and a narrow one at DiT-XL/2's head_dim 72
CONFIGS = {"tiny": {}, "d72": dict(hidden_size=144, num_heads=2)}


def _perturbed(kw):
    """A JAX DiT whose weights are moved off AdaLN-Zero (every gate and
    the final projection nonzero, so attention reaches the output), and
    the port's DiT loaded from its ``state_dict``."""
    pt.seed(0)
    jm = jdit.DiT(jdit.tiny_dit_config(**kw))
    jm.eval()
    rng = np.random.RandomState(0)
    noisy = {k: jnp.asarray(np.asarray(v) + 0.02 * rng.standard_normal(
        v.shape).astype(np.float32)) for k, v in jm.state_dict().items()}
    jm.set_state_dict(noisy, strict=False)
    tm = DiT(tiny_dit_config(**kw), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v) for k, v in jm.state_dict(
        include_buffers=True).items()})
    return jm, tm


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    return _perturbed(CONFIGS[request.param])


def test_head_dims_of_the_configs():
    assert tiny_dit_config(**CONFIGS["d72"]).head_dim == 72
    assert tdit.dit_xl_2_config().head_dim == 72
    assert tiny_dit_config().head_dim == 16


def test_parameter_names_are_the_references():
    pt.seed(0)
    jm = jdit.DiT(jdit.tiny_dit_config())
    tm = DiT(tiny_dit_config(), device="cpu")
    want = {k: tuple(v.shape)
            for k, v in jm.state_dict(include_buffers=True).items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want


def test_init_is_adaln_zero():
    """The reference's init: modulations, biases and the final projection
    zero, so a fresh DiT predicts exactly zero."""
    tm = DiT(tiny_dit_config(), device="cpu", seed=3)
    sd = tm.state_dict()
    for name in ("blocks.0.ada", "blocks.1.ada_b", "final.linear",
                 "t_mlp.b1", "patch_bias"):
        assert not sd[name].any(), name
    assert float(sd["blocks.0.qkv"].std()) == pytest.approx(0.02, rel=0.1)
    x = _t(_rand((2, 4, 8, 8), 6))
    with torch.no_grad():
        out = tm(x, torch.tensor([5, 900]), torch.tensor([1, 10]))
    assert out.shape == (2, 8, 8, 8) and not out.any()


def test_forward_matches_jax(models):
    jm, tm = models
    x = _rand((3, 4, 8, 8), 7)
    t = np.array([3, 500, 999], np.int32)
    y = np.array([0, 5, 10], np.int32)          # 10: the null class
    want = np.asarray(jm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    with torch.no_grad():
        got = tm(_t(x), _t(t), _t(y))
    assert got.shape == want.shape == (3, 8, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_compute_loss_matches_jax(models):
    jm, tm = models
    x, target = _rand((2, 4, 8, 8), 8), _rand((2, 4, 8, 8), 9)
    t, y = np.array([10, 700], np.int32), np.array([2, 3], np.int32)
    want = float(jm.compute_loss(jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(y), jnp.asarray(target)))
    with torch.no_grad():
        got = float(tm.compute_loss(_t(x), _t(t), _t(y), _t(target)))
    assert got == pytest.approx(want, rel=1e-5)


def test_cpu_forward_takes_the_plain_route(models):
    _, tm = models
    _dispatch.reset_kernel_paths()
    with torch.no_grad():
        tm(_t(_rand((2, 4, 8, 8), 10)), torch.tensor([1, 2]),
           torch.tensor([3, 4]))
    assert dict(_dispatch.kernel_paths) == {
        ("flash_attention", "plain"): tm.config.depth}


# ---- the sampler ----------------------------------------------------------------

def test_schedule_matches_jax():
    """``ts`` equal index for index (ties of the rounding decided as XLA's
    float32 linspace decides them: step counts 19 and 37 have some);
    alpha-bar at rtol 1e-6 (the cumulative products' order may differ)."""
    np.testing.assert_allclose(diffusion_schedule().numpy(),
                               np.asarray(jdiff.diffusion_schedule()),
                               rtol=1e-6, atol=0)
    for steps in (1, 2, 8, 19, 25, 37, 50, 100, 250, 300):
        want = np.asarray(jnp.linspace(999, 0, steps).round()
                          .astype(jnp.int32))
        assert ddim_timesteps(steps).tolist() == want.tolist(), steps


@pytest.mark.parametrize("cfg_scale", [1.0, 4.0])
def test_ddim_sample_matches_jax(models, cfg_scale):
    """From one ``x_init`` at eta 0, 8 steps.  The random model's latents
    grow to O(600) (x0 = x / sqrt(alpha-bar) at t = 999); the difference
    is held to 1e-5 of the largest |latent|."""
    jm, tm = models
    y = [1, 7]
    x_init = _rand((2, 4, 8, 8), 11)
    want = np.asarray(jdiff.ddim_sample(jm, jnp.asarray(y, jnp.int32),
                                        steps=8, cfg_scale=cfg_scale,
                                        x_init=jnp.asarray(x_init)))
    got = ddim_sample(tm, y, steps=8, cfg_scale=cfg_scale,
                      x_init=_t(x_init))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def _eps_free_variance(steps, eta):
    """Per-element variance of a sample from N(0, 1) noise when the model
    predicts eps = 0 (the AdaLN-Zero init): each step is x <- sqrt(a_n /
    a_t) x + sigma * noise."""
    acp = np.asarray(jdiff.diffusion_schedule(), np.float64)
    ts = np.asarray(jnp.linspace(999, 0, steps).round().astype(jnp.int32))
    a_t = acp[ts]
    a_n = np.concatenate([acp[ts[1:]], [1.0]])
    var = 1.0
    for at, an in zip(a_t, a_n):
        sig2 = eta ** 2 * (1 - an) / (1 - at) * max(1 - at / an, 0.0)
        var = an / at * var + sig2
    return var


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_samples_from_noise_by_moments(eta):
    """``x_init=None`` and ``eta=1`` draw from the model device's seeded
    generator, which JAX's cannot reproduce: both libraries' samples over
    8 seeds x 4 rows x 256 elements (8192 draws) are held to the moments
    the zero-init model implies, mean 0 and the variance of
    :func:`_eps_free_variance` (4 standard errors: 0.044 on the mean
    over sqrt(var), 6.3 % on the variance)."""
    pt.seed(0)
    jm = jdit.DiT(jdit.tiny_dit_config())
    tm = DiT(tiny_dit_config(), device="cpu")
    var = _eps_free_variance(4, eta)
    y = [0, 1, 2, 3]
    for draw in ("port", "jax"):
        xs = []
        for seed in range(8):
            if draw == "port":
                xs.append(ddim_sample(tm, y, steps=4, eta=eta,
                                      seed=seed).numpy())
            else:
                xs.append(np.asarray(jdiff.ddim_sample(
                    jm, jnp.asarray(y, jnp.int32), steps=4, eta=eta,
                    seed=seed)))
        z = np.stack(xs).astype(np.float64) / np.sqrt(var)
        assert z.shape == (8, 4, 4, 8, 8)
        assert abs(z.mean()) < 4 / np.sqrt(z.size), draw
        assert abs(z.var() / 1.0 - 1.0) < 4 * np.sqrt(2 / z.size), draw
    # the port's eta = 0 sample is the deterministic map of its own noise
    if eta == 0.0:
        gen = torch.Generator().manual_seed(5)
        z0 = torch.randn((4, 4, 8, 8), generator=gen)
        assert torch.equal(ddim_sample(tm, y, steps=4, seed=5),
                           ddim_sample(tm, y, steps=4, x_init=z0))


def test_sampler_is_built_once_per_key():
    """One build (watchdog site ``diffusion.ddim``, budget 1) a (b, steps,
    cfg_scale, eta, T, from_noise) key, cached on the model as the
    reference caches its jitted reverse process; a second call of the
    same key builds nothing, a new key builds its own."""
    tm = DiT(tiny_dit_config(), device="cpu")
    y = [1, 2]
    x_init = _t(_rand((2, 4, 8, 8), 12))
    a = ddim_sample(tm, y, steps=3, cfg_scale=4.0, x_init=x_init)
    (key, sampler), = tm._ddim_jit_cache.items()
    assert key == (2, 3, 4.0, 0.0, 1000, False)
    assert sampler.traces == 1 and not sampler.graphed
    b = ddim_sample(tm, [3, 4], steps=3, cfg_scale=4.0, x_init=x_init + 1)
    assert tm._ddim_jit_cache[key] is sampler and sampler.traces == 1
    assert not torch.equal(a, b)
    assert torch.equal(a, ddim_sample(tm, y, steps=3, cfg_scale=4.0,
                                      x_init=x_init))
    ddim_sample(tm, y, steps=3, cfg_scale=4.0)      # from noise: a new key
    assert len(tm._ddim_jit_cache) == 2 and sampler.traces == 1
    builds = [n for (site, _), n in watchdog._counts.items()
              if site == "diffusion.ddim"]
    assert builds and max(builds) == 1


# ---- K2 / K5 / K6's head dims and the builds at 128 (ROADMAP B2) -------------

class _FakeLib:
    """Stands in for the built library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def no_card(monkeypatch):
    """The wrappers' checks on CPU tensors: the device check passes, and a
    launch reaches a fake library."""
    lib = _FakeLib()
    monkeypatch.setattr(pt_cuda, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(k56, "require_cuda", lambda what, *t: None)
    for mod in (k1, k2, k56):
        monkeypatch.setattr(mod, "_lib", lambda: lib)
        monkeypatch.setattr(mod, "stream_ptr", lambda device: 0)
    return lib


def _qkv(d, dtype, hq=4, hkv=2, s=8):
    return (torch.zeros(1, s, hq, d, dtype=dtype),
            torch.zeros(1, s, hkv, d, dtype=dtype),
            torch.zeros(1, s, hkv, d, dtype=dtype))


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 72),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 16),
                                     (torch.float32, 64),
                                     (torch.float32, 72)])
def test_contiguous_k2_takes_the_head_dims(no_card, dtype, d):
    out, lse = k2.flash_attention_fwd_cuda(*_qkv(d, dtype))
    (name, args), = no_card.calls
    assert name == "flash_attention_fwd"
    # ... B Sq Skv Hq Hkv D scale causal dtype stream
    assert args[9:15] == (1, 8, 8, 4, 2, d)
    assert args[15] == pytest.approx(d ** -0.5)
    assert out.shape == (1, 8, 4, d) and lse.shape == (1, 4, 8)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 76),
                                     (torch.bfloat16, 136),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 32),
                                     (torch.float32, 128)])
def test_contiguous_k2_refuses_other_head_dims(no_card, dtype, d):
    with pytest.raises(NotImplementedError, match="B2"):
        k2.flash_attention_fwd_cuda(*_qkv(d, dtype))
    assert no_card.calls == []


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 72),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 72)])
def test_builds_at_one_head_dim_refuse_dit_head_dims(no_card, dtype, d):
    """K2-paged(-int8) and the K1 family are built at 128 (bf16) / 16
    (float32) only: each refuses DiT's head dims naming B2.  (K5 / K6
    take them: ``test_k5_k6_take_k2s_head_dims``.)"""
    q, k, v = _qkv(d, dtype, s=1)
    pool = torch.zeros(4, 64, 2, d, dtype=dtype)
    pool8 = torch.zeros(4, 64, 2, d, dtype=torch.int8)
    sc = torch.ones(4, 2)
    tbl = torch.zeros(1, 2, dtype=torch.int32)
    cache = torch.zeros(1, 128, 2, d, dtype=dtype)
    cache8 = torch.zeros(1, 128, 2, d, dtype=torch.int8)
    calls = [
        lambda: k2.flash_attention_fwd_paged_cuda(q, pool, pool, 0, tbl),
        lambda: k2.flash_attention_fwd_paged_int8_cuda(q, pool8, pool8, 0,
                                                       tbl, sc, sc),
        lambda: k1.decode_attention_cuda(q, cache, cache, 0),
        lambda: k1.decode_attention_int8_cuda(q, cache8, cache8, 0,
                                              k_scale=torch.ones(1, 1, 2),
                                              v_scale=torch.ones(1, 1, 2)),
        lambda: k1.decode_attention_paged_cuda(q, pool, pool, 0, tbl),
        lambda: k1.decode_attention_paged_int8_cuda(q, pool8, pool8, 0, tbl,
                                                    k_scale=sc, v_scale=sc),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="B2"):
            call()
    assert no_card.calls == []


# K5 / K6 take K2's head dims (``FWD_HEAD_DIMS``), and nothing else
BWD_TAKES = [(torch.bfloat16, 8), (torch.bfloat16, 40), (torch.bfloat16, 64),
             (torch.bfloat16, 72), (torch.bfloat16, 120),
             (torch.bfloat16, 128), (torch.float32, 16), (torch.float32, 64),
             (torch.float32, 72)]
BWD_REFUSES = {torch.bfloat16: (76, 136), torch.float32: (32, 128)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_refuses_dit_head_dim_in_the_forward(no_card, dtype):
    """Under autograd ``FlashAttention`` takes DiT's head dims 72 and 64
    forward and backward (K2, then K5 and K6 at the same head_dim); a head
    dim outside K2's set is refused in the forward, naming B2, before any
    launch."""
    for d in (72, 64):
        no_card.calls.clear()
        q, k, v = (t.requires_grad_(True) for t in _qkv(d, dtype))
        out, lse = FlashAttention.apply(q, k, v, None, None, False, None)
        torch.autograd.grad((out * 0).sum() + (lse * 0).sum(), (q, k, v))
        assert [n for n, _ in no_card.calls] == [
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv"]
        # B Sq Skv Hq Hkv D of each launch (after 9, 11, 12 pointers)
        (_, fwd), (_, dq), (_, dkv) = no_card.calls
        assert fwd[9:15] == dq[11:17] == dkv[12:18] == (1, 8, 8, 4, 2, d)
    no_card.calls.clear()
    for d in BWD_REFUSES[dtype]:
        q, k, v = (t.requires_grad_(True) for t in _qkv(d, dtype))
        with pytest.raises(NotImplementedError, match="B2"):
            FlashAttention.apply(q, k, v, None, None, False, None)
    assert no_card.calls == []


@pytest.mark.parametrize("dtype,d", BWD_TAKES)
def test_k5_k6_take_k2s_head_dims(no_card, dtype, d):
    """K5 and K6 launch at every head dim K2 takes, D passed through."""
    q, k, v = _qkv(d, dtype)
    lse = torch.zeros(1, 4, 8)
    dq = k56.flash_attention_bwd_dq_cuda(q, k, v, q, lse, lse)
    dk, dv = k56.flash_attention_bwd_dkv_cuda(q, k, v, q, lse, lse)
    (n1, a1), (n2, a2) = no_card.calls
    assert (n1, n2) == ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    # dq: 11 pointers, then B Sq Skv Hq Hkv D; dkv: 12 pointers
    assert a1[11:17] == a2[12:18] == (1, 8, 8, 4, 2, d)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert d in k2.FWD_HEAD_DIMS[dtype]


@pytest.mark.parametrize("dtype,d", [(t, d) for t, ds in BWD_REFUSES.items()
                                     for d in ds] + [(torch.bfloat16, 256)])
def test_k5_k6_refuse_other_head_dims(no_card, dtype, d):
    q, k, v = _qkv(d, dtype)
    lse = torch.zeros(1, 4, 8)
    for fn in (k56.flash_attention_bwd_dq_cuda,
               k56.flash_attention_bwd_dkv_cuda):
        with pytest.raises(NotImplementedError, match="B2"):
            fn(q, k, v, q, lse, lse)
    assert no_card.calls == []


def test_sampler_rebuilds_over_moved_weights():
    """A sampler's graph reads the weights where they lived at its build:
    once the parameters have new storage (``.to(dtype)`` and back, here a
    clone), the next call drops it and builds anew (ROADMAP C2); the
    latents are unchanged."""
    tm = DiT(tiny_dit_config(), device="cpu")
    x_init = _t(_rand((2, 4, 8, 8), 12))
    a = ddim_sample(tm, [1, 2], steps=3, x_init=x_init)
    (old,) = tm._ddim_jit_cache.values()
    held = [p.data for p in tm.parameters()]      # no pointer is reused
    for p in tm.parameters():
        p.data = p.data.clone()
    b = ddim_sample(tm, [1, 2], steps=3, x_init=x_init)
    (new,) = tm._ddim_jit_cache.values()
    assert new is not old and new.traces == 1 and old.traces == 1
    assert torch.equal(a, b)
    del held


def test_new_modules_import_no_jax():
    code = ("import sys, paddle_tpu_torch.models.dit, "
            "paddle_tpu_torch.models.diffusion, paddle_tpu_torch.nn; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cpu_decode_attention_still_plain_at_head_dim_72():
    """The plain versions take any head_dim: only the card's builds are
    per head_dim."""
    q = _t(_rand((1, 1, 2, 72), 13))
    kv = _t(_rand((1, 8, 2, 72), 14))
    out = cached_decode_attention(q, kv, kv, 3)
    assert out.shape == (1, 1, 2, 72) and bool(torch.isfinite(out).all())
    assert flash_attention(q, kv, kv).shape == (1, 1, 2, 72)
