"""DiT — the diffusion transformer (mirrors ``paddle_tpu/models/dit.py``).

Patchify the latent, run N blocks of AdaLN-Zero-modulated self-attention
over the patch tokens and an MLP, conditioned on (timestep, class)
embeddings, then an AdaLN final layer and unpatchify.  Parameter names
and layouts are the reference's, one to one (``(in, out)`` matrices
applied as ``x @ W``; ``pos_embed`` a float32 buffer), so
``models/convert.py::load_jax_state_dict`` carries a JAX ``state_dict``
across unchanged.

Kernels on this path: the blocks' attention is ``flash_attention(q, k, v,
causal=False)`` over the patch tokens — on the card kernel K2 at head_dim
``hidden / heads`` (DiT-XL/2: 1152 / 16 = 72), on CPU tensors its plain
version.  LayerNorm, GELU and AdaLN modulation are plain PyTorch, as the
reference leaves them to XLA.  Under autograd the attention's backward is
K5 (dq) and K6 (dk, dv) at the same head dim, so the DiT trains on the
card: ``distributed.build_train_step(DiT(...), AdamW(...))`` on
``compute_loss`` batches (``x``, ``t``, ``y``, ``target``), as the
reference trains it with its ordinary train step.  With
``config.recompute`` each block runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``, :236-238): its forward, K2 included, runs
again in the backward.

Dtypes: activations stay in the config's dtype.  The reference's
``bfloat16`` DiT promotes its activations to float32 at its first product
(float32 latents times bf16 ``patch_proj``) and at the float32
``pos_embed``, so its attention runs in float32; PyTorch does not promote
mixed products, and the port casts the latent and ``pos_embed`` to the
model's dtype instead, so a bf16 DiT computes in bf16 (its attention on
K2's Hopper build).  At float32 the two are the same computation.

The mesh ``constrain`` calls of the reference (:150-152, :232) are
single-device no-ops and are dropped (ROADMAP A9/A10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from .. import default_device
from ..nn import functional as F
from ..nn.common import LayerNorm
from ..ops import flash_attention

__all__ = ["DiTConfig", "DiT", "DiTBlock", "FinalLayer", "Mlp",
           "dit_xl_2_config", "modulate", "timestep_embedding",
           "tiny_dit_config"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class DiTConfig:
    input_size: int = 32          # latent H = W
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    learn_sigma: bool = True
    initializer_range: float = 0.02
    dtype: str = "float32"
    recompute: bool = False

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{self.dtype!r}")

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 if self.learn_sigma else 1)

    @property
    def num_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def dit_xl_2_config(**overrides) -> DiTConfig:
    """DiT-XL/2 (the paper's flagship): hidden 1152, 16 heads of 72, depth
    28, 32x32x4 latents in 2x2 patches (256 tokens), 1000 classes."""
    return dataclasses.replace(DiTConfig(), **overrides)


def tiny_dit_config(**overrides) -> DiTConfig:
    cfg = DiTConfig(input_size=8, patch_size=2, in_channels=4,
                    hidden_size=64, depth=2, num_heads=4, num_classes=10)
    return dataclasses.replace(cfg, **overrides)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features (B, dim), float32 (frequency precision
    matters), in the reference's order of operations."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _pos_embed_2d(grid: int, dim: int) -> torch.Tensor:
    """Fixed 2D sin-cos positional embedding (grid * grid, dim), float32
    (the DiT/MAE recipe): the first half of each row encodes the patch's
    row, the second its column."""
    def _1d(pos, d):
        omega = 1.0 / (10000.0 ** (torch.arange(d // 2, dtype=torch.float32)
                                   / (d / 2.0)))
        out = pos[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    coords = torch.arange(grid, dtype=torch.float32)
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    return torch.cat([_1d(yy.reshape(-1), dim // 2),
                      _1d(xx.reshape(-1), dim // 2)], dim=1)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Mlp(nn.Module):
    """``gelu_tanh(x @ fc1 + b1) @ fc2 + b2``."""

    def __init__(self, width: int, hidden: int, out: Optional[int] = None,
                 dtype=None, device=None):
        super().__init__()
        self.fc1 = _param((width, hidden), dtype, device)
        self.b1 = _param((hidden,), dtype, device)
        self.fc2 = _param((hidden, out or width), dtype, device)
        self.b2 = _param((out or width,), dtype, device)

    def forward(self, x):
        return F.gelu(x @ self.fc1 + self.b1, approximate=True) @ self.fc2 \
            + self.b2


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


class DiTBlock(nn.Module):
    """AdaLN-Zero block: modulation regressed from the conditioning vector,
    gates initialised to zero (an identity block at init)."""

    def __init__(self, c: DiTConfig, device=None):
        super().__init__()
        h, dt = c.hidden_size, c.torch_dtype
        self.num_heads = c.num_heads
        self.norm1 = LayerNorm(h, epsilon=1e-6, weight_attr=False,
                               bias_attr=False, dtype=dt, device=device)
        self.norm2 = LayerNorm(h, epsilon=1e-6, weight_attr=False,
                               bias_attr=False, dtype=dt, device=device)
        self.qkv = _param((h, 3 * h), dt, device)
        self.proj = _param((h, h), dt, device)
        self.mlp = Mlp(h, int(h * c.mlp_ratio), dtype=dt, device=device)
        self.ada = _param((h, 6 * h), dt, device)
        self.ada_b = _param((6 * h,), dt, device)

    def forward(self, x, cond):
        b, n, h = x.shape
        mods = F.silu(cond) @ self.ada + self.ada_b
        (shift_a, scale_a, gate_a,
         shift_m, scale_m, gate_m) = mods.chunk(6, dim=-1)
        y = modulate(self.norm1(x), shift_a, scale_a)
        # (3, B, N, H, D) in one copy: q, k and v each contiguous, as the
        # kernel takes them (the reference's qkv[:, :, i] are strided)
        qkv = (y @ self.qkv).reshape(b, n, 3, self.num_heads, -1).permute(
            2, 0, 1, 3, 4).contiguous()
        attn = flash_attention(qkv[0], qkv[1], qkv[2], causal=False)
        x = x + gate_a[:, None] * (attn.reshape(b, n, h) @ self.proj)
        y = modulate(self.norm2(x), shift_m, scale_m)
        return x + gate_m[:, None] * self.mlp(y)


class FinalLayer(nn.Module):
    def __init__(self, c: DiTConfig, device=None):
        super().__init__()
        h, dt = c.hidden_size, c.torch_dtype
        out = c.patch_size * c.patch_size * c.out_channels
        self.norm = LayerNorm(h, epsilon=1e-6, weight_attr=False,
                              bias_attr=False, dtype=dt, device=device)
        self.ada = _param((h, 2 * h), dt, device)
        self.ada_b = _param((2 * h,), dt, device)
        self.linear = _param((h, out), dt, device)

    def forward(self, x, cond):
        mods = F.silu(cond) @ self.ada + self.ada_b
        shift, scale = mods.chunk(2, dim=-1)
        return modulate(self.norm(x), shift, scale) @ self.linear


# parameters the reference initialises to zero (biases; AdaLN-Zero: every
# modulation and the final projection)
_ZERO_INIT = ("b1", "b2", "patch_bias", "ada", "ada_b", "linear")


class DiT(nn.Module):
    """``forward(x, t, y)`` -> predicted noise (+ sigma), (B, out_channels,
    H, W) in the model's dtype; x: (B, C, H, W) latents, t: (B,) timesteps,
    y: (B,) class labels (``num_classes`` = the classifier-free null
    class).

    ``device`` defaults to the card (``paddle_tpu_torch.default_device``:
    raises without CUDA unless ``device="cpu"``).  Weights are the
    reference's init, drawn by a ``torch.Generator`` seeded with ``seed``:
    N(0, initializer_range) for the products and embeddings, zero for the
    biases and (AdaLN-Zero) the modulations and the final projection."""

    def __init__(self, config: DiTConfig, device=None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        c = self.config = config
        h, p, dt = c.hidden_size, c.patch_size, c.torch_dtype
        self.patch_proj = _param((p * p * c.in_channels, h), dt, device)
        self.patch_bias = _param((h,), dt, device)
        self.register_buffer("pos_embed", _pos_embed_2d(
            c.input_size // p, h).to(device))
        self.t_mlp = Mlp(256, h, out=h, dtype=dt, device=device)
        # + 1: the classifier-free null class
        self.y_embed = _param((c.num_classes + 1, h), dt, device)
        self.blocks = nn.ModuleList([DiTBlock(c, device)
                                     for _ in range(c.depth)])
        self.final = FinalLayer(c, device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.patch_proj.device)
        gen.manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1] in _ZERO_INIT:
                p.zero_()
            else:
                p.normal_(0.0, self.config.initializer_range, generator=gen)

    # -- patch plumbing ----------------------------------------------------

    def patchify(self, x):
        b, ch, hh, ww = x.shape
        p = self.config.patch_size
        x = x.reshape(b, ch, hh // p, p, ww // p, p)
        x = x.permute(0, 2, 4, 3, 5, 1)        # (B, H/p, W/p, p, p, C)
        return x.reshape(b, (hh // p) * (ww // p), p * p * ch)

    def unpatchify(self, x):
        c = self.config
        b = x.shape[0]
        p = c.patch_size
        g = c.input_size // p
        x = x.reshape(b, g, g, p, p, c.out_channels)
        x = x.permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, c.out_channels, g * p, g * p)

    def forward(self, x, t, y):
        c = self.config
        dt = self.patch_proj.dtype
        tokens = self.patchify(x.to(dt)) @ self.patch_proj + self.patch_bias
        tokens = tokens + self.pos_embed[None].to(dt)
        cond = self.t_mlp(timestep_embedding(t, 256).to(dt)) \
            + self.y_embed[y.long()]
        for blk in self.blocks:
            if c.recompute and self.training:
                tokens = torch_checkpoint.checkpoint(
                    blk, tokens, cond, use_reentrant=False)
            else:
                tokens = blk(tokens, cond)
        return self.unpatchify(self.final(tokens, cond))

    def compute_loss(self, x, t, y, target):
        """Denoising objective: MSE over the noise channels in float32
        (sigma channels excluded, the paper's simple loss).  ``x`` is the
        noised latent x_t, ``target`` the noise that made it."""
        pred = self.forward(x, t, y)[:, :self.config.in_channels]
        return ((pred.float() - target.float()) ** 2).mean()
