"""Qwen2-VL-style vision-language model (mirrors
``paddle_tpu/models/qwen2_vl.py``, the ``BASELINE.json`` workload
"Qwen2-VL multimodal").

  * **vision tower** (:class:`VisionTower`): patch embedding of the pixel
    values, pre-LN ViT blocks with full attention over the patches
    (:class:`ViTBlock`), a projection into the decoder width;
  * **language decoder**: the port's ``LlamaDecoderLayer`` blocks; every
    ``cross_attn_interval``-th block is followed by a
    :class:`CrossAttention` sub-layer from the text tokens to the vision
    features, gated by ``tanh(gate)`` (zero at init).

Parameter and buffer names and layouts are the reference's (``(in, out)``
matrices applied as ``x @ W``), so ``models/convert.py`` carries a JAX
``state_dict`` across unchanged.

Kernels on this path: the tower's attention is flash-attention (K2, K5 /
K6 under autograd) at ``vision_hidden_size / vision_heads`` (D 64 at the
default widths) and not causal; the cross layers run K2 not causal at the
decoder's head dim over ``num_patches`` keys, with Sq the prompt in
``forward`` and the prefill and Sq = 1 at every decode step; the decoder
runs the Llama path (K2 causal in ``forward`` and the prefill, K1 at the
decode steps); every RMSNorm is K3.  LayerNorm and GELU are plain PyTorch,
as the reference leaves them to XLA.

dtype: the tower casts the pixel values to the model's dtype, so a bf16
model computes its tower in bf16 (K2 at bf16 D 64).  The reference
multiplies float32 pixel values by its bf16 ``patch_proj`` and JAX
promotes the product, and with it the tower, to float32; at float32 the
two are one computation (ROADMAP §C).  On the card every attention kernel
has a float32 build at head_dim 128 (K1, K2 on CUDA-core bodies, K5 /
K6 in three TF32 passes on the tensor cores), so the float32 model at the
default widths runs there, as do
the bf16 model and the tiny float32 one (head_dim 16).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from .. import default_device
from ..nn import functional as F
from ..nn.common import LayerNorm, RMSNorm
from ..nn.quant import embedding, linear
from ..ops import build_rope_cache, flash_attention
from .llama import (_DTYPES, LlamaConfig, LlamaDecoderLayer, causal_lm_loss,
                    pass_writes)

__all__ = ["Qwen2VLConfig", "ViTBlock", "VisionTower", "CrossAttention",
           "Qwen2VLForConditionalGeneration", "tiny_qwen2_vl_config"]


@dataclasses.dataclass
class Qwen2VLConfig:
    # language side
    vocab_size: int = 32000
    hidden_size: int = 1024
    intermediate_size: int = 2816
    num_hidden_layers: int = 4
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    cross_attn_interval: int = 2          # every k-th block cross-attends
    max_position_embeddings: int = 2048
    # vision side
    image_size: int = 224
    patch_size: int = 14
    vision_hidden_size: int = 256
    vision_layers: int = 2
    vision_heads: int = 4
    in_channels: int = 3
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    dtype: str = "float32"
    recompute: bool = False

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{self.dtype!r}")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            initializer_range=self.initializer_range, dtype=self.dtype,
            context_parallel="gspmd")


def tiny_qwen2_vl_config(**overrides) -> Qwen2VLConfig:
    cfg = Qwen2VLConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        cross_attn_interval=1, image_size=16, patch_size=8,
        vision_hidden_size=32, vision_layers=1, vision_heads=2,
        max_position_embeddings=128)
    return dataclasses.replace(cfg, **overrides)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _heads_first(t: torch.Tensor, b: int, n: int, parts: int, heads: int):
    """(B, N, parts * heads * D) -> (parts, B, N, heads, D) in one copy:
    each part contiguous, as the attention kernels take them (the
    reference's ``[:, :, i]`` slices are strided)."""
    return t.reshape(b, n, parts, heads, -1).permute(2, 0, 1, 3, 4) \
        .contiguous()


class ViTBlock(nn.Module):
    """Pre-LN ViT block, full bidirectional attention over patches."""

    def __init__(self, width: int, heads: int, dtype=None, device=None):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(width, dtype=dtype, device=device)
        self.norm2 = LayerNorm(width, dtype=dtype, device=device)
        self.qkv = _param((width, 3 * width), dtype, device)
        self.proj = _param((width, width), dtype, device)
        self.fc1 = _param((width, 4 * width), dtype, device)
        self.fc2 = _param((4 * width, width), dtype, device)

    def forward(self, x):
        b, n, w = x.shape
        qkv = _heads_first(linear(self.norm1(x), self.qkv), b, n, 3,
                           self.heads)
        out = flash_attention(qkv[0], qkv[1], qkv[2], causal=False)
        x = x + linear(out.reshape(b, n, w), self.proj)
        y = F.gelu(linear(self.norm2(x), self.fc1), approximate=True)
        return x + linear(y, self.fc2)


class VisionTower(nn.Module):
    """Patch embed -> ViT blocks -> projection into the decoder width."""

    def __init__(self, c: Qwen2VLConfig, device=None):
        super().__init__()
        self.config = c
        w, p, dt = c.vision_hidden_size, c.patch_size, c.torch_dtype
        self.patch_proj = _param((p * p * c.in_channels, w), dt, device)
        self.pos_embed = _param((c.num_patches, w), dt, device)
        self.blocks = nn.ModuleList([
            ViTBlock(w, c.vision_heads, dtype=dt, device=device)
            for _ in range(c.vision_layers)])
        self.norm = LayerNorm(w, dtype=dt, device=device)
        self.merger = _param((w, c.hidden_size), dt, device)

    def forward(self, pixel_values):
        """(B, C, H, W) -> (B, num_patches, hidden_size), in the weights'
        dtype (the pixels are cast to it first; see the module
        docstring)."""
        c = self.config
        b, ch, hh, ww = pixel_values.shape
        p = c.patch_size
        x = pixel_values.to(self.patch_proj.device, self.norm.weight.dtype)
        x = x.reshape(b, ch, hh // p, p, ww // p, p)
        x = x.permute(0, 2, 4, 3, 5, 1).reshape(
            b, (hh // p) * (ww // p), p * p * ch)
        x = linear(x, self.patch_proj) + self.pos_embed[None]
        for blk in self.blocks:
            x = blk(x)
        return linear(self.norm(x), self.merger)


class CrossAttention(nn.Module):
    """Text queries attend to vision features (bidirectional over the
    feature axis), gated by ``tanh(gate)``."""

    def __init__(self, c: Qwen2VLConfig, device=None):
        super().__init__()
        h, dt = c.hidden_size, c.torch_dtype
        self.heads = c.num_attention_heads
        self.norm = RMSNorm(h, epsilon=c.rms_norm_eps, dtype=dt,
                            device=device)
        self.q_proj = _param((h, h), dt, device)
        self.kv_proj = _param((h, 2 * h), dt, device)
        self.o_proj = _param((h, h), dt, device)
        # zero-init gate: the decoder starts text-only and learns to look
        self.gate = _param((1,), dt, device)

    def forward(self, x, vision):
        """The vision features' K/V are projected at every call (at every
        decode step too), as in the reference."""
        b, s, h = x.shape
        n = vision.shape[1]
        q = linear(self.norm(x), self.q_proj).view(b, s, self.heads, -1)
        kv = _heads_first(linear(vision, self.kv_proj), b, n, 2, self.heads)
        out = flash_attention(q, kv[0], kv[1], causal=False)
        return x + torch.tanh(self.gate) * linear(out.reshape(b, s, h),
                                                  self.o_proj)


class Qwen2VLForConditionalGeneration(nn.Module):
    """Vision tower + cross-attending causal decoder + LM head.

    ``device`` defaults to the card (``paddle_tpu_torch.default_device``:
    raises without CUDA unless ``device="cpu"``).  Weights are drawn from
    N(0, initializer_range) by a ``torch.Generator`` seeded with ``seed``;
    norm weights are ones, LayerNorm biases and the cross gates zeros, as
    the reference initialises them.  Load the reference's weights with
    :func:`paddle_tpu_torch.models.convert.load_jax_state_dict`."""

    def __init__(self, config: Qwen2VLConfig, device=None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        c = config
        dt = c.torch_dtype
        self.config = c
        self.visual = VisionTower(c, device)
        llama_cfg = c.as_llama()
        self.embed_tokens = _param((c.vocab_size, c.hidden_size), dt, device)
        self.layers = nn.ModuleList([LlamaDecoderLayer(llama_cfg, device)
                                     for _ in range(c.num_hidden_layers)])
        self._cross_at = [i for i in range(c.num_hidden_layers)
                          if (i + 1) % c.cross_attn_interval == 0]
        self.cross = nn.ModuleList([CrossAttention(c, device)
                                    for _ in self._cross_at])
        self.norm = RMSNorm(c.hidden_size, epsilon=c.rms_norm_eps, dtype=dt,
                            device=device)
        self.lm_head = _param((c.hidden_size, c.vocab_size), dt, device)
        cos, sin = build_rope_cache(c.max_position_embeddings, c.head_dim,
                                    base=c.rope_theta, device=device)
        self.register_buffer("rope_cos", cos)
        self.register_buffer("rope_sin", sin)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        dev = self.lm_head.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        ones, zeros = set(), set()
        for m in self.modules():
            if isinstance(m, (RMSNorm, LayerNorm)):
                ones.add(id(m.weight))
                if getattr(m, "bias", None) is not None:
                    zeros.add(id(m.bias))
            if isinstance(m, CrossAttention):
                zeros.add(id(m.gate))
        for p in self.parameters():
            if id(p) in ones:
                p.fill_(1.0)
            elif id(p) in zeros:
                p.zero_()
            else:
                p.normal_(0.0, self.config.initializer_range, generator=gen)

    @property
    def dtype(self) -> torch.dtype:
        """The activations' dtype: the weights' (the final norm's, which
        no decode wrapper quantizes), so a ``.float()`` copy computes in
        float32."""
        return self.norm.weight.dtype

    def _cross_layer(self, block_idx: int) -> CrossAttention:
        return self.cross[self._cross_at.index(block_idx)]

    def forward(self, input_ids, pixel_values, position_ids=None):
        """Logits (B, S, vocab).  With ``config.recompute`` and in training
        mode each decoder block and its cross layer run under
        ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``)."""
        c = self.config
        vision = self.visual(pixel_values)
        x = embedding(self.embed_tokens, input_ids.long(), self.dtype)
        rope = (self.rope_cos, self.rope_sin)
        remat = c.recompute and self.training and torch.is_grad_enabled()
        for i, blk in enumerate(self.layers):
            def run(h, vis, blk=blk, i=i):
                h = blk(h, rope, position_ids)
                if i in self._cross_at:
                    h = self._cross_layer(i)(h, vis)
                return h
            if remat:
                x = torch_checkpoint.checkpoint(run, x, vision,
                                                use_reentrant=False)
            else:
                x = run(x, vision)
        return linear(self.norm(x), self.lm_head)

    def compute_loss(self, input_ids, pixel_values, labels,
                     position_ids=None):
        return causal_lm_loss(
            self.forward(input_ids, pixel_values, position_ids), labels)

    # -- cached decode ----------------------------------------------------------

    def decode_step(self, input_ids, cache, pos, vision):
        """(logits, cache).  ``vision``: the tower's features, fixed for a
        whole generation; the cross layers attend the new tokens to them
        at every step (Sq = 1 while decoding), and only the
        self-attention carries the stacked KV cache, updated in place.
        ``pos`` as in ``LlamaModel.decode``: the int 0 for the prefill,
        a (B,) tensor per row for the graph-captured decode steps."""
        x = embedding(self.embed_tokens, input_ids.long(), self.dtype)
        rope = (self.rope_cos, self.rope_sin)
        pos, writes = pass_writes(x, cache, pos)
        for i, blk in enumerate(self.layers):
            x, cache = blk.decode(x, rope, pos, cache, i, writes=writes)
            if i in self._cross_at:
                x = self._cross_layer(i)(x, vision)
        return linear(self.norm(x), self.lm_head), cache

    def generate(self, input_ids, pixel_values, max_new_tokens: int = 32,
                 **kw):
        """Greedy, sampled or beam generation conditioned on an image: the
        vision tower runs once a call, and its features ride every decode
        step as ``extra_inputs`` (beam search repeats them per beam)."""
        from .generation import greedy_generate
        with torch.no_grad():
            vision = self.visual(torch.as_tensor(pixel_values))
        return greedy_generate(self, input_ids, max_new_tokens,
                               extra_inputs={"vision": vision}, **kw)
