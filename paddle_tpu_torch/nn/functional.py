"""Functional layer ops of the slice (mirrors ``paddle_tpu/nn/functional.py``
``gelu`` :73, ``silu`` :77, ``swiglu`` :109, ``layer_norm`` :153,
``rms_norm`` :169)."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import rms_norm as _rms_norm_op


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU; ``approximate=True`` is the tanh form (DiT's MLPs), as
    ``jax.nn.gelu``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


def swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SwiGLU gate (parity: paddle.incubate.nn.functional.swiglu — the
    Llama MLP's).  With one argument, splits it in half."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return silu(x) * y


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm (parity: paddle.incubate.nn.functional.fused_rms_norm)."""
    return _rms_norm_op(x, weight, epsilon)


def layer_norm(x: torch.Tensor, normalized_shape=None,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` dims (default: the
    last), computed in float32 whatever the input dtype and cast back, as
    the reference's (which XLA computes; no kernel stands behind it)."""
    dt = x.dtype
    xf = x.float()
    n = len(normalized_shape) if normalized_shape else 1
    dims = tuple(range(x.dim() - n, x.dim()))
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)
