"""Functional layer ops of the slice (mirrors ``paddle_tpu/nn/functional.py``
``silu`` :77, ``swiglu`` :109, ``rms_norm`` :169)."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import rms_norm as _rms_norm_op


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
