"""Common layers of the slice (mirrors ``paddle_tpu/nn/common.py``)."""

from __future__ import annotations

import torch
from torch import nn

from . import functional as F


class RMSNorm(nn.Module):
    """RMSNorm layer with parameter ``weight`` (initialised to ones), as
    ``paddle_tpu.nn.common.RMSNorm`` (:153)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, dtype=None,
                 device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    """LayerNorm layer, as ``paddle_tpu.nn.common.LayerNorm`` (:124):
    ``weight`` (ones) and ``bias`` (zeros) over ``normalized_shape``;
    ``weight_attr=False`` / ``bias_attr=False`` mean no such parameter
    (DiT's AdaLN norms have neither)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, dtype=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(self.normalized_shape, dtype=dtype, device=device)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(self.normalized_shape, dtype=dtype, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)
