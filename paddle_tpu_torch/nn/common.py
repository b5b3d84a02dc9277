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
