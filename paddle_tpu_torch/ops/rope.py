"""Rotary position embedding (mirrors ``paddle_tpu/ops/rope.py``).

NeoX/Llama half-rotation: head_dim splits into halves rather than
interleaved pairs; inputs are (batch, seq, heads, head_dim).  The cos/sin
caches are float32 and the rotation runs in float32, cast back to the input
dtype.  No kernel: the rotation is elementwise work PyTorch runs as it is,
as XLA fused it in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def build_rope_cache(seq_len: int, head_dim: int, base: float = 10000.0,
                     scaling_factor: float = 1.0,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin caches of shape (seq_len, head_dim // 2)."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32,
                                            device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32,
                     device=device) / scaling_factor
    freqs = torch.outer(t, inv_freq)  # (S, D/2)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate (B, S, H, D) by cos/sin caches (S_cache, D/2).
    ``position_ids``: (B, S) or (1, S) int positions; None means 0..S-1."""
    dt = x.dtype
    if position_ids is not None:
        cos = cos[position_ids][:, :, None, :]   # (B, S, 1, D/2)
        sin = sin[position_ids][:, :, None, :]
    else:
        s = x.shape[1]
        cos = cos[None, :s, None, :]
        sin = sin[None, :s, None, :]
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(dt)


def fused_rope(q, k, cos, sin, position_ids=None):
    """Apply RoPE to q and k (the reference's fused_rope signature)."""
    return (apply_rope(q, cos, sin, position_ids),
            apply_rope(k, cos, sin, position_ids))
