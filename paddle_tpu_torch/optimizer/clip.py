"""Gradient clipping (mirrors ``paddle_tpu/optimizer/clip.py``).

Each class is a callable ``{name: grad} -> {name: grad}``; the squared
norms are taken in float32 and the clipped gradients keep their dtype.
``per_tensor(grads)`` returns the same clip as a function of one gradient
(the global norm taken once, up front), so the optimizer clips each
gradient inside its update loop and no clipped copy of all of them exists.
The reference can reduce the squared norm over mesh axes (``psum_axes``);
that is distributed training (ROADMAP A9/A10) and raises here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "global_norm"]


def _no_psum(psum_axes) -> None:
    if psum_axes:
        raise NotImplementedError(
            "psum_axes: a global norm across devices is distributed "
            "training (ROADMAP A9/A10), not ported")


def global_norm(grads: Dict[str, torch.Tensor],
                psum_axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every gradient, summed in the
    sorted-name order of the reference's ``tree_leaves``."""
    _no_psum(psum_axes)
    sq = sum(torch.sum(torch.square(grads[k].float()))
             for k in sorted(grads))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


class _Clip:
    def per_tensor(self, grads: Dict[str, torch.Tensor]
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
        raise NotImplementedError

    def __call__(self, grads):
        clip = self.per_tensor(grads)
        return {k: clip(g) for k, g in grads.items()}


class ClipGradByGlobalNorm(_Clip):
    def __init__(self, clip_norm: float,
                 psum_axes: Optional[Sequence[str]] = None):
        _no_psum(psum_axes)
        self.clip_norm = float(clip_norm)

    def per_tensor(self, grads):
        norm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return lambda g: (g.float() * scale.to(g.device)).to(g.dtype)


class ClipGradByNorm(_Clip):
    """Per-tensor L2 clip."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def per_tensor(self, grads):
        def clip(g):
            n = torch.sqrt(torch.sum(torch.square(g.float())))
            s = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                            max=1.0)
            return (g.float() * s).to(g.dtype)
        return clip


class ClipGradByValue(_Clip):
    def __init__(self, max_value: float, min_value: Optional[float] = None):
        self.max = float(max_value)
        self.min = float(min_value) if min_value is not None else -self.max

    def per_tensor(self, grads):
        return lambda g: torch.clamp(g, self.min, self.max)
