"""RMSNorm — plain PyTorch version + dispatch to the Triton kernel
(mirrors ``paddle_tpu/ops/norms.py``).

The reference routes RMSNorm away from its Pallas kernel by default
(``FLAGS_rms_norm_pallas_min_dim``), a threshold measured on a TPU.  The
port routes every CUDA tensor to its kernel (``ops/triton/rms_norm.py``);
the H100 numbers for that choice are in PERF.md.  Gradients take the plain
math, as in the reference's ``custom_vjp``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _dispatch
from .triton.rms_norm import rms_norm_triton


def rms_norm_reference(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                       epsilon: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + epsilon)
    if weight is not None:
        y = y * weight.float()
    return y.to(dt)


class _RmsNormKernel(torch.autograd.Function):
    """Kernel forward, plain-math backward (the reference's custom_vjp)."""

    @staticmethod
    def forward(ctx, x, weight, epsilon):
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        return rms_norm_triton(x, weight, epsilon)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            wd = (weight.detach().requires_grad_(True)
                  if weight is not None else None)
            y = rms_norm_reference(xd, wd, ctx.epsilon)
            inputs = (xd,) if wd is None else (xd, wd)
            grads = torch.autograd.grad(y, inputs, g)
        gw = grads[1] if wd is not None else None
        return grads[0], gw, None


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """Public entry (parity: fused_rms_norm).  A CUDA tensor goes to the
    Triton kernel (or raises), a CPU tensor to the plain version."""
    if _dispatch.use_kernel(x):
        _dispatch.count_kernel_path("rms_norm", "kernel")
        if torch.is_grad_enabled() and (
                x.requires_grad
                or (weight is not None and weight.requires_grad)):
            return _RmsNormKernel.apply(x, weight, epsilon)
        return rms_norm_triton(x, weight, epsilon)
    _dispatch.count_kernel_path("rms_norm", "plain")
    return rms_norm_reference(x, weight, epsilon)
