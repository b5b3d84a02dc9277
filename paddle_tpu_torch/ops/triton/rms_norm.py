"""RMSNorm forward in Triton — kernel K3 of the port.

Replaces ``paddle_tpu/ops/pallas/rms_norm.py::rms_norm_pallas`` (``_kernel``
:32 and ``_kernel_nw`` :41): ``y = x * rsqrt(mean(x^2) + eps) * w`` in
float32, cast to the input dtype; the weight is optional.

Bound on the H100: memory.  The op reads each row once and writes it once
(``2 * rows * D * itemsize`` bytes) and does a handful of float32
operations per element, far below the card's 295 operations per byte.
Design: one program per row with the whole row (D up to 8192) in one
block, so the sum of squares and the scaling happen in one visit — one
read and one write of the row, the single-pass dataflow the Pallas kernel
keeps in VMEM.  Triton's block reduction moves the same bytes a
hand-written CUDA reduction would.

The backward stays the plain math (``ops/norms.py``), as in the reference.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

MAX_D = 8192
_DTYPES = (torch.bfloat16, torch.float16, torch.float32)

tl = None  # triton.language, bound by _kernel() at the first launch


@functools.cache
def _kernel():
    """Import Triton and define the kernel (first launch only)."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def _rms_norm_fwd(x_ptr, w_ptr, y_ptr, D, eps,
                      HAS_W: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        offs = tl.arange(0, BLOCK)
        mask = offs < D
        x = tl.load(x_ptr + row * D + offs, mask=mask,
                    other=0.0).to(tl.float32)
        ms = tl.sum(x * x, axis=0) / D
        y = x * tl.rsqrt(ms + eps)
        if HAS_W:
            w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            y = y * w
        tl.store(y_ptr + row * D + offs, y.to(y_ptr.dtype.element_ty),
                 mask=mask)

    return triton, _rms_norm_fwd


def rms_norm_triton(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                    epsilon: float = 1e-6) -> torch.Tensor:
    """Launch K3 on a CUDA tensor ``x`` (..., D); raises on anything it does
    not take.  Launches on the current stream and does not synchronise."""
    if not x.is_cuda:
        raise ValueError("rms_norm_triton needs a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise NotImplementedError(f"rms_norm kernel: dtype {x.dtype}")
    d = x.shape[-1]
    if x.dim() < 1 or d < 1 or d > MAX_D:
        raise NotImplementedError(
            f"rms_norm kernel: last dim {d} outside [1, {MAX_D}]")
    if not x.is_contiguous():
        raise NotImplementedError("rms_norm kernel: x must be contiguous")
    if weight is not None:
        if weight.shape != (d,) or weight.device != x.device:
            raise NotImplementedError(
                f"rms_norm kernel: weight {tuple(weight.shape)} on "
                f"{weight.device}, want ({d},) on {x.device}")
        if weight.dtype not in _DTYPES or not weight.is_contiguous():
            raise NotImplementedError(
                "rms_norm kernel: weight must be a contiguous float tensor")
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    triton, kernel = _kernel()
    block = triton.next_power_of_2(d)
    kernel[(rows,)](x, weight if weight is not None else x, out, d,
                    float(epsilon), HAS_W=weight is not None, BLOCK=block,
                    num_warps=min(16, max(1, block // 256)))
    rms_norm_triton.launches += 1
    return out


rms_norm_triton.launches = 0
