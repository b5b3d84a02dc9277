"""Weight-only quantization for serving (mirrors ``paddle_tpu/nn/quant.py``):
``weight_quantize`` / ``weight_dequantize`` / ``weight_only_linear`` /
``llm_int8_linear``, per-output-channel symmetric scales (absmax / 127),
int4 as two nibbles per byte (even rows low nibble, odd rows high).

``weight_only_linear`` routes an int8 (K, N) weight by
:func:`int8_matmul_path`:

  * ``"kernel"`` — a CUDA tensor with ``0 < rows <= 256``, K a multiple
    of 8 and N of 16 (bfloat16 or float16 x: the TMA row stride) or 8
    (float32 x):
    the hand-written weight-only GEMM K4 (``ops/cuda/int8_matmul.py``),
    which streams the int8 bytes and dequantizes in registers (every
    decode-tick projection, every short prefill wave's);
  * ``"dequant"`` — a CUDA tensor of any other shape (a prefill wave's
    thousands of rows): the reference's XLA composition, dequantize
    ``w8.to(dt) * scale.to(dt)`` then one ``torch.matmul``, a plain
    product the reference also leaves outside any kernel;
  * ``"plain"`` — a CPU tensor (or :func:`~paddle_tpu_torch.ops._dispatch.
    reference_mode`): the same composition.

The rule is a shape rule, counted as ``kernel_paths[("int8_matmul",
path)]``; nothing falls through on a kernel error.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import amp
from ..ops import _dispatch
from ..ops.cuda.int8_matmul import MAX_ROWS, N_ALIGN, int8_matmul_cuda

__all__ = ["Int8Weight", "int8_matmul_path", "llm_int8_linear",
           "weight_dequantize", "weight_only_linear", "weight_quantize"]


def int8_matmul_path(x: torch.Tensor, k: int, n: int) -> str:
    """Which route :func:`weight_only_linear` takes for an int8 (K, N)
    weight applied to ``x`` (..., K): ``"kernel"``, ``"dequant"`` or
    ``"plain"`` (see the module docstring).  The K/N alignment is the
    kernel's own limit (TMA's 16-byte strides for bfloat16 and float16
    x, 4-byte weight loads for float32 x), not the TPU's 128."""
    if not _dispatch.use_kernel(x):
        return "plain"
    rows = x.numel() // max(k, 1)
    if (0 < rows <= MAX_ROWS and k % 8 == 0
            and n % N_ALIGN.get(x.dtype, 8) == 0):
        return "kernel"
    return "dequant"


def weight_quantize(x: torch.Tensor, algo: str = "weight_only_int8"):
    """(quantized weight, per-out-channel float32 scale) for a (K, N)
    weight.  int8: (K, N) int8; int4: (ceil(K/2), N) int8 bytes holding two
    nibbles.  An all-zero column gets scale 0 and zeros (divides by 1, not
    0).  Rounding is half-to-even, as ``jnp.round``."""
    xf = x.float()
    scale = xf.abs().amax(dim=0)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    if algo == "weight_only_int8":
        q = torch.round(xf / safe * 127.0).clamp(-127, 127).to(torch.int8)
        return q, scale / 127.0
    if algo == "weight_only_int4":
        q = torch.round(xf / safe * 7.0).clamp(-7, 7).to(torch.int16)
        if q.shape[0] % 2:
            q = torch.cat([q, torch.zeros_like(q[:1])])
        lo = q[0::2] & 0xF
        hi = (q[1::2] & 0xF) << 4
        return (lo | hi).to(torch.uint8).view(torch.int8), scale / 7.0
    raise ValueError(f"unsupported algo {algo!r} (weight_only_int8 / "
                     f"weight_only_int4)")


def _unpack_int4(q: torch.Tensor, k: int) -> torch.Tensor:
    """Undo the nibble packing back to signed (K, N) int8."""
    u = q.view(torch.uint8).to(torch.int16)
    lo, hi = u & 0xF, (u >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    full = torch.stack([lo, hi], 1).reshape(-1, q.shape[-1])
    return full[:k].to(torch.int8)


def weight_dequantize(x: torch.Tensor, scale: torch.Tensor,
                      algo: str = "weight_only_int8",
                      out_dtype=torch.bfloat16,
                      k: Optional[int] = None) -> torch.Tensor:
    """Reconstruct the weight (testing/debug path)."""
    if algo == "weight_only_int4":
        x = _unpack_int4(x, k if k is not None else x.shape[0] * 2)
    return (x.float() * scale).to(out_dtype)


def _dequant_matmul(x, w, scale, weight_dtype):
    """The reference's XLA composition: dequantize in the compute dtype,
    then one product."""
    if weight_dtype == "int4":
        w = _unpack_int4(w, x.shape[-1])
    compute = x.dtype if x.is_floating_point() else torch.bfloat16
    return x @ (w.to(compute) * scale.to(compute))


def weight_only_linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
                       weight_scale: Optional[torch.Tensor] = None,
                       weight_dtype: str = "int8",
                       group_size: int = -1) -> torch.Tensor:
    """``y = x @ dequant(weight) + bias`` (parity:
    ``paddle.nn.quant.weight_only_linear``).  ``weight``: int8 (K, N) or
    int4-packed (K/2, N); ``weight_scale``: (N,) from
    :func:`weight_quantize`.  ``group_size`` is accepted for signature
    parity (per-channel scales only).  Routing: module docstring."""
    if group_size not in (-1, 64, 128):
        raise ValueError("group_size must be -1/64/128")
    if (weight_dtype == "int8" and weight_scale is not None
            and weight.dim() == 2 and weight.dtype == torch.int8
            and x.is_floating_point()):
        k, n = weight.shape
        path = int8_matmul_path(x, k, n)
        _dispatch.count_kernel_path("int8_matmul", path)
        if path == "kernel":
            y = int8_matmul_cuda(x.contiguous(), weight, weight_scale)
            return y if bias is None else y + bias
    y = _dequant_matmul(x, weight, weight_scale, weight_dtype)
    return y if bias is None else y + bias


def llm_int8_linear(x, weight, bias=None, weight_scale=None,
                    threshold: float = 6.0):
    """LLM.int8()-style linear (parity: ``paddle.nn.quant.llm_int8_linear``);
    as in the reference both halves are one product over the dequantised
    weight, so the outlier threshold does not change the result."""
    del threshold
    return weight_only_linear(x, weight, bias=bias, weight_scale=weight_scale)


class Int8Weight(nn.Module):
    """An int8 (K, N) weight with its (N,) float32 per-column scale, held
    as buffers ``w8`` / ``scale`` — what ``models/quantized.py`` puts in
    place of a quantized (K, N) parameter.  ``shape`` is the weight's."""

    def __init__(self, w8: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("w8", w8)
        self.register_buffer("scale", scale)

    @property
    def shape(self):
        return self.w8.shape

    def dequantize(self, dtype) -> torch.Tensor:
        """``w8.to(dtype) * scale.to(dtype)`` — the reference's dequant."""
        return self.w8.to(dtype) * self.scale.to(dtype)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain weight; :func:`weight_only_linear` for an
    :class:`Int8Weight` — the one seam through which the model's
    projections reach the int8 path.  It is also the model's AMP seam
    (the reference's AMP-aware ``matmul``): under an ``amp.auto_cast``
    policy both operands go to the policy's dtype first, and an int8
    weight is dequantized in x's dtype before that, as the reference's
    int8 model dequantizes its weights to the model's dtype and then
    multiplies through ``matmul``."""
    if isinstance(w, Int8Weight):
        if amp.compute_dtype("matmul", x) is None:
            return weight_only_linear(x, w.w8, weight_scale=w.scale)
        w = w.dequantize(x.dtype)
    x, w = amp.cast_inputs("matmul", x, w)
    return x @ w


def embedding(w, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Rows ``ids`` of an embedding table; an :class:`Int8Weight` table is
    gathered first and dequantized after, ``w8[ids].to(dtype) *
    scale.to(dtype)`` — elementwise the reference's dequantize-then-gather."""
    if isinstance(w, Int8Weight):
        return w.w8[ids].to(dtype) * w.scale.to(dtype)
    return w[ids]
