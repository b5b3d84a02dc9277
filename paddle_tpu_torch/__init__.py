"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package (``paddle_tpu``) is the reference; this package mirrors its
module names (``ops.attention``, ``models.llama``, ``serving.engine``, ...)
so each piece can be found beside its counterpart.  Plain tensor code is
PyTorch; every kernel the JAX package writes in Pallas for the TPU is a
kernel written by hand for Hopper (CUDA C++ under ``csrc/``, or Triton),
built from this package's sources at first use.

Rules of the package:

  * it never imports ``jax`` nor anything of ``paddle_tpu``;
  * entry points take ``device=`` and default to ``"cuda"``; without a CUDA
    device they raise unless the caller asks for ``device="cpu"`` — the
    package never drops to the CPU on its own;
  * a CUDA tensor goes to the hand-written kernel or raises; a CPU tensor
    goes to the kernel's plain PyTorch version (``ops/_dispatch.py``).

Precision: importing the package turns TF32 off for float32 matmuls and
cuDNN convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set to False below), so float32
products on the card keep full float32 precision, as the reference does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

# float32 products in full float32 on the card (see the module docstring)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: ``cuda`` when a CUDA device is present, else
    a ``RuntimeError`` — a caller who wants the CPU says so with
    ``device="cpu"``.  An explicit CUDA device without CUDA also raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"paddle_tpu_torch: device {dev} requested but no CUDA device "
            f"is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"paddle_tpu_torch runs on cuda or cpu, not {dev}")
    return dev


__all__ = ["__version__", "default_device"]
