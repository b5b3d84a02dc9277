"""Kernels written in CUDA C++ for Hopper (``sm_90a``).

Sources live in ``paddle_tpu_torch/csrc/``; ``_build.py`` compiles them with
``nvcc`` at first use and loads them with ``ctypes``.  Each wrapper checks
device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch failed, and counts its launches in ``.launches``."""

import ctypes

import torch

# element type codes of the C entries
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise NotImplementedError(
            f"{what}: dtype {t.dtype} (the kernel takes bfloat16 or "
            f"float32)") from None


def stream_ptr(device: torch.device) -> int:
    """The current stream's raw handle (the call Triton's launcher makes;
    ``torch.cuda.current_stream`` builds a Stream object, ~15 us a call)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: every tensor must be on one CUDA "
                             f"device (got {t.device})")
        if not t.is_contiguous():
            raise NotImplementedError(f"{what}: tensors must be contiguous")
