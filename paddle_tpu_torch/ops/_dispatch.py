"""Kernel routing by tensor device (mirrors ``paddle_tpu/ops/_dispatch.py``).

The JAX package routes by backend and by measured thresholds and falls back
to its XLA path when a kernel refuses a shape.  The port routes by the
device of the tensor it is given, and never falls back:

  * a CPU tensor goes to the kernel's plain PyTorch version;
  * a CUDA tensor goes to the hand-written kernel, whose wrapper launches
    it or raises on a device, dtype, shape or layout it does not take.

The one way to run a plain version on CUDA tensors is to enter
:func:`reference_mode` explicitly — ``chip_smoke.py`` does so to hold each
kernel against its plain version on the card.  Nothing enters it on its
own.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, Tuple

import torch

_STATE = threading.local()

# (op, path) -> dispatch decisions; the JAX package counts the same into
# its metrics registry as ``ops.kernel_path{op=..., path=...}``
kernel_paths: Dict[Tuple[str, str], int] = collections.Counter()


@contextlib.contextmanager
def reference_mode():
    """Route CUDA tensors to the plain PyTorch versions while open.  For
    A/B checks of a kernel against its plain version on the card only."""
    prev = getattr(_STATE, "reference", False)
    _STATE.reference = True
    try:
        yield
    finally:
        _STATE.reference = prev


def in_reference_mode() -> bool:
    return getattr(_STATE, "reference", False)


def use_kernel(x: torch.Tensor) -> bool:
    """True when ``x`` must go to the hand-written kernel: it lies on a
    CUDA device and :func:`reference_mode` is not open.  False for a CPU
    tensor.  Any other device raises."""
    dev = x.device.type
    if dev == "cuda":
        return not in_reference_mode()
    if dev == "cpu":
        return False
    raise NotImplementedError(
        f"paddle_tpu_torch kernels run on cuda or cpu tensors, not {dev}")


def count_kernel_path(op: str, path: str) -> None:
    """Count one routing decision (``kernel`` or ``plain``) for ``op``."""
    kernel_paths[(op, path)] += 1


def reset_kernel_paths() -> None:
    kernel_paths.clear()
