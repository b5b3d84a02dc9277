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
own.  The mode is process-wide, not per thread: autograd runs the backward
of CUDA tensors (and with it the recomputation of checkpointed blocks) on
its own device threads, which must route as the caller does.

Every routing decision is counted twice: in :data:`kernel_paths`, a local
tally that a caller resets to read one window (``chip_smoke.py`` reads a
pass), and in the metrics registry as ``ops.kernel_path{op, path}``, as
the reference counts it.  The port counts per call, and ``path`` is
``kernel`` or ``plain``; the reference counts once per trace, and its
``path`` names its own routes.  A captured region counts once per replay:
while :class:`~paddle_tpu_torch.ops.ReplayCounts` records a capture,
decisions go to the tally only (it takes them back out), and each credited
replay adds them to both.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, Tuple

import torch

from .. import observability

_reference = False

# (op, path) -> dispatch decisions since the last reset_kernel_paths()
kernel_paths: Dict[Tuple[str, str], int] = collections.Counter()
# open ReplayCounts.record() windows: decisions there reach the registry
# only through the replays that credit them
_recording = 0


@contextlib.contextmanager
def reference_mode():
    """Route CUDA tensors to the plain PyTorch versions while open.  For
    A/B checks of a kernel against its plain version on the card only."""
    global _reference
    prev = _reference
    _reference = True
    try:
        yield
    finally:
        _reference = prev


def in_reference_mode() -> bool:
    return _reference


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


def _registry_path(op: str, path: str):
    return observability.default_registry().counter(
        "ops.kernel_path",
        "kernel-path selections per op, counted at dispatch time (the "
        "port: once per call, a captured graph once per replay)",
    ).labels(op=op, path=path)


def count_kernel_path(op: str, path: str) -> None:
    """Count one routing decision (``kernel`` or ``plain``) for ``op``."""
    kernel_paths[(op, path)] += 1
    if not _recording:
        _registry_path(op, path).inc()


def credit_kernel_path(op: str, path: str, n: int) -> None:
    """Count ``n`` decisions of one replayed capture (ReplayCounts.add)."""
    kernel_paths[(op, path)] += n
    _registry_path(op, path).inc(n)


def reset_kernel_paths() -> None:
    kernel_paths.clear()
