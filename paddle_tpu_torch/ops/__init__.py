"""Operators of the port (mirrors ``paddle_tpu/ops``)."""

import collections
import contextlib
from typing import Dict, Tuple

from . import _dispatch
from .attention import (FlashAttention, cache_mask, cached_decode_attention,
                        cached_decode_attention_reference, flash_attention,
                        flash_attention_bwd_reference,
                        flash_attention_reference, segment_mask)
from .cuda.decode_attention import (decode_attention_cuda,
                                   decode_attention_int8_cuda,
                                   decode_attention_paged_cuda,
                                   decode_attention_paged_int8_cuda)
from .cuda.flash_attention import (flash_attention_fwd_cuda,
                                   flash_attention_fwd_paged_cuda,
                                   flash_attention_fwd_paged_int8_cuda)
from .cuda.flash_attention_bwd import (flash_attention_bwd_dkv_cuda,
                                       flash_attention_bwd_dq_cuda)
from .cuda.int8_matmul import int8_matmul_cuda, int8_matmul_reference
from .norms import rms_norm, rms_norm_reference
from .rope import apply_rope, build_rope_cache, fused_rope
from .triton.rms_norm import rms_norm_triton

# every hand-written kernel of the port: name -> wrapper (each wrapper
# counts its launches in ``.launches``; K2, K5 and K6 also in
# ``.by_shape``, a Counter keyed by (head_dim, Sq, Skv, causal))
KERNELS = {
    "decode_attention": decode_attention_cuda,
    "flash_attention_fwd": flash_attention_fwd_cuda,
    "rms_norm": rms_norm_triton,
    "decode_attention_paged": decode_attention_paged_cuda,
    "flash_attention_fwd_paged": flash_attention_fwd_paged_cuda,
    "decode_attention_int8": decode_attention_int8_cuda,
    "decode_attention_paged_int8": decode_attention_paged_int8_cuda,
    "flash_attention_fwd_paged_int8": flash_attention_fwd_paged_int8_cuda,
    "int8_matmul": int8_matmul_cuda,
    "flash_attention_bwd_dq": flash_attention_bwd_dq_cuda,
    "flash_attention_bwd_dkv": flash_attention_bwd_dkv_cuda,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "by_shape"):
            fn.by_shape.clear()


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def shape_counts() -> Dict[tuple, int]:
    """{(name, head_dim, Sq, Skv, causal): launches} of the wrappers that
    count by shape."""
    return {(name, *key): n for name, fn in KERNELS.items()
            for key, n in getattr(fn, "by_shape", {}).items() if n}


class ReplayCounts:
    """The launches and routing decisions of one run of a captured region
    (a CUDA graph), credited once per replay.

    A wrapper counts ``.launches`` and :func:`_dispatch.count_kernel_path`
    when Python calls it, so a capture counts launches that do not run
    and a replay, which calls no wrapper, would count none.  Recording
    around the capture (``with ReplayCounts.record() as rc:``) keeps what
    the region counted in ``rc`` and takes it back out of the live
    counters; ``rc.add(n)`` then credits ``n`` replays: ``.launches``
    counts replays x launches per graph, as an eager run of the same calls
    would; so does each by-shape count (``.by_shape``)."""

    def __init__(self, launches: Dict[str, int],
                 paths: Dict[Tuple[str, str], int],
                 shapes: Dict[str, collections.Counter]):
        self.launches = launches
        self.paths = paths
        self.shapes = shapes

    @classmethod
    @contextlib.contextmanager
    def record(cls):
        before = launch_counts()
        shapes_before = {name: collections.Counter(fn.by_shape)
                         for name, fn in KERNELS.items()
                         if hasattr(fn, "by_shape")}
        paths_before = collections.Counter(_dispatch.kernel_paths)
        rc = cls({}, {}, {})
        try:
            yield rc
        finally:
            for name, fn in KERNELS.items():
                if fn.launches != before[name]:
                    rc.launches[name] = fn.launches - before[name]
                fn.launches = before[name]
            for name, was in shapes_before.items():
                fn = KERNELS[name]
                if fn.by_shape != was:
                    rc.shapes[name] = fn.by_shape - was
                fn.by_shape.clear()
                fn.by_shape.update(was)
            rc.paths.update(collections.Counter(_dispatch.kernel_paths)
                            - paths_before)
            _dispatch.kernel_paths.clear()
            _dispatch.kernel_paths.update(paths_before)

    def add(self, n: int = 1) -> None:
        for name, k in self.launches.items():
            KERNELS[name].launches += n * k
        for name, by_shape in self.shapes.items():
            for key, k in by_shape.items():
                KERNELS[name].by_shape[key] += n * k
        for key, k in self.paths.items():
            _dispatch.kernel_paths[key] += n * k


__all__ = ["FlashAttention", "KERNELS", "ReplayCounts", "apply_rope",
           "build_rope_cache", "cache_mask",
           "cached_decode_attention", "cached_decode_attention_reference",
           "decode_attention_cuda", "decode_attention_int8_cuda",
           "decode_attention_paged_cuda", "decode_attention_paged_int8_cuda",
           "flash_attention", "flash_attention_bwd_dkv_cuda",
           "flash_attention_bwd_dq_cuda", "flash_attention_bwd_reference",
           "flash_attention_fwd_cuda",
           "flash_attention_fwd_paged_cuda",
           "flash_attention_fwd_paged_int8_cuda", "flash_attention_reference",
           "fused_rope", "int8_matmul_cuda", "int8_matmul_reference",
           "launch_counts", "reset_launch_counts", "rms_norm",
           "rms_norm_reference", "rms_norm_triton", "segment_mask",
           "shape_counts"]
