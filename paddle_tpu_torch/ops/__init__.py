"""Operators of the port (mirrors ``paddle_tpu/ops``)."""

from .attention import (cache_mask, cached_decode_attention,
                        cached_decode_attention_reference, flash_attention,
                        flash_attention_reference)
from .cuda.decode_attention import decode_attention_cuda
from .cuda.flash_attention import flash_attention_fwd_cuda
from .norms import rms_norm, rms_norm_reference
from .rope import apply_rope, build_rope_cache, fused_rope
from .triton.rms_norm import rms_norm_triton

# every hand-written kernel of the port: name -> wrapper (each wrapper
# counts its launches in ``.launches``)
KERNELS = {
    "decode_attention": decode_attention_cuda,
    "flash_attention_fwd": flash_attention_fwd_cuda,
    "rms_norm": rms_norm_triton,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["KERNELS", "apply_rope", "build_rope_cache", "cache_mask",
           "cached_decode_attention", "cached_decode_attention_reference",
           "decode_attention_cuda", "flash_attention",
           "flash_attention_fwd_cuda", "flash_attention_reference",
           "fused_rope", "launch_counts", "reset_launch_counts", "rms_norm",
           "rms_norm_reference", "rms_norm_triton"]
