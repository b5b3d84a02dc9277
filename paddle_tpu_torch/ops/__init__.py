"""Operators of the port (mirrors ``paddle_tpu/ops``)."""

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
# counts its launches in ``.launches``)
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


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["FlashAttention", "KERNELS", "apply_rope", "build_rope_cache", "cache_mask",
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
           "rms_norm_reference", "rms_norm_triton", "segment_mask"]
