"""The flags this slice of the port reads (mirrors ``paddle_tpu/flags.py``).

Only the serving defaults and the flash-decode chunk size are kept.  The
JAX package's routing thresholds (``decode_attention_min_len``,
``rms_norm_pallas_min_dim``, the flash block sizes) were measured on a TPU
and do not carry over: the port routes every eligible CUDA tensor to its
kernel.  The serving flags are the engine's defaults; this slice supports
those defaults only and raises on any other value (``serving/engine.py``).
"""

from __future__ import annotations

from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = {
    # flash-decode KV split: the JAX kernel walks a row's cache in chunks
    # of at most this many keys, one grid step each; the CUDA kernel gives
    # each CTA a split of at most this many keys and merges the splits'
    # partials with the LSE algebra (ops/cuda/decode_attention.py).  256
    # was the fastest of 64..4096 on an H100 at B=8, L=4096, ragged depths
    # (chip_smoke.py --profile; PERF.md); the reference's 512 is a TPU
    # DMA-block choice.
    "decode_attention_block_kv": 256,
    # serving defaults (paddle_tpu/flags.py:150-210)
    "serving_paged_kv": False,
    "serving_kv_cache_dtype": "bf16",
    "serving_int8_weights": False,
    "serving_chunked_prefill": False,
    "serving_spec_decode": False,
}

_values: Dict[str, Any] = dict(_DEFAULTS)


def flag(name: str) -> Any:
    """Current value of ``name`` (KeyError for a flag this slice lacks)."""
    return _values[name]


def set_flags(values: Dict[str, Any]) -> None:
    """Set flags by name; unknown names raise KeyError."""
    for k, v in values.items():
        if k not in _DEFAULTS:
            raise KeyError(f"unknown flag {k!r}")
        _values[k] = v
