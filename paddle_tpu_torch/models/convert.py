"""The weight bridge: load a reference (JAX) ``state_dict`` into the port.

The reference's ``model.state_dict(include_buffers=True)`` maps names such
as ``model.embed_tokens``, ``model.layers.{i}.self_attn.q_proj``,
``model.layers.{i}.input_layernorm.weight``, ``model.rope_cos`` and
``lm_head`` to arrays; the port's modules carry the same names and layouts
(``(in, out)`` projections), so the bridge is a checked copy by name.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_NATIVE = (np.float16, np.float32, np.float64, np.int32, np.int64, np.bool_)


def load_jax_state_dict(model: torch.nn.Module, arrays: Mapping[str, object]
                        ) -> torch.nn.Module:
    """Fill ``model``'s parameters and buffers in place from ``arrays``
    (``{name: array}``, e.g. ``{k: np.asarray(v) for k, v in
    jax_model.state_dict(include_buffers=True).items()}``).

    Every name must map both ways and every shape must match, else
    ``KeyError`` / ``ValueError``.  bfloat16 arrays (``ml_dtypes``, which
    ``torch.from_numpy`` rejects) pass through float32, which is exact.
    The RoPE buffers are copied, not recomputed: at ``rope_theta = 5e5``
    cos/sin differ in the last ulp between the two libraries."""
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"state_dict names do not match: missing "
                       f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for name, dst in own.items():
            a = np.asarray(arrays[name])
            if tuple(a.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                                 f"{tuple(dst.shape)}")
            if a.dtype.type not in _NATIVE:
                a = a.astype(np.float32)
            dst.copy_(torch.from_numpy(np.array(a, copy=True)).to(
                device=dst.device, dtype=dst.dtype))
    return model
