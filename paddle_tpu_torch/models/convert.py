"""The weight bridge: load a reference (JAX) ``state_dict`` into the port.

The reference's ``model.state_dict(include_buffers=True)`` maps names such
as ``model.embed_tokens``, ``model.layers.{i}.self_attn.q_proj``,
``model.layers.{i}.input_layernorm.weight``, ``model.rope_cos`` and
``lm_head`` to arrays; the port's modules carry the same names and layouts
(``(in, out)`` projections), so the bridge is a checked copy by name.
:func:`load_jax_quantized_state_dict` does the same for the reference's
``QuantizedForDecode.state_dict()`` (``{"fp", "qw", "qs"}``) into the
port's ``models/quantized.py`` wrapper, and
:func:`load_jax_optimizer_state` carries a reference optimizer state
(``opt.init`` / the train step's ``opt_state``) into the port's optimizer,
so a run started in JAX resumes in the port.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_NATIVE = (np.float16, np.float32, np.float64, np.int8, np.int32, np.int64,
           np.bool_)


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


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.type not in _NATIVE:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def load_jax_optimizer_state(optimizer, opt_state: Mapping[str, object]):
    """Set ``optimizer``'s state from the reference's ``opt_state``
    (``{"step": int array, "master": {name: array}, <slot>: {name:
    array}}``, numpy leaves or anything ``np.asarray`` takes; JAX's
    single-device layout).  The optimizer must be bound to its module
    (``Optimizer(parameters=model)``, or ``build_train_step``): every
    trainable parameter must have its slots, the float32 master weights go
    to the bf16/f16 parameters, and the tensors land on each parameter's
    device as float32.  Raises ``KeyError`` on a name or slot that does
    not match.  Returns the optimizer."""
    params = optimizer.trainable()
    slots = tuple(optimizer._slot_names())
    want = {"step", *slots} | ({"master"} if "master" in opt_state else set())
    if set(opt_state) != want:
        raise KeyError(f"optimizer state keys {sorted(opt_state)} != "
                       f"{sorted(want)}")
    state = {"step": int(np.asarray(opt_state["step"]))}
    for key in (*slots, "master") if "master" in opt_state else slots:
        src = opt_state[key]
        names = set(params) if key != "master" else {
            k for k, p in params.items()
            if p.dtype in (torch.bfloat16, torch.float16)}
        if set(src) != names:
            raise KeyError(f"{key}: names do not match: missing "
                           f"{sorted(names - set(src))}, unexpected "
                           f"{sorted(set(src) - names)}")
        state[key] = {}
        for k, a in src.items():
            t = _tensor(a, params[k].device).float()
            if tuple(t.shape) != tuple(params[k].shape):
                raise ValueError(f"{key}.{k}: shape {tuple(t.shape)} != "
                                 f"{tuple(params[k].shape)}")
            state[key][k] = t
    optimizer.set_state_dict(state)
    return optimizer


def load_jax_quantized_state_dict(qmodel: torch.nn.Module,
                                  packed: Mapping[str, Mapping[str, object]]
                                  ) -> torch.nn.Module:
    """Fill a ``models.quantized.QuantizedForDecode`` wrapper in place from
    the reference wrapper's packed state (``{"fp": {name: array}, "qw":
    {name: int8 (K, N)}, "qs": {name: float32 (N,)}}``, e.g. each leaf
    through ``np.asarray``): full-precision entries by name, each
    quantized weight into ``<name>.w8`` and its scale into
    ``<name>.scale``.  Both sides must have quantized the same names (the
    port never quantizes the RoPE buffers; see ``models/quantized.py``),
    else ``KeyError``."""
    flat = dict(packed["fp"])
    for name, w8 in packed["qw"].items():
        flat[f"{name}.w8"] = w8
        flat[f"{name}.scale"] = packed["qs"][name]
    return load_jax_state_dict(qmodel.unwrapped, flat)
