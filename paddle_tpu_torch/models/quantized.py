"""Weight-only-quantized decode wrapper (mirrors
``paddle_tpu/models/quantized.py``).

:func:`quantize_for_decode` wraps a causal LM so every large 2-D float
parameter (``>= min_elems`` elements: at Llama-3-8B every projection,
``embed_tokens`` and ``lm_head``) is held as int8 plus a float32
per-column scale (``nn/quant.py::weight_quantize``), and nothing else of it:
the wrapper builds its own copy of the model in which each quantized
parameter is replaced by an :class:`~paddle_tpu_torch.nn.quant.Int8Weight`
(the originals are never copied; drop the source model to free them).
The model's projections then go through ``weight_only_linear``
(``nn/quant.py::linear``) and its embedding lookup gathers int8 rows and
dequantizes them.

Two differences from the reference, both recorded in ROADMAP §C:

  * the reference's ``QuantizedForDecode._prepare_params`` dequantizes
    every weight in-graph and runs plain products, although
    ``FLAGS_serving_int8_weights`` documents the int8 kernel path; the port
    keeps the int8 weights on the card and takes the documented path;
  * the reference quantizes every 2-D float entry of
    ``state_dict(include_buffers=True)``, the RoPE tables included once
    they reach ``min_elems`` (Llama-3-8B's are 8192 x 64); the port
    quantizes parameters only, as the reference's own docstring says
    ("rope caches stay fp").  Below that size (any ``min_elems`` above the
    RoPE table's) the two quantize the same names.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch
from torch import nn

from ..nn.quant import Int8Weight, weight_quantize

__all__ = ["QuantizedForDecode", "quantize_for_decode"]


def _split(name: str) -> Tuple[str, str]:
    mod, _, attr = name.rpartition(".")
    return mod, attr


class QuantizedForDecode(nn.Module):
    """A causal LM with int8 weights: same ``decode_step`` / ``logits`` /
    ``config`` surface as the wrapped model.

    ``unwrapped`` is the quantized copy of the model the calls go to,
    ``quantized_names`` the sorted parameter names held as int8,
    :meth:`hbm_bytes` the (quantized, unquantized) store sizes."""

    def __init__(self, model: nn.Module, algo: str = "weight_only_int8",
                 min_elems: int = 65536):
        super().__init__()
        if algo != "weight_only_int8":
            raise NotImplementedError(
                f"decode wrapper supports weight_only_int8 only, "
                f"got {algo!r}")
        names: List[str] = sorted(
            n for n, p in model.named_parameters()
            if p.dim() == 2 and p.numel() >= min_elems
            and p.is_floating_point())
        params = dict(model.named_parameters())
        # copy everything but the parameters being quantized: the memo maps
        # each of them to None, so deepcopy leaves an empty slot instead of
        # a second full-precision copy
        memo = {id(params[n]): None for n in names}
        inner = copy.deepcopy(model, memo)
        with torch.no_grad():
            for n in names:
                w8, scale = weight_quantize(params[n].detach())
                mod_name, attr = _split(n)
                mod = inner.get_submodule(mod_name) if mod_name else inner
                del mod._parameters[attr]
                mod.add_module(attr, Int8Weight(w8, scale))
        self.unwrapped = inner
        self.config = model.config
        self.algo = algo
        self.quantized_names = names

    def state_dict_packed(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{"fp": ..., "qw": ..., "qs": ...}`` by reference name — the
        layout of the reference's ``QuantizedForDecode.state_dict()``."""
        fp, qw, qs = {}, {}, {}
        for k, v in self.unwrapped.state_dict().items():
            mod, attr = _split(k)
            if mod in self.quantized_names and attr in ("w8", "scale"):
                (qw if attr == "w8" else qs)[mod] = v
            else:
                fp[k] = v
        return {"fp": fp, "qw": qw, "qs": qs}

    def decode_step(self, input_ids, cache, pos, block_tables=None,
                    rows=None):
        return self.unwrapped.decode_step(input_ids, cache, pos,
                                          block_tables=block_tables,
                                          rows=rows)

    def logits(self, hidden):
        return self.unwrapped.logits(hidden)

    def forward(self, input_ids, position_ids=None):
        return self.unwrapped(input_ids, position_ids)

    @property
    def model(self):
        return self.unwrapped.model

    def hbm_bytes(self) -> Tuple[int, int]:
        """(quantized, unquantized) parameter-store bytes, as the
        reference counts them: int8 payload + float32 scales + the
        full-precision rest, against that rest + 2 bytes a quantized
        element (its bf16 size)."""
        packed = self.state_dict_packed()
        fp = sum(v.numel() * v.element_size() for v in packed["fp"].values())
        n8 = sum(w.numel() for w in packed["qw"].values())
        ns = sum(s.numel() for s in packed["qs"].values())
        return n8 + 4 * ns + fp, fp + 2 * n8


def quantize_for_decode(model: nn.Module, algo: str = "weight_only_int8",
                        min_elems: int = 65536) -> QuantizedForDecode:
    """Quantize a causal LM's large 2-D weights for weight-only-int8
    decode.  Small tensors (norms, RoPE tables) stay full precision."""
    return QuantizedForDecode(model, algo=algo, min_elems=min_elems)
