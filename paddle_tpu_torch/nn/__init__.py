"""Layers of the port (mirrors ``paddle_tpu/nn``)."""

from . import functional, quant
from .common import LayerNorm, RMSNorm

__all__ = ["LayerNorm", "RMSNorm", "functional", "quant"]
