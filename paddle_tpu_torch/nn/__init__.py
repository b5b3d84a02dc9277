"""Layers of the port (mirrors ``paddle_tpu/nn``)."""

from . import functional, quant
from .common import RMSNorm

__all__ = ["RMSNorm", "functional", "quant"]
