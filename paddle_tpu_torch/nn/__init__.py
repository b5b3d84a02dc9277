"""Layers of the port (mirrors ``paddle_tpu/nn``)."""

from . import functional
from .common import RMSNorm

__all__ = ["RMSNorm", "functional"]
