"""Neural-network building blocks of the port."""
from . import functional
from .layers import LayerNorm

__all__ = ["functional", "LayerNorm"]
