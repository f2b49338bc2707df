"""Neural-network building blocks of the port."""
from . import functional, init
from .layers import (Conv2D, Conv2DTranspose, Dropout, GroupNorm, LayerNorm,
                     Linear)

__all__ = ["functional", "init", "Conv2D", "Conv2DTranspose", "Dropout",
           "GroupNorm", "LayerNorm", "Linear"]
