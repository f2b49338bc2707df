"""Fused layers of the port (counterparts of ``paddle_ray_tpu/incubate``)."""
from . import nn
from .nn import (FusedBiasDropoutResidualLayerNorm, FusedFeedForward,
                 FusedMultiHeadAttention, FusedTransformerEncoderLayer)

__all__ = ["nn", "FusedBiasDropoutResidualLayerNorm", "FusedFeedForward",
           "FusedMultiHeadAttention", "FusedTransformerEncoderLayer"]
