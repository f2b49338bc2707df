"""Layers on the GPT path (counterparts of ``paddle_ray_tpu/nn/layers.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with ``weight``/``bias`` parameters;
    normalises in float32 (:func:`functional.layer_norm`)."""

    def __init__(self, hidden: int, epsilon: float = 1e-5, *,
                 device: Optional[torch.device] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(hidden, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.weight, self.bias, self.epsilon)
