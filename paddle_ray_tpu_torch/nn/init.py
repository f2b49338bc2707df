"""Parameter initializers (the port's counterparts of the two that the
UNet uses from ``paddle_ray_tpu/nn/init.py``).  Each returns a new tensor
drawn from the passed :class:`torch.Generator`: float32 draws, cast to
``dtype``."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["compute_fans", "kaiming_normal", "xavier_uniform"]


def compute_fans(shape: Sequence[int]) -> Tuple[int, int]:
    """``(fan_in, fan_out)`` by the JAX package's convention: a Linear
    weight is ``(in, out)``; a conv kernel ``(O, I, *k)`` multiplies both
    fans by its receptive field."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _kaiming_gain(nonlinearity: str, negative_slope: float) -> float:
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


def xavier_uniform(shape: Sequence[int], *, gain: float = 1.0, device=None,
                   dtype: torch.dtype = torch.float32,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """``uniform(-limit, limit)``, ``limit = gain * sqrt(6 / (fan_in +
    fan_out))``."""
    fan_in, fan_out = compute_fans(shape)
    limit = gain * math.sqrt(6.0 / (fan_in + fan_out))
    t = torch.empty(tuple(shape), device=device, dtype=torch.float32)
    t.uniform_(-limit, limit, generator=generator)
    return t.to(dtype)


def kaiming_normal(shape: Sequence[int], *, negative_slope: float = 0.0,
                   nonlinearity: str = "relu", mode: str = "fan_in",
                   device=None, dtype: torch.dtype = torch.float32,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """``normal(0, gain / sqrt(fan))`` with the fan of ``mode``
    (``"fan_in"`` or ``"fan_out"``)."""
    fan_in, fan_out = compute_fans(shape)
    fan = fan_in if mode == "fan_in" else fan_out
    std = _kaiming_gain(nonlinearity, negative_slope) / math.sqrt(fan)
    t = torch.empty(tuple(shape), device=device, dtype=torch.float32)
    t.normal_(0.0, std, generator=generator)
    return t.to(dtype)
