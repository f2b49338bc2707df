"""Gradient clipping (the port of ``paddle_ray_tpu/optimizer/clip.py``):
``ClipGradByGlobalNorm``, ``ClipGradByNorm`` and ``ClipGradByValue``.

A clip maps a list of gradients to a list of clipped gradients, each in
its own dtype; the optimizer applies it before its step count advances.
Norms sum the squares in float32 and the scale ``min(1, clip_norm /
max(norm, 1e-12))`` multiplies each gradient in float32 before the cast
back, as in JAX.  The JAX ``psum_axes`` (a norm summed over mesh axes) has
no counterpart on one device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

__all__ = ["GradClipBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "global_norm"]


def _sum_sq(g: torch.Tensor) -> torch.Tensor:
    return g.float().square().sum()


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt`` of the float32 sum, gradient after gradient, of each
    gradient's float32 sum of squares (None entries skipped)."""
    leaves = [g for g in grads if g is not None]
    dev = leaves[0].device if leaves else None
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for g in leaves:
        total = total + _sum_sq(g)
    return torch.sqrt(total)


def _scale(norm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """``min(1, clip_norm / max(norm, 1e-12))`` in float32, the quotient a
    division by a tensor (exact on the card too), made by a fill: a tensor
    copied from the host would wait for the device."""
    c = torch.full((), clip_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(c / torch.clamp(norm, min=1e-12), max=1.0)


def _scaled(g: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (g.float() * s).to(g.dtype)


class GradClipBase:
    def __call__(self, grads: Sequence[torch.Tensor]
                 ) -> List[Optional[torch.Tensor]]:
        raise NotImplementedError


class ClipGradByGlobalNorm(GradClipBase):
    """Scale every gradient by ``min(1, clip_norm / global_norm)``."""

    def __init__(self, clip_norm: float):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        live = [g for g in grads if g is not None]
        if not live:
            return list(grads)
        s = _scale(global_norm(live), self.clip_norm)
        return [None if g is None else _scaled(g, s) for g in grads]


class ClipGradByNorm(GradClipBase):
    """Per-tensor L2 clip."""

    def __init__(self, clip_norm: float):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        return [None if g is None
                else _scaled(g, _scale(torch.sqrt(_sum_sq(g)),
                                       self.clip_norm))
                for g in grads]


class ClipGradByValue(GradClipBase):
    """Clamp every gradient to ``[min_value, max_value]`` in its dtype
    (``min_value`` defaults to ``-max_value``)."""

    def __init__(self, max_value: float, min_value: Optional[float] = None):
        self.max_value = max_value
        self.min_value = -max_value if min_value is None else min_value

    def __call__(self, grads):
        return [None if g is None
                else torch.clamp(g, self.min_value, self.max_value)
                for g in grads]
