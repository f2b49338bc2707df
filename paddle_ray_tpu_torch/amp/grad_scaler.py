"""Dynamic loss scaling (the port's counterpart of
``paddle_ray_tpu/amp/grad_scaler.py``): the reference's algorithm
(``init_loss_scaling``, ``incr_ratio`` / ``decr_ratio``,
``incr_every_n_steps``, ``decr_every_n_nan_or_inf``) over a state of
device tensors, updated with ``torch.where`` (no host-device sync).
Unscaling and the found-inf check run in float32.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

__all__ = ["GradScaler", "ScalerState"]


@dataclasses.dataclass
class ScalerState:
    scale: torch.Tensor           # float32 scalar
    growth_tracker: torch.Tensor  # int32: consecutive good steps
    bad_tracker: torch.Tensor     # int32: consecutive bad steps


class GradScaler:
    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2):
        self.enable = enable
        self.init_loss_scaling = init_loss_scaling
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio
        self.incr_every_n_steps = incr_every_n_steps
        self.decr_every_n_nan_or_inf = decr_every_n_nan_or_inf

    def init_state(self, device=None) -> ScalerState:
        return ScalerState(
            scale=torch.full((), self.init_loss_scaling if self.enable
                             else 1.0, dtype=torch.float32, device=device),
            growth_tracker=torch.zeros((), dtype=torch.int32, device=device),
            bad_tracker=torch.zeros((), dtype=torch.int32, device=device))

    def scale(self, loss: torch.Tensor, state: ScalerState) -> torch.Tensor:
        """``loss * scale`` in the loss's dtype."""
        if not self.enable:
            return loss
        return loss * state.scale.to(loss.dtype)

    def unscale_and_check(self, grads: Sequence[torch.Tensor],
                          state: ScalerState
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """``(grads, found_inf)``: each gradient times ``1 / scale`` in
        float32, cast back to its dtype, and a device bool, True when any
        unscaled value is not finite.  None entries pass through."""
        if not self.enable:
            dev = state.scale.device
            return list(grads), torch.zeros((), dtype=torch.bool, device=dev)
        inv = torch.reciprocal(state.scale)
        out, bad = [], []
        for g in grads:
            if g is None:
                out.append(None)
                continue
            u = g.float() * inv
            bad.append(~torch.isfinite(u).all())
            out.append(u.to(g.dtype))
        found = (torch.stack(bad).any() if bad else
                 torch.zeros((), dtype=torch.bool, device=inv.device))
        return out, found

    def update(self, state: ScalerState,
               found_inf: torch.Tensor) -> ScalerState:
        """The next state after a step with ``found_inf``: a good step adds
        to the growth tracker and a bad one to the bad tracker; at
        ``incr_every_n_steps`` good steps the scale grows by
        ``incr_ratio``, at ``decr_every_n_nan_or_inf`` bad ones it shrinks
        by ``decr_ratio`` (to 1 at least), and that tracker restarts."""
        if not self.enable:
            return state
        zero = torch.zeros_like(state.growth_tracker)
        growth = torch.where(found_inf, zero, state.growth_tracker + 1)
        bad = torch.where(found_inf, state.bad_tracker + 1, zero)
        grow_now = growth >= self.incr_every_n_steps
        shrink_now = bad >= self.decr_every_n_nan_or_inf
        scale = torch.where(grow_now, state.scale * self.incr_ratio,
                            state.scale)
        scale = torch.where(shrink_now, torch.clamp(
            scale * self.decr_ratio, min=1.0), scale)
        return ScalerState(scale=scale,
                           growth_tracker=torch.where(grow_now, zero, growth),
                           bad_tracker=torch.where(shrink_now, zero, bad))
