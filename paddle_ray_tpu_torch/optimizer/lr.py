"""Learning-rate schedules (the port's counterpart of
``paddle_ray_tpu/optimizer/lr.py``).  A schedule is a callable ``step ->
lr`` on the optimizer's step count (1 for the first update); the port
runs eagerly, so it returns a Python float."""
from __future__ import annotations

__all__ = ["LRScheduler", "ConstantLR"]


class LRScheduler:
    def __call__(self, step: int) -> float:
        raise NotImplementedError


class ConstantLR(LRScheduler):
    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def __call__(self, step: int) -> float:
        return float(self.learning_rate)
