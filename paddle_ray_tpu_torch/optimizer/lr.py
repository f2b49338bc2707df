"""Learning-rate schedules (the port's counterpart of
``paddle_ray_tpu/optimizer/lr.py``).  A schedule is a callable ``step ->
lr`` on the optimizer's step count (1 for the first update); the port
runs eagerly, so it takes a Python int and returns a Python float.

Each returns the float32 value the JAX schedule gives (``ConstantLR``
its number as given, which the optimizer rounds): the JAX schedules
are float32 jnp expressions of an int32 step in which a Python number is
weakly typed (an expression of Python numbers alone is computed in double,
then rounded where it meets a float32 array).  Here the same expressions
run on numpy float32 scalars, every Python number rounded with
:func:`_f32` where JAX rounds it.  ``cos``, ``exp`` and ``pow`` are
numpy's, which may differ from XLA's in the last place.
"""
from __future__ import annotations

import bisect
import math
from typing import Sequence

import numpy as np

__all__ = [
    "LRScheduler", "ConstantLR", "StepDecay", "MultiStepDecay",
    "ExponentialDecay", "PolynomialDecay", "CosineAnnealingDecay",
    "NoamDecay", "LinearWarmup", "OneCycleLR", "PiecewiseDecay",
    "NaturalExpDecay", "InverseTimeDecay", "LambdaDecay",
    "ReduceOnPlateau", "CyclicLR", "MultiplicativeDecay",
]

_f32 = np.float32


def _clip01(x):
    return min(max(x, _f32(0.0)), _f32(1.0))


class LRScheduler:
    # host_driven: the lr is host-side state the optimizer reads into a
    # live value at bind and ``set_lr`` rewrites (lr.ReduceOnPlateau)
    host_driven = False

    def __call__(self, step: int) -> float:
        raise NotImplementedError


class ConstantLR(LRScheduler):
    """The learning rate as given (the optimizer rounds it to float32)."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def __call__(self, step: int) -> float:
        return float(self.learning_rate)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate: float, step_size: int,
                 gamma: float = 0.1):
        self.learning_rate = learning_rate
        self.step_size = step_size
        self.gamma = gamma

    def __call__(self, step: int) -> float:
        k = _f32(step // self.step_size)
        return float(_f32(self.learning_rate)
                     * np.power(_f32(self.gamma), k))


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate: float, milestones: Sequence[int],
                 gamma: float = 0.1):
        self.learning_rate = learning_rate
        self.milestones = tuple(milestones)
        self.gamma = gamma

    def __call__(self, step: int) -> float:
        k = _f32(sum(step >= m for m in self.milestones))
        return float(_f32(self.learning_rate)
                     * np.power(_f32(self.gamma), k))


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float):
        self.learning_rate = learning_rate
        self.gamma = gamma

    def __call__(self, step: int) -> float:
        return float(_f32(self.learning_rate)
                     * np.power(_f32(self.gamma), _f32(step)))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int,
                 end_lr: float = 0.0001, power: float = 1.0):
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power

    def __call__(self, step: int) -> float:
        t = min(_f32(step), _f32(self.decay_steps)) / _f32(self.decay_steps)
        return float(_f32(self.learning_rate - self.end_lr)
                     * np.power(_f32(1.0) - t, _f32(self.power))
                     + _f32(self.end_lr))


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate: float, t_max: int,
                 eta_min: float = 0.0):
        self.learning_rate = learning_rate
        self.t_max = t_max
        self.eta_min = eta_min

    def __call__(self, step: int) -> float:
        t = min(_f32(step), _f32(self.t_max))
        cos = _f32(0.5) * (_f32(1.0) + np.cos(_f32(math.pi) * t
                                              / _f32(self.t_max)))
        return float(_f32(self.eta_min)
                     + _f32(self.learning_rate - self.eta_min) * cos)


class NoamDecay(LRScheduler):
    def __init__(self, d_model: int, warmup_steps: int,
                 learning_rate: float = 1.0):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        self.learning_rate = learning_rate

    def __call__(self, step: int) -> float:
        s = max(_f32(step), _f32(1.0))
        return float(_f32(self.learning_rate * self.d_model ** -0.5)
                     * min(np.power(s, _f32(-0.5)),
                           s * _f32(self.warmup_steps ** -1.5)))


class LinearWarmup(LRScheduler):
    """Wraps another schedule (or a constant) with a linear warm-up from
    ``start_lr`` to ``end_lr`` (default: the inner schedule at
    ``warmup_steps``); after it, the inner schedule runs from its step 0."""

    def __init__(self, learning_rate, warmup_steps: int,
                 start_lr: float = 0.0, end_lr: float = None):
        self.inner = (learning_rate if isinstance(learning_rate, LRScheduler)
                      else ConstantLR(learning_rate))
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr

    def __call__(self, step: int) -> float:
        if step >= self.warmup_steps:
            return self.inner(max(step - self.warmup_steps, 0))
        if self.end_lr is None:
            span = _f32(self.inner(self.warmup_steps)) - _f32(self.start_lr)
        else:
            span = _f32(self.end_lr - self.start_lr)
        frac = min(_f32(step) / _f32(max(self.warmup_steps, 1)), _f32(1.0))
        return float(_f32(self.start_lr) + span * frac)


class OneCycleLR(LRScheduler):
    def __init__(self, max_lr: float, total_steps: int,
                 pct_start: float = 0.3, div_factor: float = 25.0,
                 final_div_factor: float = 1e4):
        self.max_lr = max_lr
        self.total_steps = total_steps
        self.pct_start = pct_start
        self.initial_lr = max_lr / div_factor
        self.final_lr = self.initial_lr / final_div_factor

    def __call__(self, step: int) -> float:
        sf = min(_f32(step), _f32(self.total_steps))
        up = self.pct_start * self.total_steps
        pi = _f32(math.pi)
        if sf < _f32(up):
            t_up = _clip01(sf / _f32(max(up, 1)))
            return float(_f32(self.initial_lr)
                         + _f32((self.max_lr - self.initial_lr) * 0.5)
                         * (_f32(1.0) - np.cos(pi * t_up)))
        t_dn = _clip01((sf - _f32(up))
                       / _f32(max(self.total_steps - up, 1)))
        return float(_f32(self.final_lr)
                     + _f32((self.max_lr - self.final_lr) * 0.5)
                     * (_f32(1.0) + np.cos(pi * t_dn)))


class PiecewiseDecay(LRScheduler):
    """lr = values[i] on [boundaries[i-1], boundaries[i])."""

    def __init__(self, boundaries: Sequence[int], values: Sequence[float]):
        if len(values) != len(boundaries) + 1:
            raise ValueError("need len(values) == len(boundaries) + 1")
        self.boundaries = list(boundaries)
        self.values = list(values)

    def __call__(self, step: int) -> float:
        return float(_f32(self.values[bisect.bisect_right(self.boundaries,
                                                          step)]))


class NaturalExpDecay(LRScheduler):
    """lr * exp(-gamma * step)."""

    def __init__(self, learning_rate: float, gamma: float):
        self.learning_rate = learning_rate
        self.gamma = gamma

    def __call__(self, step: int) -> float:
        return float(_f32(self.learning_rate)
                     * np.exp(_f32(-self.gamma) * _f32(step)))


class InverseTimeDecay(LRScheduler):
    """lr / (1 + gamma * step)."""

    def __init__(self, learning_rate: float, gamma: float):
        self.learning_rate = learning_rate
        self.gamma = gamma

    def __call__(self, step: int) -> float:
        return float(_f32(self.learning_rate)
                     / (_f32(1.0) + _f32(self.gamma) * _f32(step)))


class LambdaDecay(LRScheduler):
    """lr * lr_lambda(step), ``lr_lambda`` called with the int step."""

    def __init__(self, learning_rate: float, lr_lambda):
        self.learning_rate = learning_rate
        self.lr_lambda = lr_lambda

    def __call__(self, step: int) -> float:
        return float(_f32(self.learning_rate) * _f32(self.lr_lambda(step)))


class ReduceOnPlateau(LRScheduler):
    """Metric-driven decay with the reference's mode / threshold_mode /
    cooldown state machine, on the host: call ``sched.step(metric)`` once
    per evaluation, then push the new lr into the train step with
    ``train_state.set_lr(sched.current_lr)`` (the optimizer holds a live
    lr, as the JAX optimizer state does)."""

    host_driven = True

    def __init__(self, learning_rate: float, mode: str = "min",
                 factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: float = 0.0,
                 epsilon: float = 1e-8):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError("threshold_mode must be 'rel' or 'abs'")
        self.current_lr = learning_rate
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self._best = None
        self._bad = 0
        self._cooldown_left = 0

    def _better(self, metric: float) -> bool:
        if self._best is None:
            return True
        t = (self._best * self.threshold if self.threshold_mode == "rel"
             else self.threshold)
        if self.mode == "min":
            return metric < self._best - t
        return metric > self._best + t

    def step(self, metric: float) -> float:
        metric = float(metric)
        # the cooldown ticks down first and suppresses both best-tracking
        # and bad-epoch counting
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
        else:
            if self._better(metric):
                self._best = metric
                self._bad = 0
            else:
                self._bad += 1
            if self._bad > self.patience:
                self._cooldown_left = self.cooldown
                self._bad = 0
                new_lr = max(self.current_lr * self.factor, self.min_lr)
                if self.current_lr - new_lr > self.epsilon:
                    self.current_lr = new_lr
        return self.current_lr

    def __call__(self, step: int) -> float:
        return float(_f32(self.current_lr))

    def state_dict(self) -> dict:
        return {"current_lr": self.current_lr, "best": self._best,
                "bad": self._bad, "cooldown_left": self._cooldown_left}

    def set_state_dict(self, state: dict) -> None:
        self.current_lr = float(state["current_lr"])
        self._best = state["best"]
        self._bad = int(state["bad"])
        self._cooldown_left = int(state["cooldown_left"])


class MultiplicativeDecay(LRScheduler):
    """lr0 * prod_{i=1..step} lr_lambda(i), the product in float32."""

    def __init__(self, learning_rate: float, lr_lambda):
        self.learning_rate = learning_rate
        self.lr_lambda = lr_lambda

    def __call__(self, step: int) -> float:
        factor = _f32(1.0)
        for i in range(1, step + 1):
            factor = factor * _f32(self.lr_lambda(i))
        return float(_f32(self.learning_rate) * factor)


class CyclicLR(LRScheduler):
    """Cyclical learning rates: triangular / triangular2 / exp_range
    policies, or ``scale_fn`` of the cycle or the step."""

    def __init__(self, base_learning_rate: float, max_learning_rate: float,
                 step_size_up: int, step_size_down: int = None,
                 mode: str = "triangular", exp_gamma: float = 1.0,
                 scale_fn=None, scale_mode: str = "cycle"):
        if mode not in ("triangular", "triangular2", "exp_range") \
                and scale_fn is None:
            raise ValueError(f"unknown CyclicLR mode {mode!r}")
        self.base = base_learning_rate
        self.peak = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode if scale_fn is not None else (
            "iterations" if mode == "exp_range" else "cycle")

    def __call__(self, step: int) -> float:
        sf = _f32(step)
        total = _f32(float(self.up + self.down))
        cycle = np.floor(_f32(1.0) + sf / total)
        pos = sf - (cycle - _f32(1.0)) * total
        if pos < _f32(self.up):
            frac = pos / _f32(self.up)
        else:
            frac = _f32(1.0) - (pos - _f32(self.up)) / _f32(self.down)
        if self.scale_fn is not None:
            scale = _f32(self.scale_fn(cycle if self.scale_mode == "cycle"
                                       else sf))
        elif self.mode == "triangular":
            scale = _f32(1.0)
        elif self.mode == "triangular2":
            scale = _f32(1.0) / np.power(_f32(2.0), cycle - _f32(1.0))
        else:                                     # exp_range
            scale = np.power(_f32(self.exp_gamma), sf)
        return float(_f32(self.base)
                     + _f32(self.peak - self.base) * frac * scale)
