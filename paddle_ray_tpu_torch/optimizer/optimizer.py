"""Optimizers (the port's counterpart of
``paddle_ray_tpu/optimizer/optimizer.py``): ``Adam`` and ``AdamW`` as
:class:`torch.optim.Optimizer` subclasses with the JAX package's
arithmetic.

What differs from ``torch.optim.AdamW``, and follows the JAX update:

- the moments ``m`` and ``v`` are float32 whatever the parameter's dtype,
  and with ``multi_precision`` (the default) a bfloat16 or float16
  parameter keeps a float32 master copy that the update runs on, cast back
  into the parameter after each step (a float32 parameter is its own
  master);
- the order of operations is the JAX one: ``m``, ``v``, bias corrections
  ``1 - beta ** t`` in float32, ``upd = mhat / (sqrt(vhat) + eps) + wd *
  p32``, ``p32 - lr * upd``;
- weight decay applies to parameters with ``ndim > 1`` unless
  ``wd_mask_fn(name)`` says otherwise;
- one step count for the optimizer, and a parameter whose ``.grad`` is
  None is left alone that step;
- ``grad_clip`` (:mod:`.clip`) clips the gradients, in their dtype,
  before the step count advances; an ``L1Decay`` / ``L2Decay``
  (:mod:`..regularizer`) as ``weight_decay`` adds ``coeff * sign(p)`` /
  ``coeff * p`` to the float32 gradient of each parameter the decay mask
  selects, before the update rule;
- a host-driven schedule (``lr.ReduceOnPlateau``) is read once at bind
  into a live learning rate that :meth:`Optimizer.set_lr` rewrites, as
  the JAX ``OptState.lr_value``.

The JAX optimizer is built unbound and ``opt.init(params)`` makes its
state; here an optimizer built without ``parameters`` is bound by
:meth:`Optimizer.bind` (``build_train_step`` binds it to the model), which
allocates the moments and master copies.  Updates run in place on the
parameters and state: eager PyTorch has no buffer donation, so this is its
counterpart.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..regularizer import L1Decay, L2Decay
from .clip import GradClipBase
from .lr import ConstantLR, LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer(torch.optim.Optimizer):
    """Base class: one parameter group with the parameters' names; the
    subclass's :meth:`_update` updates one float32 parameter in place."""

    slot_names: Tuple[str, ...] = ()

    def __init__(self, learning_rate: Union[float, LRScheduler] = 1e-3, *,
                 parameters=None, grad_clip: Optional[GradClipBase] = None,
                 weight_decay: Union[float, L1Decay, L2Decay] = 0.0,
                 wd_mask_fn: Optional[Callable[[str], bool]] = None,
                 multi_precision: bool = True):
        if grad_clip is not None and not isinstance(grad_clip, GradClipBase):
            raise TypeError(f"grad_clip takes a clip of optimizer.clip, got "
                            f"{type(grad_clip).__name__}")
        self.grad_clip = grad_clip
        # a regularizer couples into the gradient (in the base step,
        # before the update rule); a float is each optimizer's own decay
        self._l1_coeff = self._l2_coeff = 0.0
        if isinstance(weight_decay, L1Decay):
            self._l1_coeff, weight_decay = weight_decay.coeff, 0.0
        elif isinstance(weight_decay, L2Decay):
            self._l2_coeff, weight_decay = weight_decay.coeff, 0.0
        elif not isinstance(weight_decay, (int, float)):
            raise TypeError(f"weight_decay takes a float, L1Decay or "
                            f"L2Decay, got {type(weight_decay).__name__}")
        self.lr = (learning_rate if isinstance(learning_rate, LRScheduler)
                   else ConstantLR(learning_rate))
        self.lr_value: Optional[float] = None
        self.weight_decay = float(weight_decay)
        self.wd_mask_fn = wd_mask_fn
        self.multi_precision = multi_precision
        # torch wraps a class's `step` in its hook runner when the first
        # instance of the class binds; an unbound instance has empty hooks,
        # so its `step` still reaches the not-bound error
        self._optimizer_step_pre_hooks = collections.OrderedDict()
        self._optimizer_step_post_hooks = collections.OrderedDict()
        if parameters is not None:
            self.bind(parameters)

    @property
    def bound(self) -> bool:
        return hasattr(self, "param_groups")

    def bind(self, parameters: Union[nn.Module, Iterable]) -> "Optimizer":
        """Bind to ``parameters`` (a module, ``(name, parameter)`` pairs,
        or bare parameters) and allocate the state: float32 zeros for each
        slot and the float32 master copies."""
        if self.bound:
            raise RuntimeError("optimizer is already bound to parameters")
        if isinstance(parameters, nn.Module):
            parameters = parameters.named_parameters()
        items = list(parameters)
        if items and isinstance(items[0], tuple):
            names, params = [n for n, _ in items], [p for _, p in items]
        else:
            names, params = [None] * len(items), items
        if self.wd_mask_fn is not None and None in names:
            raise ValueError("wd_mask_fn needs named parameters")
        super().__init__([{"params": params, "names": names, "step": 0}],
                         {})
        for p in params:
            st = self.state[p]
            for slot in self.slot_names:
                st[slot] = torch.zeros_like(p, dtype=torch.float32)
            if (self.multi_precision and p.is_floating_point()
                    and p.dtype != torch.float32):
                st["master"] = p.detach().float()
        if self.lr.host_driven:
            self.set_lr(self.lr.current_lr)
        return self

    def set_lr(self, value: float) -> None:
        """Rewrite the live learning rate of a host-driven schedule (the
        JAX ``TrainState.set_lr``); the next steps use it."""
        if not self.lr.host_driven:
            raise ValueError(
                "optimizer has no live learning rate: construct it with a "
                "host-driven scheduler (lr.ReduceOnPlateau) to use set_lr")
        self.lr_value = float(np.float32(value))

    @property
    def step_count(self) -> int:
        """Updates applied so far (the JAX ``OptState.step``)."""
        return self.param_groups[0]["step"] if self.bound else 0

    def _decays(self, p: torch.Tensor, name: Optional[str]) -> bool:
        if self.wd_mask_fn is None:
            return p.dim() > 1
        return bool(self.wd_mask_fn(name))

    @torch.no_grad()
    def step(self, closure=None):
        """Apply one update to every parameter that has a ``.grad``."""
        if not self.bound:
            raise RuntimeError("optimizer is not bound: pass parameters= "
                               "or call bind()")
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        live = [(p, name) for p, name in zip(group["params"], group["names"])
                if p.grad is not None]
        grads = [p.grad for p, _ in live]
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        group["step"] += 1
        t = group["step"]
        lr = (self.lr_value if self.lr_value is not None
              else float(np.float32(self.lr(t))))
        for (p, name), g in zip(live, grads):
            st = self.state[p]
            decays = self._decays(p, name)
            wd = self.weight_decay if decays else 0.0
            p32 = st.get("master")
            if p32 is None:
                p32 = p if p.dtype == torch.float32 else p.float()
            g32 = g.float()
            if decays and self._l1_coeff:
                g32 = g32 + self._l1_coeff * torch.sign(p32)
            if decays and self._l2_coeff:
                g32 = g32 + self._l2_coeff * p32
            self._update(p32, g32, st, lr, t, wd)
            if p32 is not p:
                p.copy_(p32)
        return loss

    def _update(self, p: torch.Tensor, g: torch.Tensor, st: dict, lr: float,
                t: int, wd: float) -> None:
        raise NotImplementedError


class Adam(Optimizer):
    """Adam; ``weight_decay`` is added to the gradient (L2), as in the JAX
    package."""

    slot_names = ("m", "v")
    decoupled_wd = False

    def __init__(self, learning_rate=1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def _update(self, p, g, st, lr, t, wd):
        b1, b2 = self.beta1, self.beta2
        if wd and not self.decoupled_wd:
            g = g + wd * p
        m, v = st["m"], st["v"]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        # bias corrections in float32, as the JAX update computes them
        t32 = np.float32(t)
        bc1 = float(np.float32(1) - np.float32(b1) ** t32)
        bc2 = float(np.float32(1) - np.float32(b2) ** t32)
        upd = (m / bc1) / ((v / bc2).sqrt() + self.epsilon)
        if wd and self.decoupled_wd:
            upd = upd + wd * p
        p.sub_(lr * upd)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01)."""

    decoupled_wd = True

    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay: float = 0.01, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         weight_decay=weight_decay, **kw)
