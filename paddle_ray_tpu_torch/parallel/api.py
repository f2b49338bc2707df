"""The train step (the port's counterpart of the single-device branch of
``paddle_ray_tpu/parallel/api.py``).

The JAX package compiles ``(model, opt_state, batch, rng) -> (model,
opt_state, loss)`` into one program with donated buffers.  Eager PyTorch
runs the same sequence as calls: zero the grads, forward, backward,
optimizer update in place.  Multi-device layouts (data, tensor, sequence
or pipeline parallel, ZeRO), gradient accumulation, loss scaling and
bucketed gradient communication are not ported yet and raise
:class:`NotImplementedError`.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from ..optimizer.optimizer import Optimizer

__all__ = ["TrainState", "build_train_step"]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class TrainState:
    """The model, its bound optimizer and the loss function; ``step``
    runs one update."""

    def __init__(self, model: nn.Module, opt: Optimizer,
                 loss_fn: Callable[..., torch.Tensor]):
        self.model = model
        self.opt = opt
        self.loss_fn = loss_fn
        self.last_loss: Optional[torch.Tensor] = None
        self.step_count = 0

    def _device(self) -> Optional[torch.device]:
        p = next(self.model.parameters(), None)
        return None if p is None else p.device

    def step(self, batch, rng=None) -> torch.Tensor:
        """Zero the grads, ``loss = loss_fn(model, batch, rng)``,
        backward, optimizer step.  Returns the loss as a device tensor:
        like the JAX step, it does not wait for the device to fetch it."""
        dev = self._device()
        for t in _tensors(batch):
            if dev is not None and t.device != dev:
                raise ValueError(f"batch tensor on {t.device}, model on "
                                 f"{dev}")
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.model, batch, rng)
        loss.backward()
        self.opt.step()
        self.step_count += 1
        self.last_loss = loss.detach()
        return self.last_loss


def build_train_step(model: nn.Module, opt: Optimizer,
                     loss_fn: Optional[Callable[..., Any]] = None,
                     topo=None, zero_stage: int = 0, grad_accum: int = 1,
                     donate: bool = True, has_aux: bool = False,
                     scaler=None, value_and_grad_fn=None,
                     offload_opt_state: bool = False,
                     comm_bucket_mb: Optional[float] = None,
                     comm_dtype: Optional[str] = None) -> TrainState:
    """A :class:`TrainState` for ``loss_fn(model, batch, rng) -> scalar
    loss`` on the one device the model lives on.

    ``opt`` is an optimizer of :mod:`..optimizer`.  The JAX builder takes
    it unbound and initialises its state from the model; here an unbound
    optimizer is bound to ``model.named_parameters()`` (an optimizer
    already bound to these parameters is taken as it is).  ``donate`` is
    accepted: the update is in place.  Every other option is a
    multi-device or mixed-precision feature not ported yet and raises
    :class:`NotImplementedError`: ``topo`` (any topology), ``zero_stage >
    0``, ``grad_accum > 1``, ``has_aux``, ``scaler``,
    ``value_and_grad_fn``, ``offload_opt_state``, ``comm_bucket_mb`` and
    ``comm_dtype``.
    """
    refused = {
        "topo (multi-device meshes)": topo is not None,
        "zero_stage > 0": zero_stage > 0,
        "grad_accum > 1": grad_accum > 1,
        "has_aux": has_aux,
        "scaler (float16 loss scaling)": scaler is not None,
        "value_and_grad_fn (pipeline schedules)":
            value_and_grad_fn is not None,
        "offload_opt_state": offload_opt_state,
        "comm_bucket_mb / comm_dtype": (comm_bucket_mb is not None
                                        or comm_dtype is not None),
    }
    for what, asked in refused.items():
        if asked:
            raise NotImplementedError(
                f"build_train_step: {what} is not ported yet")
    if loss_fn is None:
        raise ValueError("pass loss_fn")
    if not opt.bound:
        opt.bind(model.named_parameters())
    else:
        mine = {id(p) for p in model.parameters()}
        if any(id(p) not in mine for g in opt.param_groups
               for p in g["params"]):
            raise ValueError("optimizer is bound to parameters that are "
                             "not the model's")
    return TrainState(model, opt, loss_fn)
