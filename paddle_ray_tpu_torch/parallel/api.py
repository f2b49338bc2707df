"""The train step (the port's counterpart of the single-device branch of
``paddle_ray_tpu/parallel/api.py``).

The JAX package compiles ``(model, opt_state, batch, rng) -> (model,
opt_state, loss)`` into one program with donated buffers.  Eager PyTorch
runs the same sequence as calls: zero the grads, forward, backward,
optimizer update in place.  As in JAX, the loss runs under
:func:`..core.rng.key_scope` of the step's key, and a draw from the key
tracker itself (a step given no key) raises.  Gradient accumulation cuts the batch into
micro-batches, each under its own key.  Multi-device layouts (data,
tensor, sequence or pipeline parallel, ZeRO), loss scaling, ``has_aux``,
optimizer-state offload and bucketed gradient communication are not
ported yet and raise :class:`NotImplementedError`.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from ..core import prng
from ..core import rng as _rng
from ..optimizer.optimizer import Optimizer

__all__ = ["TrainState", "build_train_step"]


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, x) for k, x in tree.items()}
    return tree


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
                 loss_fn: Callable[..., torch.Tensor], grad_accum: int = 1):
        self.model = model
        self.opt = opt
        self.loss_fn = loss_fn
        self.grad_accum = grad_accum
        self.last_loss: Optional[torch.Tensor] = None
        self.step_count = 0

    def _device(self) -> Optional[torch.device]:
        p = next(self.model.parameters(), None)
        return None if p is None else p.device

    def _loss(self, batch, rng) -> torch.Tensor:
        """``loss_fn`` under the key's scope, tracker draws refused (the
        JAX step's ``compute_loss``, whose trace refuses them)."""
        with _rng.refuse_default_draws():
            if rng is None:
                return self.loss_fn(self.model, batch, rng)
            with _rng.key_scope(rng):
                return self.loss_fn(self.model, batch, rng)

    def _micro_batches(self, batch) -> list:
        n = self.grad_accum
        for t in _tensors(batch):
            if t.dim() == 0 or t.shape[0] % n:
                raise ValueError(f"batch dim of {tuple(t.shape)} is not a "
                                 f"multiple of grad_accum {n}")
        split = _map(lambda t: t.reshape(n, t.shape[0] // n, *t.shape[1:]),
                     batch)
        return [_map(lambda t, i=i: t[i], split) for i in range(n)]

    def step(self, batch, rng=None) -> torch.Tensor:
        """Zero the grads, ``loss = loss_fn(model, batch, rng)``,
        backward, optimizer step.  Returns the loss as a device tensor:
        like the JAX step, it does not wait for the device to fetch it.

        With ``grad_accum = n > 1`` the batch's leading dim is cut into
        ``n`` micro-batches; micro-batch ``i`` gets ``split(rng, n)[i]``,
        the gradients are summed in the parameters' dtype and divided by
        ``n``, and the loss is the mean of the micro-batches' losses."""
        dev = self._device()
        for t in _tensors(batch):
            if dev is not None and t.device != dev:
                raise ValueError(f"batch tensor on {t.device}, model on "
                                 f"{dev}")
        self.opt.zero_grad(set_to_none=True)
        n = self.grad_accum
        if n == 1:
            loss = self._loss(batch, rng)
            loss.backward()
            loss = loss.detach()
        else:
            keys = [None] * n if rng is None else list(prng.split(rng, n))
            losses = []
            for mb, key in zip(self._micro_batches(batch), keys):
                loss = self._loss(mb, key)
                loss.backward()
                losses.append(loss.detach())
            # a divide by a tensor: a Python number would be a reciprocal
            # product on the card; a fill, not a copy from the host, which
            # would wait for the device
            divs = {}
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.grad is not None:
                        dt = p.grad.dtype
                        if dt not in divs:
                            divs[dt] = torch.full((), n, dtype=dt, device=dev)
                        p.grad.div_(divs[dt])
            loss = torch.stack(losses).sum() / torch.full(
                (), n, dtype=torch.float32, device=dev)
        self.opt.step()
        self.step_count += 1
        self.last_loss = loss
        return self.last_loss

    def set_lr(self, value: float) -> None:
        """The learning rate of the next steps, for a host-driven schedule
        (``lr.ReduceOnPlateau``): ``sched.step(metric)``, then
        ``ts.set_lr(sched.current_lr)``, as with the JAX step."""
        self.opt.set_lr(value)


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
    accepted: the update is in place.  ``grad_accum`` cuts each batch
    into that many micro-batches (see :meth:`TrainState.step`).  Every
    other option is a multi-device or mixed-precision feature not ported
    yet and raises :class:`NotImplementedError`: ``topo`` (any topology),
    ``zero_stage > 0``, ``has_aux``, ``scaler``, ``value_and_grad_fn``,
    ``offload_opt_state``, ``comm_bucket_mb`` and ``comm_dtype``.
    """
    refused = {
        "topo (multi-device meshes)": topo is not None,
        "zero_stage > 0": zero_stage > 0,
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
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be at least 1, got {grad_accum}")
    if not opt.bound:
        opt.bind(model.named_parameters())
    else:
        mine = {id(p) for p in model.parameters()}
        if any(id(p) not in mine for g in opt.param_groups
               for p in g["params"]):
            raise ValueError("optimizer is bound to parameters that are "
                             "not the model's")
    return TrainState(model, opt, loss_fn, grad_accum)
