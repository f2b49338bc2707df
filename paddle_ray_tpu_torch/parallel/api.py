"""The train step (the port's counterpart of the single-device branch of
``paddle_ray_tpu/parallel/api.py``).

The JAX package compiles ``(model, opt_state, batch, rng) -> (model,
opt_state, loss)`` into one program with donated buffers.  Eager PyTorch
runs the same sequence as calls: zero the grads, forward, backward,
optimizer update in place.  As in JAX, the loss runs under
:func:`..core.rng.key_scope` of the step's key, and a draw from the key
tracker itself (a step given no key) raises.  Gradient accumulation cuts the batch into
micro-batches, each under its own key.  ``has_aux`` takes the model's
buffers from the model the loss function returns; a ``scaler``
(:class:`..amp.GradScaler`) scales the loss, unscales and checks the
gradients and skips the update of a step whose gradients are not finite;
``offload_opt_state`` keeps the optimizer's state in pinned host memory
between steps (:meth:`..optimizer.Optimizer.offload_state`).
Multi-device layouts (data, tensor, sequence or pipeline parallel, ZeRO)
and bucketed gradient communication are not ported yet and raise
:class:`NotImplementedError`.
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
    runs one update.  With a scaler, ``scaler_state`` is its
    :class:`..amp.ScalerState` (device tensors)."""

    def __init__(self, model: nn.Module, opt: Optimizer,
                 loss_fn: Callable[..., Any], grad_accum: int = 1,
                 has_aux: bool = False, scaler=None):
        self.model = model
        self.opt = opt
        self.loss_fn = loss_fn
        self.grad_accum = grad_accum
        self.has_aux = has_aux
        self.scaler = scaler
        self.scaler_state = (None if scaler is None
                             else scaler.init_state(self._device()))
        self.last_loss: Optional[torch.Tensor] = None
        self.step_count = 0

    def _device(self) -> Optional[torch.device]:
        p = next(self.model.parameters(), None)
        return None if p is None else p.device

    def _loss(self, batch, rng):
        """``(loss, updated model or None)``: ``loss_fn`` under the key's
        scope, tracker draws refused (the JAX step's ``compute_loss``,
        whose trace refuses them)."""
        with _rng.refuse_default_draws():
            if rng is None:
                out = self.loss_fn(self.model, batch, rng)
            else:
                with _rng.key_scope(rng):
                    out = self.loss_fn(self.model, batch, rng)
        return out if self.has_aux else (out, None)

    def _backward(self, loss: torch.Tensor, updated) -> torch.Tensor:
        """Backward of the (scaled) loss, then the buffers of the model
        ``loss_fn`` returned taken into the model (after the backward, which
        may need the old values): the next micro-batch and the next step
        see them.  Returns the detached loss."""
        if self.scaler is not None:
            self.scaler.scale(loss, self.scaler_state).backward()
        else:
            loss.backward()
        if updated is not None and updated is not self.model:
            mine = dict(self.model.named_buffers())
            with torch.no_grad():
                for name, b in updated.named_buffers():
                    if name not in mine:
                        raise KeyError(f"loss_fn returned a model with a "
                                       f"buffer {name!r} the model lacks")
                    mine[name].copy_(b)
        return loss.detach()

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
            loss = self._backward(*self._loss(batch, rng))
        else:
            keys = [None] * n if rng is None else list(prng.split(rng, n))
            losses = []
            for mb, key in zip(self._micro_batches(batch), keys):
                losses.append(self._backward(*self._loss(mb, key)))
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
        if self.scaler is None:
            self.opt.step()
        else:
            self._scaled_step()
        self.step_count += 1
        self.last_loss = loss
        return self.last_loss

    def _scaled_step(self) -> None:
        """Unscale and check the gradients; update unless one is not
        finite, then advance the scaler.  A skipped step leaves the
        parameters, every slot, the masters and the optimizer's step count
        as they were (the JAX step keeps the whole optimizer state).  The
        step count lives on the host, so ``found_inf`` is read there: one
        host-device sync a step, with a scaler only."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        grads, found_inf = self.scaler.unscale_and_check(
            [p.grad for p in params], self.scaler_state)
        for p, g in zip(params, grads):
            p.grad = g
        if not bool(found_inf):
            self.opt.step()
        self.scaler_state = self.scaler.update(self.scaler_state, found_inf)

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
    into that many micro-batches (see :meth:`TrainState.step`).

    ``has_aux=True``: ``loss_fn`` returns ``(loss, updated_model)``; the
    buffers (non-parameter tensors, e.g. running statistics) of
    ``updated_model`` replace the model's after each micro-batch's
    backward, so the next micro-batch and the next step see them.  A
    ``loss_fn`` that updates the model's buffers in place returns the
    model itself.

    ``scaler``: an :class:`..amp.GradScaler`; the step scales the loss,
    unscales and checks the gradients in float32, skips the optimizer
    update of a step with a non-finite gradient and advances the scaler
    (``TrainState.scaler_state``).

    ``offload_opt_state=True``: on CUDA, the optimizer's state lives in
    pinned host memory between steps and is staged through device buffers
    around each parameter's update (:meth:`..optimizer.Optimizer.
    offload_state`); on the CPU it changes nothing, as in JAX.

    Every other option is a multi-device feature not ported yet and raises
    :class:`NotImplementedError`: ``topo`` (any topology), ``zero_stage >
    0``, ``value_and_grad_fn``, ``comm_bucket_mb`` and ``comm_dtype``.
    """
    refused = {
        "topo (multi-device meshes)": topo is not None,
        "zero_stage > 0": zero_stage > 0,
        "value_and_grad_fn (pipeline schedules)":
            value_and_grad_fn is not None,
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
    if offload_opt_state:
        opt.offload_state()
    return TrainState(model, opt, loss_fn, grad_accum, has_aux, scaler)
