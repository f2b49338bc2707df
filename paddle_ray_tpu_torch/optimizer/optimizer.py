"""Optimizers (the port's counterpart of
``paddle_ray_tpu/optimizer/optimizer.py``): ``SGD``, ``Momentum``,
``Adam``, ``AdamW``, ``Lamb``, ``Adamax``, ``Adadelta``, ``Adagrad``,
``RMSProp`` and ``LARS`` as :class:`torch.optim.Optimizer` subclasses with
the JAX package's arithmetic (and, in :mod:`.memory_efficient`,
``MemoryEfficientAdamW``).

What differs from ``torch.optim``, and follows the JAX update:

- every slot is float32 whatever the parameter's dtype (the storage hook
  :meth:`Optimizer._init_slot`, which ``MemoryEfficientAdamW`` overrides),
  and with ``multi_precision`` (the default) a bfloat16 or float16
  parameter keeps a float32 master copy that the update runs on, cast back
  into the parameter after each step (:meth:`Optimizer._cast_back`; a
  float32 parameter is its own master);
- each optimizer's ``_update`` is the JAX ``_update_leaf`` with its slot
  names, in its order of operations, each step one float32 operation: a
  division by a step-dependent number divides by a 0-d tensor (on the card
  a division by a Python number is a product with its reciprocal), bias
  corrections ``1 - beta ** t`` come from the host in float32, and Lamb's
  and LARS's norms and trust ratios stay on the device (``torch.where``,
  no host-device sync);
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
allocates the slots and master copies.  Updates run in place on the
parameters and state: eager PyTorch has no buffer donation, so this is its
counterpart.  Each parameter also has the index of its leaf in the JAX
flattening of the same module (attribute names sorted at each level, list
items in order), which keys ``MemoryEfficientAdamW``'s stochastic
rounding.

:meth:`Optimizer.offload_state` (``build_train_step(...,
offload_opt_state=True)``) keeps every state tensor in pinned host memory
between steps: each parameter's state is copied into device staging
buffers, updated there and copied back, all on the current stream without
a host-device sync.  The copies back may still be running when ``step``
returns: :meth:`Optimizer.wait_state` waits for them, and
``state_dict``, ``load_state_dict`` and ``weights.optimizer_from_jax_state``
call it before they touch the host state.
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

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb",
           "Adamax", "Adadelta", "Adagrad", "RMSProp", "LARS"]


def jax_leaf_order(names) -> list:
    """The index of each named parameter among the leaves of the JAX
    package's flattening of the same module: attribute names sorted at
    every level, list items (the port's numeric names) in order.  A bare
    parameter (no name) keeps its position."""
    if None in names:
        return list(range(len(names)))

    def key(name):
        return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                     for c in name.split("."))
    order = sorted(range(len(names)), key=lambda i: key(names[i]))
    index = [0] * len(names)
    for leaf, i in enumerate(order):
        index[i] = leaf
    return index


def _state_tensors(st: dict):
    """``(key, tensor)`` of every tensor of one parameter's state; a
    :class:`.memory_efficient.QMoment` slot gives its codes and scales."""
    for k, x in st.items():
        if isinstance(x, torch.Tensor):
            yield (k,), x
        else:
            yield (k, "codes"), x.codes
            yield (k, "scale"), x.scale


def _map_state(st: dict, fn) -> dict:
    """``st`` with ``fn(key, tensor)`` in place of each tensor."""
    out = {}
    for k, x in st.items():
        if isinstance(x, torch.Tensor):
            out[k] = fn((k,), x)
        else:
            out[k] = type(x)(codes=fn((k, "codes"), x.codes),
                             scale=fn((k, "scale"), x.scale))
    return out


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
        self._staging: Optional[dict] = None
        # recorded after a step's copies of the offloaded state back to the
        # host; waited on before the host reads or writes that state
        self._copied_back: Optional[torch.cuda.Event] = None
        self._consts: dict = {}
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
        self._check_params(params)
        super().__init__([{"params": params, "names": names, "step": 0,
                           "leaf_index": jax_leaf_order(names)}], {})
        for p in params:
            st = self.state[p]
            for slot in self.slot_names:
                st[slot] = self._init_slot(slot, p)
            if (self.multi_precision and p.is_floating_point()
                    and p.dtype != torch.float32):
                st["master"] = p.detach().float().contiguous()
        if self.lr.host_driven:
            self.set_lr(self.lr.current_lr)
        return self

    def _check_params(self, params) -> None:
        """Refuse parameters the optimizer cannot update (a subclass's
        hook)."""

    # -- storage hooks (MemoryEfficientAdamW stores quantized or bfloat16
    # slots and writes bfloat16 parameters back by stochastic rounding) --
    def _init_slot(self, name: str, p: torch.Tensor):
        """The zero state of slot ``name`` of ``p``: float32, contiguous."""
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def _cast_back(self, up: torch.Tensor, p: torch.Tensor) -> None:
        """Write the float32 update ``up`` into the parameter ``p``."""
        if up is not p:
            p.copy_(up)

    def state_nbytes(self) -> int:
        """Bytes of every state tensor (slots, codes, scales, masters)."""
        return sum(x.numel() * x.element_size()
                   for p in self.param_groups[0]["params"]
                   for _, x in _state_tensors(self.state[p]))

    # -- host offload ----------------------------------------------------
    def offload_state(self) -> None:
        """Keep every state tensor in pinned host memory between steps
        (the JAX ``offload_opt_state``): a step copies each parameter's
        state into device staging buffers (``non_blocking``), updates it
        there and copies it back the same way, all on the current stream,
        so a staging buffer is written again only after the stream has
        copied it out.  The buffers are sized by the largest parameter's
        state.  Parameters on the CPU: nothing changes (the JAX CPU
        branch)."""
        if not self.bound:
            raise RuntimeError("bind the optimizer before offloading it")
        params = self.param_groups[0]["params"]
        dev = next((p.device for p in params if p.device.type == "cuda"),
                   None)
        if dev is None or self._staging is not None:
            return
        if any(p.device != dev for p in params):
            raise ValueError("offload_opt_state takes parameters on one "
                             "device")
        sizes: dict = {}
        for p in params:
            st = self.state[p]
            for key, x in _state_tensors(st):
                n, dt = sizes.get(key, (0, x.dtype))
                sizes[key] = (max(n, x.numel()), dt)
            self.state[p] = _map_state(
                st, lambda key, x: x.detach().to("cpu").pin_memory())
        self._staging = {k: torch.empty(n, dtype=dt, device=dev)
                         for k, (n, dt) in sizes.items()}

    @property
    def offloaded(self) -> bool:
        return self._staging is not None

    def _stage(self, st: dict) -> dict:
        def put(key, x):
            view = self._staging[key][:x.numel()].view(x.shape)
            view.copy_(x, non_blocking=True)
            return view
        return _map_state(st, put)

    @staticmethod
    def _unstage(host: dict, staged: dict) -> None:
        for (_, h), (_, d) in zip(_state_tensors(host),
                                  _state_tensors(staged)):
            h.copy_(d, non_blocking=True)

    def wait_state(self) -> None:
        """Wait until the last step's copies of the offloaded state back
        to host memory are done, so the host may read or write ``state``;
        without offloading, return at once."""
        if self._copied_back is not None:
            self._copied_back.synchronize()
            self._copied_back = None

    def state_dict(self):
        self.wait_state()
        return super().state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.wait_state()
        super().load_state_dict(state_dict)

    def _const(self, value: float, device) -> torch.Tensor:
        """``value`` as a float32 0-d tensor on ``device``, made by a fill
        (a copy from the host would wait for the device) once a step."""
        key = (float(value), device)
        t = self._consts.get(key)
        if t is None:
            t = torch.full((), value, dtype=torch.float32, device=device)
            self._consts[key] = t
        return t

    def _div(self, x: torch.Tensor, value: float) -> torch.Tensor:
        """``x / value`` as one float32 division, on the card too."""
        return x / self._const(value, x.device)

    @staticmethod
    def _bias_corrections(t: int, *betas: float) -> Tuple[float, ...]:
        """``1 - beta ** t`` in float32 for each beta, as the JAX update
        computes them."""
        t32 = np.float32(t)
        return tuple(float(np.float32(1) - np.float32(b) ** t32)
                     for b in betas)

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
        live = [(p, name, idx) for p, name, idx in zip(
            group["params"], group["names"], group["leaf_index"])
            if p.grad is not None]
        grads = [p.grad for p, _, _ in live]
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        group["step"] += 1
        t = group["step"]
        lr = (self.lr_value if self.lr_value is not None
              else float(np.float32(self.lr(t))))
        self._consts = {}
        for (p, name, idx), g in zip(live, grads):
            host = self.state[p]
            st = host if self._staging is None else self._stage(host)
            self._step_leaf(p, g, st, lr, t, self._decays(p, name), idx)
            if st is not host:
                self._unstage(host, st)
        if self._staging is not None and live:
            dev = next(iter(self._staging.values())).device
            self._copied_back = torch.cuda.Event()
            self._copied_back.record(torch.cuda.current_stream(dev))
        return loss

    def _step_leaf(self, p: torch.Tensor, g: torch.Tensor, st: dict,
                   lr: float, t: int, decays: bool, leaf_idx: int) -> None:
        """One parameter's update (the JAX base step's loop body): the
        float32 working copy and gradient, the L1 / L2 decay, the update
        rule, the cast back."""
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
        self._cast_back(p32, p)

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
        bc1, bc2 = self._bias_corrections(t, b1, b2)
        upd = self._div(m, bc1) / (self._div(v, bc2).sqrt() + self.epsilon)
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


class SGD(Optimizer):
    """``p - lr * (g + wd p)``."""

    def _update(self, p, g, st, lr, t, wd):
        if wd:
            g = g + wd * p
        p.sub_(lr * g)


class Momentum(Optimizer):
    """Heavy-ball momentum: ``v = momentum v + g``; the step is ``v``, or
    ``g + momentum v`` with ``use_nesterov``."""

    slot_names = ("velocity",)

    def __init__(self, learning_rate=1e-3, momentum: float = 0.9,
                 use_nesterov: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _update(self, p, g, st, lr, t, wd):
        if wd:
            g = g + wd * p
        v = st["velocity"]
        v.mul_(self.momentum).add_(g)
        upd = g + self.momentum * v if self.use_nesterov else v
        p.sub_(lr * upd)


class Lamb(Optimizer):
    """Adam's direction plus ``wd p``, scaled by the trust ratio
    ``|p| / |r|`` (1 where either norm is 0), computed on the device."""

    slot_names = ("m", "v")

    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lamb_weight_decay: float = 0.01, **kw):
        kw.setdefault("weight_decay", lamb_weight_decay)
        super().__init__(learning_rate, **kw)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def _update(self, p, g, st, lr, t, wd):
        b1, b2 = self.beta1, self.beta2
        m, v = st["m"], st["v"]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        bc1, bc2 = self._bias_corrections(t, b1, b2)
        r = self._div(m, bc1) / (self._div(v, bc2).sqrt() + self.epsilon)
        if wd:
            r = r + wd * p
        pn = p.square().sum().sqrt()
        rn = r.square().sum().sqrt()
        trust = torch.where((pn > 0) & (rn > 0), pn / rn, 1.0)
        p.sub_((lr * trust) * r)


class Adamax(Optimizer):
    """``m = b1 m + (1 - b1) g``, ``u = max(|g|, b2 u + eps)`` (epsilon
    inside the max, the reference's placement), ``p -= lr / (1 - b1^t) *
    m / u``."""

    slot_names = ("m", "inf_norm")

    def __init__(self, learning_rate=1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def _update(self, p, g, st, lr, t, wd):
        if wd:
            g = g + wd * p
        m, u = st["m"], st["inf_norm"]
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        torch.maximum(g.abs(), u * self.beta2 + self.epsilon, out=u)
        (bc,) = self._bias_corrections(t, self.beta1)
        step = float(np.float32(lr) / np.float32(bc))
        p.sub_(step * m / u)


class Adadelta(Optimizer):
    """``Eg = rho Eg + (1 - rho) g^2``, ``d = -sqrt((Edx + eps) / (Eg +
    eps)) g``, ``Edx = rho Edx + (1 - rho) d^2``, ``p += d``: no
    learning-rate factor (``learning_rate`` is accepted and unused, as in
    the reference)."""

    slot_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=1e-3, epsilon: float = 1e-6,
                 rho: float = 0.95, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon
        self.rho = rho

    def _update(self, p, g, st, lr, t, wd):
        if wd:
            g = g + wd * p
        eg, edx = st["avg_squared_grad"], st["avg_squared_update"]
        eg.mul_(self.rho).add_((1 - self.rho) * g.square())
        d = -torch.sqrt((edx + self.epsilon) / (eg + self.epsilon)) * g
        edx.mul_(self.rho).add_((1 - self.rho) * d.square())
        p.add_(d)


class Adagrad(Optimizer):
    """``acc += g^2``, ``p -= lr g / (sqrt(acc) + eps)``."""

    slot_names = ("accum",)

    def __init__(self, learning_rate=1e-2, epsilon: float = 1e-10, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon

    def _update(self, p, g, st, lr, t, wd):
        if wd:
            g = g + wd * p
        acc = st["accum"]
        acc.add_(g.square())
        p.sub_(lr * g / (acc.sqrt() + self.epsilon))


class RMSProp(Optimizer):
    """``ms = rho ms + (1 - rho) g^2``, ``p -= lr g / sqrt(ms + eps)``."""

    slot_names = ("mean_square",)

    def __init__(self, learning_rate=1e-2, rho: float = 0.95,
                 epsilon: float = 1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.rho = rho
        self.epsilon = epsilon

    def _update(self, p, g, st, lr, t, wd):
        if wd:
            g = g + wd * p
        ms = st["mean_square"]
        ms.mul_(self.rho).add_((1 - self.rho) * g.square())
        p.sub_(lr * g / (ms + self.epsilon).sqrt())


class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: the trust ratio ``coeff |p| /
    (|g| + wd |p| + eps)`` (1 where either norm is 0), computed on the
    device, scales a momentum step."""

    slot_names = ("velocity",)

    def __init__(self, learning_rate=1e-2, momentum: float = 0.9,
                 lars_coeff: float = 1e-3, epsilon: float = 1e-9, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.epsilon = epsilon

    def _update(self, p, g, st, lr, t, wd):
        pn = p.square().sum().sqrt()
        gn = g.square().sum().sqrt()
        trust = torch.where((pn > 0) & (gn > 0),
                            self.lars_coeff * pn
                            / (gn + wd * pn + self.epsilon), 1.0)
        v = st["velocity"]
        v.mul_(self.momentum).add_((trust * lr) * (g + wd * p))
        p.sub_(v)
