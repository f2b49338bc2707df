"""Weight conversion between the JAX package's state dicts and the port's
models: the GPT (:class:`~.models.gpt.GPT`), BERT
(:class:`~.models.bert.BertForPretraining`), the UNet
(:class:`~.models.unet.UNet`) and the fused layers of
:mod:`~.incubate.nn` (the last two with the JAX keys as they are).

The JAX ``Module.state_dict()`` (``paddle_ray_tpu/core/module.py``) is a
flat ``{path: numpy array}`` dict.  Its parameter layout is the port's
(linear weights ``[in, out]``, fused QKV columns ``[h, 3, d]``), so the
conversion is a renaming: the JAX ``ModuleList`` names its children
``blocks.items.{i}`` (BERT's ``bert.layers.items.{i}``), PyTorch's
``blocks.{i}`` (``bert.layers.{i}``).  ``embedding.
position_embeddings`` is a bare array in JAX and a parameter here; a tied
head has no ``head.proj`` in either.

The state of a JAX ``quantize_for_decode`` model carries across too: its
linears hold ``weight_q`` (int8), ``scale`` and ``bias``, its embedding
``weight_q``, ``scale`` and the pre-transposed ``weight_qT``, with the qkv
columns already re-laid-out ``[3, h, d]``; the port builds the same int8
modules (:func:`..models.generation.quantize_for_decode`'s structure) and
copies the int8 values exactly.  So does the state of a model quantized by
the JAX ``quantize_model`` / ``PTQ`` / ``QAT.convert``: each
``QuantizedLinear``'s ``weight_q`` (int8 ``[in, out]``), ``weight_scale``
(float32 ``[1, out]``, or a scalar per tensor) and ``bias``, beside the
float layers' keys (:func:`quantized_from_jax_state_dict`).

A JAX optimizer's state carries over too (:func:`optimizer_from_jax_state`):
its step count, each slot under the JAX slot names (AdamW's ``m`` and
``v``, Momentum's ``velocity``, Adagrad's ``accum``, ...), as float32,
bfloat16 or ``QMoment`` codes and scales (``MemoryEfficientAdamW``), and
the float32 masters, each named as the JAX model names its parameters
(:func:`to_jax_key` maps the GPT's names), and a ``GradScaler``'s state,
so a run can resume mid-curve; :func:`train_state_from_jax_capture` takes
a whole JAX ``TrainState.capture()`` into a port train state.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import numpy as np
import torch

from .models.bert import BertConfig, BertForPretraining
from .models.generation import _quantize_in_place
from .models.gpt import GPT, GPTConfig
from .models.unet import UNet, UNetConfig
from .optimizer.memory_efficient import QMoment
from .parallel.api import TrainState
from .quantization.quant import quantize_model

__all__ = ["to_jax_key", "to_torch_key", "optimizer_from_jax_state",
           "train_state_from_jax_capture",
           "gpt_from_jax_state_dict", "gpt_to_jax_state_dict",
           "bert_from_jax_state_dict", "bert_to_jax_state_dict",
           "unet_from_jax_state_dict", "unet_to_jax_state_dict",
           "incubate_from_jax_state_dict", "incubate_to_jax_state_dict",
           "quantized_from_jax_state_dict", "quantized_to_jax_state_dict"]

_JAX_BLOCK = re.compile(r"^blocks\.items\.(\d+)\.")
_TORCH_BLOCK = re.compile(r"^blocks\.(\d+)\.")
_JAX_BERT_LAYER = re.compile(r"^bert\.layers\.items\.(\d+)\.")
_TORCH_BERT_LAYER = re.compile(r"^bert\.layers\.(\d+)\.")


def to_torch_key(key: str) -> str:
    """A JAX GPT parameter name as the port names it."""
    return _JAX_BLOCK.sub(r"blocks.\1.", key)


def to_jax_key(key: str) -> str:
    """A port GPT parameter name as the JAX package names it."""
    return _TORCH_BLOCK.sub(r"blocks.items.\1.", key)


def _part(value, name: str):
    """A field of a JAX ``QMoment`` / ``ScalerState``, or of a dict."""
    return value[name] if isinstance(value, dict) else getattr(value, name)


def _load_tensor(t: torch.Tensor, value, what: str) -> None:
    """Copy ``value`` into ``t`` exactly: integers as they are, floats via
    float32 (numpy has no bfloat16; a JAX bfloat16 value is exact in
    float32)."""
    arr = np.asarray(value)
    arr = (arr.astype(np.int64) if not t.is_floating_point()
           else arr.astype(np.float32))
    if arr.shape != tuple(t.shape):
        raise ValueError(f"shape mismatch for {what}: {arr.shape} vs "
                         f"{tuple(t.shape)}")
    t.copy_(torch.from_numpy(arr))


def optimizer_from_jax_state(opt, step: int,
                             slots: Dict[str, Dict[str, np.ndarray]],
                             master: Optional[Dict[str, np.ndarray]] = None,
                             *, scaler_state=None) -> None:
    """Load a JAX ``OptState`` into the bound optimizer ``opt`` (or the
    optimizer of a :class:`~.parallel.api.TrainState`) in place: ``step``,
    and for each parameter each of its slots (``slots[slot][jax name]``,
    under the JAX slot names: a float32 or bfloat16 array, or a JAX
    ``QMoment`` -- an object or dict with ``codes`` and ``scale`` -- for a
    quantized slot) and, where ``opt`` keeps one, its float32 master
    (``master[jax name]``), the JAX names being :func:`to_jax_key` of the
    port's.  ``scaler_state`` (a JAX ``ScalerState``, an object or dict of
    ``scale``, ``growth_tracker`` and ``bad_tracker``) goes into the
    TrainState's scaler state.  A missing entry or a shape that differs
    raises."""
    ts = None
    if isinstance(opt, TrainState):
        ts, opt = opt, opt.opt
    group = opt.param_groups[0]
    if None in group["names"]:
        raise ValueError("the optimizer's parameters have no names")
    # an offloaded state may still be receiving the last step's copies
    opt.wait_state()
    with torch.no_grad():
        for p, name in zip(group["params"], group["names"]):
            key = to_jax_key(name)
            st = opt.state[p]
            wanted = [(slot, slots[slot]) for slot in opt.slot_names]
            if "master" in st:
                if master is None:
                    raise KeyError("the optimizer keeps float32 masters: "
                                   "pass master=")
                wanted.append(("master", master))
            for slot, arrays in wanted:
                value, target = arrays[key], st[slot]
                what = f"{slot} of {key}"
                if isinstance(target, QMoment):
                    _load_tensor(target.codes, _part(value, "codes"), what)
                    _load_tensor(target.scale, _part(value, "scale"), what)
                else:
                    _load_tensor(target, value, what)
        if scaler_state is not None:
            if ts is None or ts.scaler_state is None:
                raise ValueError("scaler_state needs a TrainState built "
                                 "with a scaler")
            for field in ("scale", "growth_tracker", "bad_tracker"):
                _load_tensor(getattr(ts.scaler_state, field),
                             _part(scaler_state, field), field)
    group["step"] = int(step)


def _at(tree, path: str):
    """The leaf of a JAX module tree at the dotted ``path`` its
    ``named_parameters`` gives (attributes, list items by index)."""
    for part in path.split("."):
        tree = (tree[int(part)] if isinstance(tree, (list, tuple))
                else getattr(tree, part))
    return tree


def train_state_from_jax_capture(ts: TrainState, tree) -> TrainState:
    """Load a JAX ``TrainState.capture()`` (on the host, as
    ``jax.device_get`` returns it) into the port's GPT train state ``ts``
    in place: the model's state dict (:func:`gpt_from_jax_state_dict`'s
    renaming), the optimizer's step count, slots and masters and a
    ``GradScaler``'s state (:func:`optimizer_from_jax_state`), a
    host-driven schedule's live learning rate, and the step counter.  A
    run the JAX package began goes on in the port.  A capture with
    quantized-communication state (a multi-device feature) raises."""
    model, bundle = tree["model"], tree["opt"]
    scaler_state = None
    # the JAX bundle wraps the OptState in (inner, ScalerState | CommState)
    # pairs
    while isinstance(bundle, tuple) and len(bundle) == 2:
        bundle, wrapper = bundle
        if hasattr(wrapper, "residual"):
            raise NotImplementedError("the capture holds quantized-"
                                      "communication state, which the port "
                                      "does not run")
        scaler_state = wrapper
    given = {to_torch_key(k): v for k, v in model.state_dict().items()}
    names = [name for name, _ in model.named_parameters()]
    slots = {s: {n: _at(bundle.slots[s], n) for n in names}
             for s in bundle.slots}
    master = (None if bundle.master is None
              else {n: _at(bundle.master, n) for n in names})
    with torch.no_grad():
        _copy_state(ts.model, given, type(ts.model).__name__)
    optimizer_from_jax_state(ts, int(np.asarray(bundle.step)), slots, master,
                             scaler_state=scaler_state)
    if getattr(bundle, "lr_value", None) is not None:
        ts.opt.set_lr(float(np.asarray(bundle.lr_value)))
    ts.step_count = int(np.asarray(tree["step"]))
    return ts


def gpt_from_jax_state_dict(cfg: GPTConfig, state: Dict[str, np.ndarray], *,
                            device, dtype=None) -> GPT:
    """A :class:`GPT` for ``cfg`` on ``device`` holding the JAX state
    dict's weights, in ``dtype`` (default ``cfg.dtype``); a state with
    int8 ``weight_q`` entries gives the weight-only int8 decode model.  A
    missing or unexpected key, or a shape that differs, raises."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    given = {to_torch_key(k): v for k, v in state.items()}
    with torch.no_grad():
        model = GPT(cfg, device=device)
        if any(k.endswith(".weight_q") for k in given):
            _quantize_in_place(model)
        _copy_state(model, given, "GPT")
    return model


def _copy_state(model: torch.nn.Module, given: Dict[str, np.ndarray],
                what: str) -> None:
    """Copy ``given`` into ``model``'s state in place; a missing or
    unexpected key, or a shape that differs, raises."""
    targets = model.state_dict()
    missing = sorted(set(targets) - set(given))
    unexpected = sorted(set(given) - set(targets))
    if missing or unexpected:
        raise KeyError(f"state dict does not match the {what}: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")
    for name, t in targets.items():
        # int8 exactly; floats via float32 (numpy has no bfloat16)
        arr = np.array(given[name], dtype=(
            np.int8 if t.dtype == torch.int8 else np.float32))
        if arr.shape != tuple(t.shape):
            raise ValueError(f"shape mismatch for {name}: have "
                             f"{tuple(t.shape)}, got {arr.shape}")
        t.copy_(torch.from_numpy(arr))


def _float_state(model: torch.nn.Module, rename=lambda k: k
                 ) -> Dict[str, np.ndarray]:
    return {rename(name): t.detach().float().cpu().numpy()
            for name, t in model.state_dict().items()}


def _state_with_int8(model: torch.nn.Module, rename=lambda k: k
                     ) -> Dict[str, np.ndarray]:
    """float32 numpy arrays, and int8 ones for int8 values."""
    return {rename(name): (t.cpu().numpy() if t.dtype == torch.int8
                           else t.detach().float().cpu().numpy())
            for name, t in model.state_dict().items()}


def gpt_to_jax_state_dict(model: GPT) -> Dict[str, np.ndarray]:
    """The JAX-named state dict of ``model``: float32 numpy arrays, and
    int8 ones for an int8 decode model's values."""
    return _state_with_int8(model, to_jax_key)


def unet_from_jax_state_dict(cfg: UNetConfig, state: Dict[str, np.ndarray],
                             *, device, dtype=None) -> UNet:
    """A :class:`UNet` for ``cfg`` on ``device`` holding the JAX state
    dict's weights, in ``dtype`` (default ``cfg.dtype``).  A missing or
    unexpected key, or a shape that differs, raises."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    with torch.no_grad():
        model = UNet(cfg, device=device)
        _copy_state(model, state, "UNet")
    return model


def unet_to_jax_state_dict(model: UNet) -> Dict[str, np.ndarray]:
    """The JAX state dict of ``model``: float32 numpy arrays under the
    same keys."""
    return _float_state(model)


def bert_from_jax_state_dict(cfg: BertConfig, state: Dict[str, np.ndarray],
                             *, device, dtype=None) -> BertForPretraining:
    """A :class:`BertForPretraining` for ``cfg`` on ``device`` holding the
    JAX state dict's weights, in ``dtype`` (default ``cfg.dtype``).  A
    missing or unexpected key, or a shape that differs, raises."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    given = {_JAX_BERT_LAYER.sub(r"bert.layers.\1.", k): v
             for k, v in state.items()}
    with torch.no_grad():
        model = BertForPretraining(cfg, device=device)
        _copy_state(model, given, "BertForPretraining")
    return model


def bert_to_jax_state_dict(model: BertForPretraining
                           ) -> Dict[str, np.ndarray]:
    """The JAX-named state dict of ``model``: float32 numpy arrays."""
    return _float_state(
        model, lambda k: _TORCH_BERT_LAYER.sub(r"bert.layers.items.\1.", k))


def incubate_from_jax_state_dict(layer: torch.nn.Module,
                                 state: Dict[str, np.ndarray]
                                 ) -> torch.nn.Module:
    """Copy the JAX state dict of an :mod:`~.incubate.nn` layer into the
    port's ``layer`` of the same construction (the keys are the JAX ones)
    and return it.  A missing or unexpected key, or a shape that differs,
    raises."""
    with torch.no_grad():
        _copy_state(layer, state, type(layer).__name__)
    return layer


def incubate_to_jax_state_dict(layer: torch.nn.Module
                               ) -> Dict[str, np.ndarray]:
    """The JAX state dict of an :mod:`~.incubate.nn` layer: float32 numpy
    arrays under the same keys."""
    return _float_state(layer)


def quantized_from_jax_state_dict(model: torch.nn.Module,
                                  state: Dict[str, np.ndarray]
                                  ) -> torch.nn.Module:
    """Load the state of a JAX model quantized by ``quantize_model``,
    ``PTQ`` or ``QAT.convert`` into the port's float ``model`` of the same
    construction (the keys are the JAX ones, as for the ``incubate.nn``
    layers): ``model`` is quantized in place by :func:`..quantization.
    quantize_model` -- per channel or per tensor as the state's
    ``weight_scale`` entries say -- and the int8 weights, scales and every
    other entry are copied exactly.  Returns the quantized model (a root
    Linear is replaced).  A missing or unexpected key, or a shape that
    differs, raises."""
    scales = {np.ndim(a) for k, a in state.items()
              if k == "weight_scale" or k.endswith(".weight_scale")}
    if len(scales) > 1:
        raise ValueError("state mixes per-channel and per-tensor weight "
                         "scales; quantize_model gives one kind")
    with torch.no_grad():
        model = quantize_model(model, per_channel=scales != {0})
        _copy_state(model, state, type(model).__name__)
    return model


def quantized_to_jax_state_dict(model: torch.nn.Module
                                ) -> Dict[str, np.ndarray]:
    """The JAX state dict of a quantized model: int8 numpy arrays for the
    ``weight_q`` entries, float32 for the rest, under the same keys."""
    return _state_with_int8(model)
