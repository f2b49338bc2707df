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
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict

import numpy as np
import torch

from .models.bert import BertConfig, BertForPretraining
from .models.generation import _quantize_in_place
from .models.gpt import GPT, GPTConfig
from .models.unet import UNet, UNetConfig
from .quantization.quant import quantize_model

__all__ = ["gpt_from_jax_state_dict", "gpt_to_jax_state_dict",
           "bert_from_jax_state_dict", "bert_to_jax_state_dict",
           "unet_from_jax_state_dict", "unet_to_jax_state_dict",
           "incubate_from_jax_state_dict", "incubate_to_jax_state_dict",
           "quantized_from_jax_state_dict", "quantized_to_jax_state_dict"]

_JAX_BLOCK = re.compile(r"^blocks\.items\.(\d+)\.")
_TORCH_BLOCK = re.compile(r"^blocks\.(\d+)\.")
_JAX_BERT_LAYER = re.compile(r"^bert\.layers\.items\.(\d+)\.")
_TORCH_BERT_LAYER = re.compile(r"^bert\.layers\.(\d+)\.")


def _to_torch_key(key: str) -> str:
    return _JAX_BLOCK.sub(r"blocks.\1.", key)


def _to_jax_key(key: str) -> str:
    return _TORCH_BLOCK.sub(r"blocks.items.\1.", key)


def gpt_from_jax_state_dict(cfg: GPTConfig, state: Dict[str, np.ndarray], *,
                            device, dtype=None) -> GPT:
    """A :class:`GPT` for ``cfg`` on ``device`` holding the JAX state
    dict's weights, in ``dtype`` (default ``cfg.dtype``); a state with
    int8 ``weight_q`` entries gives the weight-only int8 decode model.  A
    missing or unexpected key, or a shape that differs, raises."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    given = {_to_torch_key(k): v for k, v in state.items()}
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
    return _state_with_int8(model, _to_jax_key)


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
