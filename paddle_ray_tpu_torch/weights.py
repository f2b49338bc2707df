"""Weight conversion between the JAX package's GPT state dict and the
port's :class:`~.models.gpt.GPT`.

The JAX ``Module.state_dict()`` (``paddle_ray_tpu/core/module.py``) is a
flat ``{path: numpy array}`` dict.  Its parameter layout is the port's
(linear weights ``[in, out]``, fused QKV columns ``[h, 3, d]``), so the
conversion is a renaming: the JAX ``ModuleList`` names its children
``blocks.items.{i}``, PyTorch's ``blocks.{i}``.  ``embedding.
position_embeddings`` is a bare array in JAX and a parameter here; a tied
head has no ``head.proj`` in either.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict

import numpy as np
import torch

from .models.gpt import GPT, GPTConfig

__all__ = ["gpt_from_jax_state_dict", "gpt_to_jax_state_dict"]

_JAX_BLOCK = re.compile(r"^blocks\.items\.(\d+)\.")
_TORCH_BLOCK = re.compile(r"^blocks\.(\d+)\.")


def _to_torch_key(key: str) -> str:
    return _JAX_BLOCK.sub(r"blocks.\1.", key)


def _to_jax_key(key: str) -> str:
    return _TORCH_BLOCK.sub(r"blocks.items.\1.", key)


def gpt_from_jax_state_dict(cfg: GPTConfig, state: Dict[str, np.ndarray], *,
                            device, dtype=None) -> GPT:
    """A :class:`GPT` for ``cfg`` on ``device`` holding the JAX state
    dict's weights, in ``dtype`` (default ``cfg.dtype``).  A missing or
    unexpected key, or a shape that differs, raises."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    with torch.no_grad():
        model = GPT(cfg, device=device)
        params = dict(model.named_parameters())
        given = {_to_torch_key(k): v for k, v in state.items()}
        missing = sorted(set(params) - set(given))
        unexpected = sorted(set(given) - set(params))
        if missing or unexpected:
            raise KeyError(f"state dict does not match the GPT: missing "
                           f"{missing[:8]}, unexpected {unexpected[:8]}")
        for name, p in params.items():
            # via float32: numpy has no bfloat16 of its own
            arr = np.array(given[name], dtype=np.float32)
            if arr.shape != tuple(p.shape):
                raise ValueError(f"shape mismatch for {name}: have "
                                 f"{tuple(p.shape)}, got {arr.shape}")
            p.copy_(torch.from_numpy(arr))
    return model


def gpt_to_jax_state_dict(model: GPT) -> Dict[str, np.ndarray]:
    """The JAX-named state dict of ``model``, as float32 numpy arrays."""
    return {_to_jax_key(name): p.detach().float().cpu().numpy()
            for name, p in model.named_parameters()}
