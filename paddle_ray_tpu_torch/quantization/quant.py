"""Weight-only int8 for decode (the port of the parts of
``paddle_ray_tpu/quantization/quant.py`` that ``quantize_for_decode``
uses).

Symmetric per-channel int8: ``scale = max(max|x|, 1e-8) / 127`` over the
reduced axes, ``q = clip(round(x / scale), -128, 127)`` (round half to
even, as ``jnp.round``), both in float32 -- the same bits as the JAX
package.  :class:`WeightOnlyInt8Linear` keeps activations exact and scales
each output channel; :class:`WeightOnlyInt8Embedding` scales each row and
serves the tied LM head through a pre-transposed copy.  The modules hold
their tensors as buffers: they are inference-only.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..ops.decode_matmul import MAX_KERNEL_ROWS, int8_stream_matmul

__all__ = ["quantize_per_channel", "replace_layers", "WeightOnlyInt8Linear",
           "WeightOnlyInt8Embedding"]


def quantize_per_channel(x: torch.Tensor, axis: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (along ``axis``) symmetric int8 quantization -> (int8
    values, float32 scales with ``axis`` kept and the rest reduced to 1)."""
    x = x.float()
    red = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    scale = torch.clamp(x.abs().amax(dim=red, keepdim=True), min=1e-8) / 127
    q = torch.clamp(torch.round(x / scale), -128, 127)
    return q.to(torch.int8), scale


def replace_layers(model: nn.Module, predicate: Callable[[nn.Module], bool],
                   make: Callable[[nn.Module], nn.Module]) -> nn.Module:
    """Replace, in place, every submodule for which ``predicate`` holds by
    ``make(submodule)`` (the ``nn.Module`` walk that stands in for the JAX
    package's ``_replace_layers``).  A root that matches is replaced too:
    use the return value."""
    if predicate(model):
        return make(model)
    for name, child in list(model.named_children()):
        setattr(model, name, replace_layers(child, predicate, make))
    return model


class WeightOnlyInt8Linear(nn.Module):
    """Weight-only int8 linear: ``y = (x @ w_q) * scale (+ bias)`` with
    per-output-channel scales; ``w_q`` is ``[in, out]`` int8.

    Up to :data:`~..ops.decode_matmul.MAX_KERNEL_ROWS` rows (decode) go
    through :func:`~..ops.decode_matmul.int8_stream_matmul`; more rows
    (prefill) take one plain ``torch.matmul`` on the widened weight, with
    the scale and bias in x's dtype, as the JAX package does."""

    def __init__(self, weight_q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_weight(cls, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None
                    ) -> "WeightOnlyInt8Linear":
        q, s = quantize_per_channel(weight.detach(), axis=1)
        return cls(q, s.reshape(-1),
                   None if bias is None else bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        rows = lead.numel()
        if rows <= MAX_KERNEL_ROWS:
            y = int8_stream_matmul(x.reshape(rows, x.shape[-1]),
                                   self.weight_q, self.scale, self.bias)
            return y.reshape(*lead, -1)
        y = torch.matmul(x, self.weight_q.to(x.dtype))
        y = y * self.scale.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class WeightOnlyInt8Embedding(nn.Module):
    """Int8 embedding table ``[V, H]`` with per-row scales; the tied LM
    head reuses them: ``logits = (h @ w_q^T) * scale``, through the
    pre-transposed ``weight_qT [H, V]`` for the weight-streaming kernel."""

    def __init__(self, weight_q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32,
                 weight_qT: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        self.register_buffer("weight_qT", weight_qT)
        self.out_dtype = out_dtype

    @classmethod
    def from_weight(cls, weight: torch.Tensor) -> "WeightOnlyInt8Embedding":
        q, s = quantize_per_channel(weight.detach(), axis=0)
        return cls(q, s.reshape(-1), weight.dtype, q.T.contiguous())

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.weight_q[ids]
        s = self.scale[ids].to(self.out_dtype)
        return rows.to(self.out_dtype) * s[..., None]
