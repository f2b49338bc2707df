"""Fused transformer layers (the port of ``paddle_ray_tpu/incubate/nn.py``,
reference ``python/paddle/incubate/nn/layer/fused_transformer.py``): the
layer surface over the port's fused kernels.

- attention cores run the flash kernels (:mod:`..ops.flash_attention`),
  a padding ``attn_mask`` read in place as a ``-1e30`` bias;
- every post-LN dropout + residual + LayerNorm boundary runs the fused
  dropout-add-LayerNorm kernels (:mod:`..ops.fused`); pre-LN runs
  :func:`..nn.functional.dropout` and the residual add, as in JAX;
- the fused QKV is laid out ``(b, s, 3, heads, d)`` (GPT's and BERT's
  are ``(b, s, heads, 3, d)``).

Parameters keep the JAX names (``qkv``, ``out_proj``, ``pre_ln``,
``ln_scale``, ``ln_bias``, ``linear1``, ``linear2``, ``bias``), so a JAX
state dict loads key for key.  Keys are :mod:`..core.prng` keys split as
the JAX layers split them; without a key, dropout in training draws from
the global key tracker (:func:`..core.rng.next_key`), as in JAX.  Layers are built on ``device``
(CUDA unless the caller names the CPU), linear weights drawn from
``generator``.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn

from ..core import dtypes as _dt
from ..core import prng
from ..device import resolve_device
from ..nn import functional as F
from ..nn.layers import LayerNorm, Linear
from ..ops.flash_attention import flash_attention
from ..ops.fused import fused_dropout_add_layernorm

__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer"]


def _residual_epilogue(h, residual, *, rate, ln_scale, ln_bias, epsilon,
                       normalize_before, training, rng):
    """Shared tail of every fused block: pre-LN = dropout + residual,
    post-LN = the fused dropout-add-LayerNorm kernel."""
    if normalize_before:
        if rate and training:
            h = F.dropout(h, rate, training=True, rng=rng)
        return residual + h
    return fused_dropout_add_layernorm(
        h, residual, ln_scale, ln_bias, p=rate, epsilon=epsilon, rng=rng,
        training=training)[0]


def _vector(n: int, fill: float, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.full((n,), fill, device=device, dtype=dtype))


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """``LayerNorm(dropout(x + bias) + residual)`` in one kernel
    (reference ``fused_transformer.py:82``)."""

    def __init__(self, embed_dim: int, dropout_rate: float = 0.5,
                 epsilon: float = 1e-5, dtype=None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        dt = _dt.canonicalize_dtype(dtype)
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.bias = _vector(embed_dim, 0.0, device, dt)
        self.ln_scale = _vector(embed_dim, 1.0, device, dt)
        self.ln_bias = _vector(embed_dim, 0.0, device, dt)

    def forward(self, x: torch.Tensor, residual: torch.Tensor,
                rng=None) -> torch.Tensor:
        y, _ = fused_dropout_add_layernorm(
            x + self.bias, residual, self.ln_scale, self.ln_bias,
            p=self.dropout_rate, epsilon=self.epsilon, rng=rng,
            training=self.training)
        return y


class FusedMultiHeadAttention(nn.Module):
    """Pre/post-LN fused self-attention block (reference
    ``fused_transformer.py:192``): LN? -> fused qkv -> flash attention ->
    out proj -> dropout + residual (+ LN).  Always includes the residual,
    like the reference kernel."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dropout_rate: float = 0.5, attn_dropout_rate: float = 0.5,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 normalize_before: bool = False, need_weights: bool = False,
                 epsilon: float = 1e-5, dtype=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if (kdim not in (None, embed_dim)
                or vdim not in (None, embed_dim)):
            raise ValueError("fused attention requires kdim == vdim == "
                             "embed_dim (the reference kernel's contract)")
        if need_weights:
            raise ValueError("need_weights is unsupported: the flash "
                             "kernel never materializes the attention "
                             "matrix (reference raises too)")
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        device = resolve_device(device)
        dt = _dt.canonicalize_dtype(dtype)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        if attn_dropout_rate:
            warnings.warn(
                "attn_dropout_rate is not applied: the flash kernel "
                "never materializes attention probabilities to drop "
                "(use nn.MultiHeadAttention for prob dropout)",
                stacklevel=2)
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        kw = dict(device=device, dtype=dt, generator=generator)
        self.qkv = Linear(embed_dim, 3 * embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)
        self.pre_ln = LayerNorm(embed_dim, epsilon, device=device, dtype=dt)
        self.ln_scale = _vector(embed_dim, 1.0, device, dt)
        self.ln_bias = _vector(embed_dim, 0.0, device, dt)

    def forward(self, x: torch.Tensor, attn_mask=None,
                rng=None) -> torch.Tensor:
        b, s, _ = x.shape
        residual = x
        h = self.pre_ln(x) if self.normalize_before else x
        qkv = self.qkv(h).reshape(b, s, 3, self.num_heads, -1)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        o = flash_attention(q, k, v, causal=False, attn_mask=attn_mask)
        o = self.out_proj(o.reshape(b, s, self.embed_dim))
        return _residual_epilogue(
            o, residual, rate=self.dropout_rate, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, epsilon=self.epsilon,
            normalize_before=self.normalize_before,
            training=self.training, rng=rng)


class FusedFeedForward(nn.Module):
    """Pre/post-LN fused FFN block (reference ``fused_transformer.py:497``):
    LN? -> linear -> act (+ dropout) -> linear -> dropout + residual (+
    LN)."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, activation: str = "relu",
                 act_dropout_rate: Optional[float] = None,
                 normalize_before: bool = False, epsilon: float = 1e-5,
                 dtype=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        dt = _dt.canonicalize_dtype(dtype)
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation = activation
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        kw = dict(device=device, dtype=dt, generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.pre_ln = LayerNorm(d_model, epsilon, device=device, dtype=dt)
        self.ln_scale = _vector(d_model, 1.0, device, dt)
        self.ln_bias = _vector(d_model, 0.0, device, dt)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        residual = x
        h = self.pre_ln(x) if self.normalize_before else x
        h = getattr(F, self.activation)(self.linear1(h))
        k_act = k_out = rng
        if rng is not None:
            k_act, k_out = prng.split(rng)   # one use per key
        if self.act_dropout_rate and self.training:
            h = F.dropout(h, self.act_dropout_rate, training=True, rng=k_act)
        h = self.linear2(h)
        return _residual_epilogue(
            h, residual, rate=self.dropout_rate, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, epsilon=self.epsilon,
            normalize_before=self.normalize_before,
            training=self.training, rng=k_out)


class FusedTransformerEncoderLayer(nn.Module):
    """Reference ``fused_transformer.py:725``: fused attention + fused FFN
    with the shared pre/post-LN switch."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, activation: str = "relu",
                 attn_dropout_rate: Optional[float] = None,
                 act_dropout_rate: Optional[float] = None,
                 normalize_before: bool = False, dtype=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src: torch.Tensor, src_mask=None,
                rng=None) -> torch.Tensor:
        keys = prng.split(rng) if rng is not None else (None, None)
        h = self.fused_attn(src, attn_mask=src_mask, rng=keys[0])
        return self.ffn(h, rng=keys[1])
