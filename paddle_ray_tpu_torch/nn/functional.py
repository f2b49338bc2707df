"""Functional ops on the GPT path (counterparts of
``paddle_ray_tpu/nn/functional.py``).  Plain PyTorch; each matches the
JAX function's arithmetic, including where it computes in float32."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as _F

__all__ = ["gelu", "relu", "silu", "linear", "embedding", "layer_norm",
           "scaled_dot_product_attention"]


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """GELU; the tanh approximation by default, as ``jax.nn.gelu``
    (PyTorch's own default is the erf form)."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return _F.silu(x)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = x @ W (+ b)`` with the weight laid out ``[in, out]``."""
    y = torch.matmul(x, weight.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return weight[ids]


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim, computed in float32 and cast back to
    ``x``'s dtype (so a bfloat16 model normalises in float32)."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, causal: bool = False,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain dense attention in the ``[B, S, H, D]`` layout: matmul, mask,
    float32 softmax, matmul -- the arithmetic of the JAX reference, not
    PyTorch's fused operator."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float() * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)
