"""Functional ops on the GPT, UNet and BERT paths (counterparts of
``paddle_ray_tpu/nn/functional.py``).  Plain PyTorch; each matches the
JAX function's arithmetic, including where it computes in float32.

Dropout draws its mask from a key of :mod:`..core.prng`, bit for bit the
mask ``jax.random.bernoulli`` gives the JAX function under the same key;
given no key it takes :func:`..core.rng.next_key`, as the JAX function
does.  On CUDA it is one kernel (:mod:`..ops.dropout`).

Convolutions take and return channels-last tensors (``NHWC``) with the
JAX package's weight layouts.  They run ``torch.nn.functional``'s
convolution on the channels-last NCHW view of ``x`` with the weight in
``torch.channels_last``, so cuDNN runs its NHWC kernels and the result,
permuted back, is a contiguous NHWC tensor without a copy."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as _F

__all__ = ["gelu", "relu", "silu", "tanh", "dropout", "linear", "embedding",
           "layer_norm", "group_norm", "conv2d", "conv2d_transpose",
           "scaled_dot_product_attention", "cross_entropy"]


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """GELU; the tanh approximation by default, as ``jax.nn.gelu``
    (PyTorch's own default is the erf form)."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return _F.silu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def dropout(x: torch.Tensor, p: float, *, training: bool = True,
            rng=None, mode: str = "upscale_in_train") -> torch.Tensor:
    """``jax``-exact dropout: keep where ``prng.bernoulli(rng, 1 - p,
    x.shape)``; ``"upscale_in_train"`` divides the kept values by ``1 -
    p`` rounded to x's dtype, as the JAX function's weakly typed divisor
    is.  Without ``rng`` the key is :func:`..core.rng.next_key`'s.
    Differentiable; a CUDA tensor runs the dropout kernel forward and
    backward (:func:`..ops.dropout.dropout`)."""
    if not training or p == 0.0:
        return x
    if rng is None:
        from ..core import rng as _rng
        rng = _rng.next_key()
    from ..ops.dropout import dropout as _dropout
    return _dropout(x, rng, p, upscale=mode == "upscale_in_train")


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


def group_norm(x: torch.Tensor, num_groups: int,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """GroupNorm of channels-last ``x [N, ..., C]`` over all but the
    leading dim within each channel group, in float32 and cast back to
    ``x``'s dtype (the plain module forward; the UNet runs
    :func:`..ops.groupnorm.fused_group_norm`)."""
    *lead, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xf = x.float().reshape(*lead, num_groups, c // num_groups)
    red = tuple(range(1, xf.dim() - 2)) + (xf.dim() - 1,)
    mean = xf.mean(dim=red, keepdim=True)
    var = (xf - mean).square().mean(dim=red, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).reshape(*lead, c)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


_IntPair = Union[int, Sequence[int]]


def _pair(v: _IntPair) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    v = tuple(v)
    if len(v) != 2 or not all(isinstance(e, int) for e in v):
        raise NotImplementedError(
            f"{v!r}: only an int or two ints are ported (no string or "
            f"(low, high) padding)")
    return v


def _conv_out(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """NCHW (channels-last memory) -> NHWC, the bias added in the output's
    dtype."""
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: _IntPair = 1,
           padding: _IntPair = 0, dilation: _IntPair = 1,
           groups: int = 1) -> torch.Tensor:
    """2-D convolution of NHWC ``x``, weight ``(O, I/groups, kh, kw)`` (the
    JAX ``_convnd``): the weight cast to x's dtype, the bias added in the
    output's dtype."""
    w = weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
    y = _F.conv2d(x.permute(0, 3, 1, 2), w, None, _pair(stride),
                  _pair(padding), _pair(dilation), groups)
    return _conv_out(y, bias)


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     stride: _IntPair = 1, padding: _IntPair = 0,
                     output_padding: _IntPair = 0, groups: int = 1,
                     dilation: _IntPair = 1) -> torch.Tensor:
    """2-D transposed convolution of NHWC ``x``, weight ``(I, O/groups,
    kh, kw)`` (the JAX ``_conv_transpose_nd``): ``L_out = (L - 1) * stride
    - 2 p + dilation * (k - 1) + 1 + output_padding``."""
    w = weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
    y = _F.conv_transpose2d(x.permute(0, 3, 1, 2), w, None, _pair(stride),
                            _pair(padding), _pair(output_padding), groups,
                            _pair(dilation))
    return _conv_out(y, bias)


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None, *,
                                 causal: bool = False,
                                 scale: Optional[float] = None,
                                 dropout_p: float = 0.0, rng=None,
                                 training: bool = False) -> torch.Tensor:
    """Plain dense attention in the ``[B, S, H, D]`` layout: matmul, mask,
    float32 softmax, matmul -- the arithmetic of the JAX reference, not
    PyTorch's fused operator.  ``mask`` is boolean, broadcastable to
    ``[B, H, Sq, Sk]``; False logits become ``-inf`` (a row with no True
    entry gives NaN, as in JAX).  With ``dropout_p > 0`` and
    ``training``, the probabilities ``[B, H, Sq, Sk]`` (in q's dtype) go
    through :func:`dropout` under ``rng``."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float() * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        logits = logits.masked_fill(~mask.to(torch.bool), float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, training=True, rng=rng)
    return torch.matmul(probs, vh).transpose(1, 2)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  ignore_index: int = -100,
                  reduction: str = "mean") -> torch.Tensor:
    """Softmax cross-entropy over the last dim in float32 (the JAX
    ``cross_entropy`` with hard labels): labels equal to ``ignore_index``
    lose 0; ``"mean"`` divides by the count of the others, at least 1.
    Soft labels and label smoothing are not ported."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / torch.clamp(valid.float().sum(), min=1.0)
