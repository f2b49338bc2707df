"""Megatron-style tensor-parallel layers at degree 1 (counterparts of
``paddle_ray_tpu/parallel/tp.py``).

The weights keep the JAX layout ``[in, out]`` so state dicts carry over
unchanged: ``y = x @ W + b``.  Parameters are drawn from
``normal(0, std)`` with the caller's :class:`torch.Generator`; biases
start at zero, as in the JAX package.  The linears cast their input to the
AMP compute dtype inside :func:`..amp.auto_cast`."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..amp.auto_cast import cast_if_enabled
from ..nn import functional as F

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "normal_parameter"]


def normal_parameter(shape, std: float, *, device, dtype,
                     generator: Optional[torch.Generator]) -> nn.Parameter:
    """A parameter drawn from ``normal(0, std)`` with ``generator``."""
    t = torch.empty(shape, device=device, dtype=dtype)
    t.normal_(0.0, std, generator=generator)
    return nn.Parameter(t)


class _Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, *,
                 has_bias: bool = True, std: float = 0.02,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = normal_parameter((in_features, out_features), std,
                                       device=device, dtype=dtype,
                                       generator=generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(cast_if_enabled(x), self.weight, self.bias)


class ColumnParallelLinear(_Linear):
    """Weight split along the output dim under TP; whole at degree 1."""


class RowParallelLinear(_Linear):
    """Weight split along the input dim under TP; whole at degree 1."""


class VocabParallelEmbedding(nn.Module):
    """Vocabulary-sharded embedding under TP; whole at degree 1."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 std: float = 0.02, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = normal_parameter((num_embeddings, embedding_dim), std,
                                       device=device, dtype=dtype,
                                       generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class ParallelCrossEntropy(nn.Module):
    """Softmax cross-entropy over the vocabulary (vocab-sharded under TP;
    whole at degree 1).  ``forward(logits [..., V], labels [...]) ->
    per-token loss [...]`` in float32: a max-shifted log-sum-exp minus the
    label's logit.  Labels are clipped into ``[0, V)`` before the gather so
    ``ignore_index`` never indexes, and ignored rows are 0."""

    def __init__(self, *, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        lf = logits.float()
        m = lf.amax(-1, keepdim=True)
        logz = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
        idx = labels.long().clamp(0, lf.shape[-1] - 1)
        target = torch.gather(lf, -1, idx[..., None])[..., 0]
        loss = logz - target
        valid = labels != self.ignore_index
        return torch.where(valid, loss, torch.zeros_like(loss))
