"""Layers on the GPT, UNet and BERT paths (counterparts of
``paddle_ray_tpu/nn/layers.py``).  Parameters keep the JAX package's
names, shapes and initializers; each layer draws them from the passed
:class:`torch.Generator`.  ``Linear`` and the convolutions cast their
input to the AMP compute dtype inside :func:`..amp.auto_cast`."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..amp.auto_cast import cast_if_enabled
from . import functional as F
from . import init as I

__all__ = ["LayerNorm", "Linear", "Dropout", "GroupNorm", "Conv2D",
           "Conv2DTranspose"]


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with ``weight``/``bias`` parameters;
    normalises in float32 (:func:`functional.layer_norm`)."""

    def __init__(self, hidden: int, epsilon: float = 1e-5, *,
                 device: Optional[torch.device] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(hidden, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.weight, self.bias, self.epsilon)


class Linear(nn.Module):
    """``y = x W + b`` with the weight ``[in, out]``: xavier-uniform
    weight, zero bias."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(I.xavier_uniform(
            (in_features, out_features), device=device, dtype=dtype,
            generator=generator))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(cast_if_enabled(x), self.weight, self.bias)


class Dropout(nn.Module):
    """:func:`functional.dropout` with rate ``p`` while the module is in
    training mode, under the key passed to ``forward`` or, given none, a
    key drawn from the global tracker (:func:`..core.rng.next_key`)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        return F.dropout(x, self.p, training=self.training, rng=rng)


class GroupNorm(nn.Module):
    """GroupNorm of channels-last tensors with ``weight`` (ones) and ``bias`` (zeros) ``[C]``; its
    forward is the plain :func:`functional.group_norm` (the UNet calls the
    fused kernel with these parameters instead)."""

    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-5, *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_channels, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon)


class _Conv2DBase(nn.Module):
    """Shared conv plumbing: a kaiming-normal weight (fan_out, relu) drawn
    in the logical shape ``(O, I/groups, kh, kw)`` and stored in the
    layer's layout, kept in ``torch.channels_last`` memory; a zero bias."""

    TRANSPOSE = False

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 output_padding=0, *, bias: bool = True, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = F._pair(kernel_size)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.output_padding = output_padding
        w = I.kaiming_normal((out_channels, in_channels // groups, *k),
                             nonlinearity="relu", mode="fan_out",
                             device=device, dtype=dtype, generator=generator)
        if self.TRANSPOSE:
            # the fans read (O, I, *k); the storage is (I, O/groups, *k)
            w = w.reshape(in_channels, out_channels // groups, *k)
        self.weight = nn.Parameter(
            w.contiguous(memory_format=torch.channels_last))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device,
                                              dtype=dtype))
                     if bias else None)


class Conv2D(_Conv2DBase):
    """2-D convolution on ``NHWC`` tensors; weight ``(O, I/groups, kh,
    kw)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1, **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast_if_enabled(x)
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class Conv2DTranspose(_Conv2DBase):
    """2-D transposed convolution on ``NHWC`` tensors; weight ``(I,
    O/groups, kh, kw)``."""

    TRANSPOSE = True

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, output_padding=0, groups: int = 1,
                 dilation=1, **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, output_padding, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast_if_enabled(x)
        return F.conv2d_transpose(
            x, self.weight, self.bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)
