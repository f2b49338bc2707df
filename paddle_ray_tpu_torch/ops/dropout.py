"""Dropout under a threefry key: one hand-written CUDA pass
(``csrc/dropout.cu``) beside its plain PyTorch version.

It replaces no Pallas kernel.  The JAX package's dropout
(``paddle_ray_tpu/nn/functional.py:dropout``) is plain jnp,

    y = where(bernoulli(key, 1 - p, x.shape), x / keep, 0),

which XLA fuses into one pass on the TPU.  The port's plain version of the
mask is JAX's threefry hash as about 170 elementwise operations on int64
tensors (:mod:`..core.prng`), one launch each on the card: at GPT's width
that is tens of milliseconds a mask.  The kernel is the fused pass: each
element hashes its own counter in registers and the result is the plain
version's bit for bit (see the source for the arithmetic).

:func:`threefry_dropout` dispatches by device: a CUDA tensor (float32 or
bfloat16) launches the kernel and counts the launch in its
``launches``; a CPU tensor runs :func:`dropout_plain`.  There is no
fallback between the two.  :func:`dropout` is the differentiable entry:
its backward is the same function of ``dy`` under the same key (the
derivative of ``where(mask, x / keep, 0)``), so nothing is saved but the
key's two words.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from ..core import prng

__all__ = ["dropout", "threefry_dropout", "dropout_plain"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=64)
def _divisor(keep: float, dtype: torch.dtype) -> float:
    """``keep`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(keep, dtype=dtype))


def _check_p(p: float) -> float:
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout rate {p} outside [0, 1]")
    return 1.0 - p


def dropout_plain(x: torch.Tensor, key, p: float, *,
                  upscale: bool = True) -> torch.Tensor:
    """``where(prng.bernoulli(key, 1 - p, x.shape), x / keep, 0)``, the
    divisor ``1 - p`` rounded to x's dtype (the JAX weakly typed divisor)
    and applied as a division by a 0-d tensor (a true division on the
    card too); without ``upscale``, ``where(mask, x, 0)``."""
    keep = _check_p(p)
    mask = prng.bernoulli(prng.as_key(key, x.device), keep, x.shape)
    if upscale:
        x = x / torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("dropout")
    if lib.prt_dropout.argtypes is None:
        p, u, f, i = (ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float,
                      ctypes.c_int)
        lib.prt_dropout.argtypes = [p, p, ctypes.c_longlong, u, u, f, f, i,
                                    i, p]
        lib.prt_dropout.restype = ctypes.c_int
        lib.prt_dropout_error_string.argtypes = [ctypes.c_int]
        lib.prt_dropout_error_string.restype = ctypes.c_char_p
    return lib


def threefry_dropout(x: torch.Tensor, key, p: float, *,
                     upscale: bool = True) -> torch.Tensor:
    """Dropout of ``x`` under ``key`` (a :mod:`..core.prng` key): CUDA
    tensors launch ``prt_dropout`` on a contiguous copy of x (a new
    contiguous tensor out), CPU tensors run :func:`dropout_plain`."""
    if x.device.type == "cpu":
        return dropout_plain(x, key, p, upscale=upscale)
    if x.device.type != "cuda":
        raise ValueError(f"no dropout kernel for device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"dropout kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    keep = _check_p(p)
    k1, k2 = prng.key_words(key)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    divisor = _divisor(keep, x.dtype)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.prt_dropout(x.data_ptr(), y.data_ptr(), x.numel(), k1, k2,
                              float(np.float32(keep)), divisor, int(upscale),
                              _KERNEL_DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dropout kernel launch failed: cudaError {err} "
                           f"({lib.prt_dropout_error_string(err).decode()})")
    threefry_dropout.launches += 1
    return y


threefry_dropout.launches = 0


class _Dropout(torch.autograd.Function):
    """Dropout whose backward is the same kernel on ``dy`` under the same
    key: the mask is hashed again, never stored."""

    @staticmethod
    def forward(ctx, x, k1: int, k2: int, p: float, upscale: bool):
        ctx.args = ((k1, k2), p, upscale)
        return threefry_dropout(x, (k1, k2), p, upscale=upscale)

    @staticmethod
    def backward(ctx, dy):
        key, p, upscale = ctx.args
        return (threefry_dropout(dy, key, p, upscale=upscale), None, None,
                None, None)


def dropout(x: torch.Tensor, key, p: float, *,
            upscale: bool = True) -> torch.Tensor:
    """Differentiable dropout of ``x`` under ``key``: the JAX
    ``where(bernoulli(key, 1 - p, x.shape), x / keep, 0)`` bit for bit."""
    k1, k2 = prng.key_words(key)
    return _Dropout.apply(x, k1, k2, float(p), bool(upscale))
