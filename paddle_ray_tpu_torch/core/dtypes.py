"""Dtype names -> :class:`torch.dtype` (the port's counterpart of
``paddle_ray_tpu/core/dtypes.py``).  The default parameter dtype is
float32; it is fixed rather than process-global state."""
from __future__ import annotations

import torch

__all__ = ["float32", "float16", "bfloat16", "float64", "int8", "int16",
           "int32", "int64", "uint8", "bool_", "complex64",
           "canonicalize_dtype", "get_default_dtype"]

float32 = torch.float32
float16 = torch.float16
bfloat16 = torch.bfloat16
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64

_ALIASES = {
    "float32": float32, "fp32": float32, "float": float32,
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "uint8": uint8, "bool": bool_, "complex64": complex64,
}


def get_default_dtype() -> torch.dtype:
    return float32


def canonicalize_dtype(dtype) -> torch.dtype:
    """None -> the default; a name -> its dtype; a :class:`torch.dtype`
    as is."""
    if dtype is None:
        return get_default_dtype()
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _ALIASES[dtype]
        except KeyError:
            raise ValueError(f"unknown dtype name {dtype!r}") from None
    raise TypeError(f"not a dtype: {dtype!r}")

