"""Weight-streaming int8 matmul for decode (the port of
``paddle_ray_tpu/ops/decode_matmul.py``).

Decode linears are ``[B <= 128, K] x [K, N]`` with B tiny: pure weight
streaming.  ``WeightOnlyInt8Linear`` and the int8 LM head call
:func:`int8_stream_matmul` for such row counts: ``x @ w_q`` with the int8
weight widened in registers, accumulated in float32, times the
per-output-channel scale (plus the bias), returned in x's dtype.  Any N:
the JAX kernel zero-pads N to 128, which gives the same numbers as masking
the ragged edge, as the CUDA kernel does.

:func:`int8_stream_matmul` launches the hand-written CUDA kernel
(``csrc/decode_matmul.cu``) for tensors on a CUDA device and runs
:func:`int8_stream_matmul_plain` for tensors on the CPU.  There is no
fallback between the two: a CUDA tensor the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["int8_stream_matmul", "int8_stream_matmul_plain",
           "MAX_KERNEL_ROWS", "split_k"]

# the largest row count the kernel takes (the JAX caller's cut-off too)
MAX_KERNEL_ROWS = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_N = 64           # output columns per block
_ROWS = 8              # input rows per block
_MAX_TILE_K = 1024     # K rows per block
_TARGET_BLOCKS = 264   # about two blocks for each of the H100's 132 SMs


def int8_stream_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                             scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version: ``(x @ w_q) * scale (+ bias)`` in float32,
    cast to x's dtype."""
    _check_shapes(x, w_q, scale, bias)
    y = torch.matmul(x.float(), w_q.float()) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _check_shapes(x, w_q, scale, bias) -> None:
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ w_q {tuple(w_q.shape)}: "
                         f"want [B, K] @ [K, N]")
    n = w_q.shape[1]
    if scale.shape != (n,) or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"scale and bias must be [{n}]")


def split_k(b: int, k: int, n: int):
    """``(tile_k, splits)``: the K rows each block sums, and the number of
    blocks K is split over, so that the grid holds about two blocks per
    SM (tile_k a multiple of 16, at most 1024)."""
    tiles = -(-n // _TILE_N) * -(-b // _ROWS)
    want = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-k // 16)))
    per_block = -(-k // want)
    tile_k = min(_MAX_TILE_K, -(-per_block // 16) * 16)
    return tile_k, -(-k // tile_k)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("decode_matmul")
    fn = lib.prt_int8_stream_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.prt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.prt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(x, w_q, scale, bias) -> None:
    for name, t in (("w_q", w_q), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16 x, got {x.dtype}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if not 0 < x.shape[0] <= MAX_KERNEL_ROWS:
        raise ValueError(f"kernel takes 1..{MAX_KERNEL_ROWS} rows, got "
                         f"{x.shape[0]}")
    if not w_q.is_contiguous() or w_q.data_ptr() % 4:
        raise ValueError("w_q must be contiguous and 4-byte aligned")


def int8_stream_matmul(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [B, K]`` (float32/bfloat16) ``@ w_q [K, N]`` (int8) ``* scale
    [N]`` (float32) ``(+ bias [N])`` -> ``[B, N]`` in x's dtype.

    On a CUDA device this launches the CUDA kernel (B <= 128) and counts
    the launch in ``int8_stream_matmul.launches``; on the CPU it runs
    :func:`int8_stream_matmul_plain`."""
    _check_shapes(x, w_q, scale, bias)
    if x.device.type == "cpu":
        return int8_stream_matmul_plain(x, w_q, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no int8_stream_matmul for device {x.device}")
    _check_cuda(x, w_q, scale, bias)
    b, k = x.shape
    n = w_q.shape[1]
    xc = x.contiguous()
    sc = scale.contiguous()
    bs = None if bias is None else bias.float().contiguous()
    tile_k, splits = split_k(b, k, n)
    part = (torch.empty((splits, b, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.prt_int8_stream_matmul(
            xc.data_ptr(), w_q.data_ptr(), sc.data_ptr(),
            None if bs is None else bs.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            b, k, n, tile_k, _KERNEL_DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"int8_stream_matmul kernel launch failed: cudaError {err} "
            f"({lib.prt_cuda_error_string(err).decode()})")
    int8_stream_matmul.launches += 1
    return out


int8_stream_matmul.launches = 0
