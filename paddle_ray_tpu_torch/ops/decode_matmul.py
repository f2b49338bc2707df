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
(``csrc/decode_matmul.cu``) for tensors on a CUDA device, one launch a
call: a bf16 x runs on the tensor cores, and where K is cut into runs
(:func:`stream_plan`) the launch merges them itself.  For tensors on the
CPU it runs :func:`int8_stream_matmul_plain`.  There is no fallback
between the two: a CUDA tensor the kernel does not take raises.
:func:`int8_stream_matmul_split_plain` is the kernel's split-and-merge in
plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, _splitk

__all__ = ["int8_stream_matmul", "int8_stream_matmul_plain",
           "int8_stream_matmul_split_plain", "MAX_KERNEL_ROWS", "STAGE_K",
           "TILE_N", "ROWS", "kernel_plan", "stream_plan"]

# the largest row count the kernel takes (the JAX caller's cut-off too)
MAX_KERNEL_ROWS = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_N = 128           # output columns per block
ROWS = 8               # input rows per block
STAGE_K = 64           # K rows per stage of the weight ring; a run is a multiple
# a split run spans this many stages (tools/torch_stream_splits.py: shorter
# runs pay more merging than they gain in SMs, longer ones stream too long)
MIN_RUN_STAGES, MAX_RUN_STAGES = 2, 4


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


def int8_stream_matmul_split_plain(x: torch.Tensor, w_q: torch.Tensor,
                                   scale: torch.Tensor,
                                   bias: Optional[torch.Tensor] = None, *,
                                   rows_per_split: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's split-K: each run of
    ``rows_per_split`` K rows summed on its own in float32, the runs added
    in order, then ``* scale (+ bias)`` and the cast.  Equal to
    :func:`int8_stream_matmul_plain` up to rounding."""
    _check_shapes(x, w_q, scale, bias)
    if rows_per_split < 1:
        raise ValueError(f"rows_per_split must be positive, got "
                         f"{rows_per_split}")
    xf, wf = x.float(), w_q.float()
    acc = torch.zeros(x.shape[0], w_q.shape[1], dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, x.shape[1], rows_per_split):
        run = slice(k0, k0 + rows_per_split)
        acc = acc + torch.matmul(xf[:, run], wf[run])
    y = acc * scale.float()
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


def stream_plan(b: int, k: int, n: int, sm_count: int) -> Tuple[int, int]:
    """``(rows_per_split, n_splits)`` of a ``[b, k] x [k, n]`` launch on a
    card of ``sm_count`` SMs.  With at least as many blocks of ``TILE_N``
    columns by ``ROWS`` rows as SMs, K is not cut.  Otherwise it is cut
    into runs of ``rows_per_split`` rows (whole stages of :data:`STAGE_K`
    rows; the last run shorter, none empty): the stages the card would
    give each SM over all the blocks, held to :data:`MIN_RUN_STAGES` ..
    :data:`MAX_RUN_STAGES`."""
    tiles = -(-n // TILE_N) * -(-b // ROWS)
    stages = -(-k // STAGE_K)
    per = stages if tiles >= sm_count else min(
        max(-(-stages * tiles // sm_count), MIN_RUN_STAGES), MAX_RUN_STAGES)
    rows = per * STAGE_K
    return rows, -(-k // rows)


def kernel_plan(b: int, k: int, n: int, device) -> Tuple[int, int]:
    """The plan every launch on ``device`` takes: :func:`stream_plan` on its
    card."""
    return stream_plan(b, k, n, _splitk.sm_count(device))


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("decode_matmul")
    fn = lib.prt_int8_stream_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, p, p, i, i, i, i, i, p]
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
    if bias is not None and bias.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel takes a float32 or bfloat16 bias, got "
                        f"{bias.dtype}")
    if not 0 < x.shape[0] <= MAX_KERNEL_ROWS:
        raise ValueError(f"kernel takes 1..{MAX_KERNEL_ROWS} rows, got "
                         f"{x.shape[0]}")
    if not w_q.is_contiguous():
        raise ValueError("w_q must be contiguous")


def int8_stream_matmul(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [B, K]`` (float32/bfloat16) ``@ w_q [K, N]`` (int8) ``* scale
    [N]`` (float32) ``(+ bias [N])`` -> ``[B, N]`` in x's dtype.

    On a CUDA device this launches the CUDA kernel once (B <= 128) and
    counts the launch in ``int8_stream_matmul.launches``; on the CPU it runs
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
    bs = None if bias is None else bias.contiguous()
    rows, n_splits = kernel_plan(b, k, n, x.device)
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ws = counters = None
        if n_splits > 1:
            tiles = -(-n // TILE_N) * -(-b // ROWS)
            ws = _splitk.split_workspace(x.device, stream,
                                         tiles * n_splits * ROWS * TILE_N)
            counters = _splitk.split_counters(x.device, stream, tiles)
        err = lib.prt_int8_stream_matmul(
            xc.data_ptr(), w_q.data_ptr(), sc.data_ptr(),
            None if bs is None else bs.data_ptr(),
            0 if bs is None else _KERNEL_DTYPES[bs.dtype],
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            out.data_ptr(), b, k, n, rows, _KERNEL_DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"int8_stream_matmul kernel launch failed: cudaError {err} "
            f"({lib.prt_cuda_error_string(err).decode()})")
    int8_stream_matmul.launches += 1
    return out


int8_stream_matmul.launches = 0
