"""Fused single-token decode attention over a dense KV cache (the port of
``paddle_ray_tpu/ops/decode_attention.py``).

One query row per (batch, head) attends the cache rows ``t <= pos`` in one
call: matvec, mask, softmax and, for the int8 cache, the scale folds -- the
per-row K scales multiply the logits, the V scales the accumulation weights
(the denominator sums the plain exponentials), so nothing dequantized is
materialized.  The cache is read-only here: ``generate()`` appends the
token's own row before the call.

Layouts (head-major): q ``[B, h, 1, d]``; cache ``(k, v)`` ``[B, h, T, d]``
in q's dtype, or int8 ``(k_q, k_s, v_q, v_s)`` with values ``[B, h, T, d]``
int8 and scales ``[B, h, T, 1]`` float32.

:func:`fused_decode_attention` launches the hand-written CUDA kernel
(``csrc/decode_attention.cu``) for tensors on a CUDA device and runs the
plain version of the cache's kind (:func:`fused_decode_attention_plain`,
:func:`fused_decode_attention_q8_plain`) for tensors on the CPU.  The two
kinds count their launches apart, as the JAX package's two kernel bodies:
``fused_decode_attention.launches`` and
``fused_decode_attention.launches_q8``.  There is no fallback: a CUDA
tensor the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .paged_attention import _prescale

__all__ = ["fused_decode_attention", "fused_decode_attention_plain",
           "fused_decode_attention_q8_plain", "DECODE_BLOCK_T"]

# the decode cache's T-axis block: generate() aligns its allocation for the
# fused path to it, as the JAX package does (the CUDA kernel itself reads
# only the rows up to pos)
DECODE_BLOCK_T = 256

KERNEL_HEAD_DIMS = (64, 80, 96, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, cache: Tuple, pos: int) -> None:
    if len(cache) not in (2, 4):
        raise ValueError("cache is (k, v) or (k_q, k_s, v_q, v_s)")
    b, h, one, d = q.shape
    if one != 1:
        raise ValueError(f"q must be [B, h, 1, d], got {tuple(q.shape)}")
    k = cache[0]
    if k.dim() != 4 or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    v = cache[-2] if len(cache) == 4 else cache[1]
    if v.shape != k.shape:
        raise ValueError(f"v cache {tuple(v.shape)} != k cache "
                         f"{tuple(k.shape)}")
    if len(cache) == 4:
        for s in (cache[1], cache[3]):
            if s.shape != (*k.shape[:3], 1):
                raise ValueError(f"scales must be [B, h, T, 1], got "
                                 f"{tuple(s.shape)}")
    if not 0 <= pos < k.shape[2]:
        raise ValueError(f"pos {pos} outside the cache's {k.shape[2]} rows")


def _finish(q, logits, v, w_extra):
    """Softmax over the live ``[B, h, T]`` logits and the weighted sum of
    ``v`` ``[B, h, T, d]`` (f32); ``w_extra`` ``[B, h, T]`` multiplies the
    accumulation weights only."""
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    den = e.sum(-1, keepdim=True)
    w = e if w_extra is None else e * w_extra
    acc = torch.einsum("bht,bhtd->bhd", w, v)
    return (acc / den)[:, :, None, :].to(q.dtype)


def fused_decode_attention_plain(q: torch.Tensor, cache: Tuple, pos: int, *,
                                 scale: float) -> torch.Tensor:
    """Plain PyTorch version of the bf16/f32 body: f32 logits of the
    pre-scaled q against the rows ``t <= pos`` (as the kernel, it reads
    no row past pos), softmax, weighted sum of V."""
    _check(q, cache, pos)
    k, v = (c[:, :, :pos + 1] for c in cache)
    qf = _prescale(q, scale).float()[:, :, 0]                  # [B, h, d]
    logits = torch.einsum("bhd,bhtd->bht", qf, k.float())
    return _finish(q, logits, v.float(), None)


def fused_decode_attention_q8_plain(q: torch.Tensor, cache: Tuple, pos: int,
                                    *, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the int8 body: the K scales fold into the
    logits after the dot, the V scales into the accumulation weights."""
    _check(q, cache, pos)
    k_q, k_s, v_q, v_s = (c[:, :, :pos + 1] for c in cache)
    qf = _prescale(q, scale).float()[:, :, 0]
    logits = torch.einsum("bhd,bhtd->bht", qf, k_q.float()) * k_s[..., 0]
    return _finish(q, logits, v_q.float(), v_s[..., 0])


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.prt_fused_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.prt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.prt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(q: torch.Tensor, cache: Tuple) -> None:
    for i, t in enumerate(cache):
        if t.device != q.device:
            raise ValueError(f"cache[{i}] is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"cache[{i}] must be contiguous")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16 q, got {q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head_dim {q.shape[-1]} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if len(cache) == 4:
        if cache[0].dtype != torch.int8 or cache[2].dtype != torch.int8:
            raise TypeError("int8 cache values must be int8")
        if cache[1].dtype != torch.float32 or cache[3].dtype != torch.float32:
            raise TypeError("int8 cache scales must be float32")
    elif cache[0].dtype != q.dtype or cache[1].dtype != q.dtype:
        raise TypeError(f"cache dtype {cache[0].dtype} != q dtype {q.dtype}")
    for i in (0, len(cache) - 2):
        if cache[i].data_ptr() % 16:
            raise ValueError(f"cache[{i}] must be 16-byte aligned")


def fused_decode_attention(q: torch.Tensor, cache: Tuple, pos: int, *,
                           scale: float) -> torch.Tensor:
    """One-token attention over an (already appended) dense KV cache.

    q: ``[B, h, 1, d]``; ``cache`` = ``(k, v)`` or ``(k_q, k_s, v_q, v_s)``
    with the current token's row written at ``pos`` (a Python int); rows
    ``t <= pos`` are live.  Returns ``[B, h, 1, d]`` in q's dtype.

    On a CUDA device this launches the CUDA kernel, counted in
    ``fused_decode_attention.launches`` (bf16/f32 cache) or
    ``.launches_q8`` (int8 cache); on the CPU it runs the plain version."""
    pos = int(pos)
    _check(q, cache, pos)
    q8 = len(cache) == 4
    if q.device.type == "cpu":
        plain = (fused_decode_attention_q8_plain if q8
                 else fused_decode_attention_plain)
        return plain(q, cache, pos, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no fused decode attention for device {q.device}")
    _check_cuda(q, cache)
    b, h, _, d = q.shape
    t_len = cache[0].shape[2]
    qs = _prescale(q, scale).contiguous()
    out = torch.empty_like(qs)
    if q8:
        k, ks, v, vs = cache
        scales = (ks.data_ptr(), vs.data_ptr())
    else:
        (k, v), scales = cache, (None, None)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.prt_fused_decode_attention(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), *scales,
            out.data_ptr(), b * h, t_len, d, pos + 1,
            _KERNEL_DTYPES[q.dtype], int(q8), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_decode_attention kernel launch failed: cudaError {err} "
            f"({lib.prt_cuda_error_string(err).decode()})")
    if q8:
        fused_decode_attention.launches_q8 += 1
    else:
        fused_decode_attention.launches += 1
    return out


fused_decode_attention.launches = 0
fused_decode_attention.launches_q8 = 0
