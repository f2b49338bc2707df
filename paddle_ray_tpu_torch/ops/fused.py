"""Fused dropout + residual add + LayerNorm, forward and backward, and the
int8 matmul (the port of ``paddle_ray_tpu/ops/fused.py``).

    h = dropout(x) + residual,    y = LayerNorm(h) * weight + bias

over the rows of ``[rows, H]``, in float32: the mean first, then the
centred variance, ``rstd = rsqrt(var + eps)``.  The keep mask is the JAX
kernel's counter hash (``_keep_mask``): a murmur3 finaliser over uint32
``(seed, global row, col)``, kept where the hash is at least ``p * 2**32``.
It depends on the global row and not on any blocking, so every kernel
layout gives the JAX mask bit for bit, and the backward recomputes it
from the seed instead of storing it.  The seed is
``jax.random.randint(rng, (1,), 0, 2**31 - 1, int32)``
(:func:`..core.prng.randint`).

:func:`dal_forward` and :func:`dal_backward` work on ``[rows, H]``.  For
CUDA tensors they launch the hand-written kernels of ``csrc/fused.cu``
and count the launch in their ``launches``; for CPU tensors they run the
plain versions (:func:`dal_forward_plain`, :func:`dal_backward_plain`).
There is no fallback between the two: a CUDA tensor the kernels do not
take raises.  :func:`fused_dropout_add_layernorm` is the differentiable
entry with the JAX signature.

:func:`int8_matmul` is ``(xq @ wq) * x_scale[:, None] * w_scale[None, :]``
for int8 ``xq [M, K]`` and ``wq [K, N]``: int32 sums, then two float32
products in that order, then the cast to ``out_dtype``.  It keeps the JAX
signature and block rule; :func:`int8_mm` takes any shape (the dynamic-PTQ
``QuantizedLinear`` calls it).  CUDA tensors launch the hand-written
kernel of ``csrc/int8_matmul.cu`` (counted in ``int8_matmul.launches``),
CPU tensors run :func:`int8_matmul_plain`, which sums in float64: exact
for any K below 2**37, so its float32 rounding is the JAX kernel's.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from ..core import prng

__all__ = ["fused_dropout_add_layernorm", "dal_forward", "dal_backward",
           "dal_forward_plain", "dal_backward_plain", "keep_mask_plain",
           "int8_matmul", "int8_matmul_plain", "int8_mm", "INT8_MAX_K"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASK = 0xFFFFFFFF
# the widest row the kernels stage in shared memory (16 bytes a column in
# the backward: 128 KiB)
KERNEL_MAX_H = 8192
# the backward's rows are split over at most this many blocks, whose
# partial dweight / dbias a second launch sums in a fixed order
_BWD_BLOCKS = 256


def _drop_consts(p: float) -> Tuple[int, float]:
    """``(threshold, scale)``: keep where the hash is ``>= threshold``
    (``p * 2**32``, as the JAX kernel truncates it), and the kept value's
    multiplier ``float32(1) / float32(1 - p)``, the JAX ``mask / (1 -
    p)``."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} outside [0, 1)")
    thresh = min(int(p * (2.0 ** 32)), 2 ** 32 - 1)
    return thresh, float(np.float32(1.0) / np.float32(1.0 - p))


# ---------------------------------------------------------------------------
# Plain versions: the CPU path and the yardstick of the kernels
# ---------------------------------------------------------------------------
def keep_mask_plain(shape, p: float, seed: int, row0: int = 0,
                    device=None) -> torch.Tensor:
    """The JAX ``_keep_mask``: float32 ``[rows, cols]`` of 1 (keep) and 0,
    from the hash of ``(seed, row0 + row, col)`` on int64 tensors masked
    to 32 bits."""
    rows, cols = shape
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None] + row0
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    x = (prng.mul32(torch.tensor(int(seed) & _MASK, device=device),
                    2654435761)
         + prng.mul32(r & _MASK, 0x9E3779B9)
         + prng.mul32(c, 0x85EBCA6B)) & _MASK
    x = x ^ (x >> 16)
    x = prng.mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = prng.mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    thresh, _ = _drop_consts(p)
    return (x >= thresh).to(torch.float32)


def _dropped(v: torch.Tensor, p: float, seed: int) -> torch.Tensor:
    """``v * mask / (1 - p)`` in float32, the JAX order: the 0/1 mask
    divided by ``1 - p`` first, then the product."""
    keep = keep_mask_plain(v.shape, p, seed, device=v.device)
    return v * (keep / torch.tensor(np.float32(1.0 - p), device=v.device))


def dal_forward_plain(x: torch.Tensor, residual: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor, seed: int,
                      *, p: float, epsilon: float, training: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Plain PyTorch forward on ``[rows, H]``: ``(y, h)`` in x's dtype and
    ``mean``, ``rstd`` float32 ``[rows]``."""
    xf = x.float()
    if training and p > 0.0:
        xf = _dropped(xf, p, seed)
    h = xf + residual.float()
    mean = h.mean(-1)
    var = (h - mean[:, None]).square().mean(-1)
    rstd = torch.rsqrt(var + epsilon)
    xhat = (h - mean[:, None]) * rstd[:, None]
    y = xhat * weight.float() + bias.float()
    return y.to(x.dtype), h.to(x.dtype), mean, rstd


def dal_backward_plain(h: torch.Tensor, mean: torch.Tensor,
                       rstd: torch.Tensor, weight: torch.Tensor,
                       dy: torch.Tensor, dh2: Optional[torch.Tensor],
                       seed: int, *, p: float, training: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Plain PyTorch backward, term for term the JAX ``_dal_bwd_kernel``,
    from the saved ``h`` (x's dtype), ``mean`` and ``rstd``: ``(dx, dres)``
    in h's dtype and ``dweight``, ``dbias`` float32 ``[H]``.  ``dh2`` is
    the cotangent of the ``h`` output (None: zero)."""
    xhat = (h.float() - mean[:, None]) * rstd[:, None]
    dyf = dy.float()
    dyw = dyf * weight.float()
    dh = rstd[:, None] * (dyw - dyw.mean(-1, keepdim=True)
                          - xhat * (dyw * xhat).mean(-1, keepdim=True))
    if dh2 is not None:
        dh = dh + dh2.float()
    dw = (dyf * xhat).sum(0)
    db = dyf.sum(0)
    dx = _dropped(dh, p, seed) if training and p > 0.0 else dh
    return dx.to(h.dtype), dh.to(h.dtype), dw, db


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _check_cuda(named) -> None:
    """Raise on anything the CUDA kernels do not take: ``named`` is
    ``[(name, tensor), ...]`` with the row tensor first."""
    first = named[0][1]
    if first.dim() != 2:
        raise ValueError(f"want [rows, H], got {tuple(first.shape)}")
    rows, n = first.shape
    if first.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got "
                        f"{first.dtype}")
    if not 0 < n <= KERNEL_MAX_H:
        raise ValueError(f"kernel takes 0 < H <= {KERNEL_MAX_H}, got {n}")
    if rows == 0:
        raise ValueError("no rows")
    for name, t in named:
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, not {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("weight", "bias"):
            if t.shape != (n,) or t.dtype not in _KERNEL_DTYPES:
                raise ValueError(f"{name} must be float32 or bfloat16 "
                                 f"[{n}], got {t.dtype} {tuple(t.shape)}")
        elif name in ("mean", "rstd"):
            if t.shape != (rows,) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 [{rows}], got "
                                 f"{t.dtype} {tuple(t.shape)}")
        elif t.shape != first.shape or t.dtype != first.dtype:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} must "
                             f"match {first.dtype} {tuple(first.shape)}")
    weights = [t for nm, t in named if nm in ("weight", "bias")]
    if len({t.dtype for t in weights}) > 1:
        raise TypeError(f"weight and bias dtypes differ: "
                        f"{[t.dtype for t in weights]}")


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused")
    if lib.prt_dal_fwd.argtypes is None:
        p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_float)
        lib.prt_dal_fwd.argtypes = ([p] * 8 + [i] * 2 + [u, u, f, i, f]
                                    + [i] * 2 + [p])
        lib.prt_dal_bwd.argtypes = ([p] * 11 + [i] * 3 + [u, u, f, i]
                                    + [i] * 2 + [p])
        lib.prt_dal_fwd.restype = ctypes.c_int
        lib.prt_dal_bwd.restype = ctypes.c_int
        lib.prt_fused_error_string.argtypes = [ctypes.c_int]
        lib.prt_fused_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    lib = _kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"({lib.prt_fused_error_string(err).decode()})")


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused_dropout_add_layernorm for {x.device}")
    return x.device.type


def dal_forward(x: torch.Tensor, residual: torch.Tensor,
                weight: torch.Tensor, bias: torch.Tensor, seed: int, *,
                p: float, epsilon: float = 1e-5, training: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Forward on ``[rows, H]``: ``(y, h, mean, rstd)``.  CUDA tensors
    launch ``prt_dal_fwd`` (one block a row); CPU tensors run
    :func:`dal_forward_plain`."""
    thresh, scale = _drop_consts(p)
    if _device_kind(x) == "cpu":
        return dal_forward_plain(x, residual, weight, bias, seed, p=p,
                                 epsilon=epsilon, training=training)
    _check_cuda([("x", x), ("residual", residual), ("weight", weight),
                 ("bias", bias)])
    rows, n = x.shape
    y = torch.empty_like(x)
    h = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    _launch("fused_dropout_add_layernorm", "prt_dal_fwd", x.device,
            x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), y.data_ptr(), h.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), rows, n, int(seed) & _MASK, thresh, scale,
            int(training and p > 0.0), float(epsilon),
            _KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[weight.dtype])
    dal_forward.launches += 1
    return y, h, mean, rstd


def dal_backward(h: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                 weight: torch.Tensor, dy: torch.Tensor,
                 dh2: Optional[torch.Tensor], seed: int, *, p: float,
                 training: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Backward on ``[rows, H]``: ``(dx, dres, dweight, dbias)`` as
    :func:`dal_backward_plain` gives them.  CUDA tensors launch
    ``prt_dal_bwd`` (rows split over at most 256 blocks, then a
    fixed-order sum of their partial dweight / dbias); CPU tensors run the
    plain version."""
    thresh, scale = _drop_consts(p)
    if _device_kind(h) == "cpu":
        return dal_backward_plain(h, mean, rstd, weight, dy, dh2, seed, p=p,
                                  training=training)
    named = [("h", h), ("dy", dy), ("mean", mean), ("rstd", rstd),
             ("weight", weight)]
    if dh2 is not None:
        named.append(("dh2", dh2))
    _check_cuda(named)
    rows, n = h.shape
    per_block = -(-rows // _BWD_BLOCKS)
    blocks = -(-rows // per_block)
    f32 = dict(dtype=torch.float32, device=h.device)
    dx = torch.empty_like(h)
    dres = torch.empty_like(h)
    parts = torch.empty(2, blocks, n, **f32)
    dw_db = torch.empty(2, n, **f32)
    _launch("fused_dropout_add_layernorm_bwd", "prt_dal_bwd", h.device,
            h.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            weight.data_ptr(), dy.data_ptr(),
            None if dh2 is None else dh2.data_ptr(), dx.data_ptr(),
            dres.data_ptr(), parts.data_ptr(), dw_db[0].data_ptr(),
            dw_db[1].data_ptr(), rows, n, per_block, int(seed) & _MASK,
            thresh, scale, int(training and p > 0.0),
            _KERNEL_DTYPES[h.dtype], _KERNEL_DTYPES[weight.dtype])
    dal_backward.launches += 1
    return dx, dres, dw_db[0], dw_db[1]


dal_forward.launches = 0
dal_backward.launches = 0


class _DAL(torch.autograd.Function):
    """``(y, h)`` of ``[rows, H]`` whose backward is the backward kernel.
    Saves ``h``, ``mean``, ``rstd`` and the weight, and the seed as an
    int: the mask is recomputed, never stored.  An unused output's
    cotangent stays None (no zeros are made for it)."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, seed: int, p: float,
                epsilon: float, training: bool):
        y, h, mean, rstd = dal_forward(x, residual, weight, bias, seed, p=p,
                                       epsilon=epsilon, training=training)
        ctx.save_for_backward(h, mean, rstd, weight)
        ctx.seed, ctx.p, ctx.training = seed, p, training
        ctx.dtypes = (x.dtype, residual.dtype, weight.dtype, bias.dtype)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh2):
        h, mean, rstd, weight = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(h)
        dx, dres, dw, db = dal_backward(
            h, mean, rstd, weight, dy.contiguous(),
            None if dh2 is None else dh2.contiguous(), ctx.seed, p=ctx.p,
            training=ctx.training)
        xt, rt, wt, bt = ctx.dtypes
        return (dx.to(xt), dres.to(rt), dw.to(wt), db.to(bt), None, None,
                None, None)


def fused_dropout_add_layernorm(x: torch.Tensor, residual: torch.Tensor,
                                weight: torch.Tensor, bias: torch.Tensor, *,
                                p: float = 0.1, epsilon: float = 1e-5,
                                rng=None, training: bool = True,
                                block_rows: int = 256
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y = LayerNorm(dropout(x) + residual)``; returns ``(y, h)`` with
    ``h = dropout(x) + residual`` (the pre-norm residual stream),
    differentiable in x, residual, weight and bias.

    x/residual: ``[..., H]`` of one dtype; weight/bias: ``[H]``.  The seed
    is drawn from ``rng`` (a :mod:`..core.prng` key; a key on the host
    costs no device sync) as the JAX function draws it.  Without a key,
    training with ``p > 0`` raises: the JAX package would take one from
    its global key tracker, which is not ported.  ``block_rows`` is the
    JAX kernel's row block, checked and kept for the signature: the mask
    does not depend on it and the CUDA kernels pick their own blocking.
    """
    if block_rows <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    if x.shape != residual.shape or x.dtype != residual.dtype:
        raise ValueError(f"x {x.dtype} {tuple(x.shape)} and residual "
                         f"{residual.dtype} {tuple(residual.shape)} differ")
    orig = x.shape
    n = orig[-1]
    if rng is None:
        if training and p > 0.0:
            from ..nn.functional import no_key_error
            raise no_key_error("fused_dropout_add_layernorm")
        seed = 0
    else:
        seed = int(prng.randint(prng.as_key(rng), (1,), 0, 2 ** 31 - 1)[0])
    y, h = _DAL.apply(x.reshape(-1, n).contiguous(),
                      residual.reshape(-1, n).contiguous(), weight, bias,
                      seed, float(p), float(epsilon), bool(training))
    return y.reshape(orig), h.reshape(orig)


# ---------------------------------------------------------------------------
# int8 matmul
# ---------------------------------------------------------------------------
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the deepest K whose int32 sums cannot overflow (|xq * wq| <= 2**14)
INT8_MAX_K = 2 ** 17 - 1


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor,
                      x_scale: torch.Tensor, w_scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Plain PyTorch version, on the CPU and on CUDA alike: the int8
    product summed in float64 (every partial sum an integer below 2**53,
    so exact), rounded to float32, times ``x_scale[:, None]`` and then
    ``w_scale[None, :]`` in float32, cast to ``out_dtype``."""
    acc = (xq.double() @ wq.double()).float()
    return (acc * x_scale.float()[:, None]
            * w_scale.float()[None, :]).to(out_dtype)


def _check_int8(xq, wq, x_scale, w_scale, out_dtype) -> None:
    """The checks of both paths: types, ranks, matching dims, scale
    lengths (the JAX wrapper's inner-dim message)."""
    for name, t in (("xq", xq), ("wq", wq)):
        if t.dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    m, k = xq.shape
    k2, n = wq.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {k} vs {k2}")
    for name, t, want in (("x_scale", x_scale, m), ("w_scale", w_scale, n)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating, got {t.dtype}")
        if tuple(t.shape) != (want,):
            raise ValueError(f"{name} must be [{want}], got "
                             f"{tuple(t.shape)}")
    if not out_dtype.is_floating_point:
        raise TypeError(f"out_dtype must be floating, got {out_dtype}")


def _int8_lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    if lib.prt_int8_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.prt_int8_matmul.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.prt_int8_matmul.restype = ctypes.c_int
        lib.prt_int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.prt_int8_matmul_error_string.restype = ctypes.c_char_p
    return lib


def int8_mm(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
            w_scale: torch.Tensor, out_dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """``(xq @ wq) * x_scale[:, None] * w_scale[None, :]`` for any ``[M,
    K] x [K, N]``, without the JAX wrapper's block rule.  CUDA tensors
    launch ``prt_int8_matmul`` and count the launch in
    ``int8_matmul.launches``; CPU tensors run :func:`int8_matmul_plain`.
    A CUDA tensor the kernel does not take (another device, out_dtype
    other than float32 / bfloat16, an empty dim, K above
    :data:`INT8_MAX_K`, a non-contiguous operand) raises."""
    _check_int8(xq, wq, x_scale, w_scale, out_dtype)
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, wq, x_scale, w_scale, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"no int8_matmul for device {xq.device}")
    for name, t in (("wq", wq), ("x_scale", x_scale), ("w_scale", w_scale)):
        if t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"kernel writes float32 or bfloat16, not "
                        f"{out_dtype}")
    m, k = xq.shape
    n = wq.shape[1]
    if min(m, n, k) == 0 or k > INT8_MAX_K:
        raise ValueError(f"kernel takes 1 <= M, N and 1 <= K <= "
                         f"{INT8_MAX_K}, got M={m}, N={n}, K={k}")
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError("xq and wq must be contiguous (row-major)")
    xs = x_scale.float().contiguous()
    ws = w_scale.float().contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    lib = _int8_lib()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.prt_int8_matmul(xq.data_ptr(), wq.data_ptr(),
                                  xs.data_ptr(), ws.data_ptr(),
                                  out.data_ptr(), m, n, k,
                                  _OUT_DTYPES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"int8_matmul kernel launch failed: cudaError {err} "
            f"({lib.prt_int8_matmul_error_string(err).decode()})")
    int8_matmul.launches += 1
    return out


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *, block_m: int = 256,
                block_n: int = 256, block_k: int = 256,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Int8 x int8 -> int32 matmul with the dequantising epilogue:
    ``out = (xq @ wq) * x_scale[:, None] * w_scale[None, :]``.

    xq: ``[M, K]`` int8 (per-row scales ``x_scale [M]``); wq: ``[K, N]``
    int8 (per-column scales ``w_scale [N]``); scales are taken in float32.
    Raises the JAX wrapper's ``ValueError``s: an inner-dim mismatch, and
    an M, N or K not divisible by its block clipped to the dim.  The
    blocks are checked and kept for the signature: the CUDA kernel picks
    its own tiling and masks ragged edges (:func:`int8_mm`)."""
    _check_int8(xq, wq, x_scale, w_scale, out_dtype)
    m, k = xq.shape
    n = wq.shape[1]
    for nm, b_ in (("block_m", block_m), ("block_n", block_n),
                   ("block_k", block_k)):
        if b_ <= 0:
            raise ValueError(f"{nm} must be positive, got {b_}")
    for dim, b_, nm in ((m, min(block_m, m), "M"), (n, min(block_n, n), "N"),
                        (k, min(block_k, k), "K")):
        if b_ == 0 or dim % b_:
            raise ValueError(f"{nm}={dim} not divisible by block {b_}")
    return int8_mm(xq, wq, x_scale, w_scale, out_dtype)


int8_matmul.launches = 0
