"""The :class:`~..optimizer.memory_efficient.MemoryEfficientAdamW` update of
one parameter: one hand-written CUDA launch (``csrc/me_adamw.cu``) beside
its plain PyTorch version (:func:`me_adamw_plain`, built from
:func:`quantize_blockwise`, :func:`dequantize_blockwise` and
:func:`stochastic_round`, the port's counterparts of the JAX
``paddle_ray_tpu/optimizer/memory_efficient.py`` functions).

It replaces no Pallas kernel.  The JAX optimizer is plain jnp that XLA
fuses into a pass per leaf; the plain version is about 30 tensor
operations a leaf and, for a bfloat16 parameter without a float32 master,
the threefry bits of its stochastic rounding as about 170 more on int64
tensors, one launch each on the card.  The kernel is the whole update in
one pass, bit for bit the plain version (see the source for the
arithmetic).

The plain version divides where the JAX function divides (a division by
a 0-d tensor, where a Python number would be a product with its
reciprocal), as JAX runs the function op by op; XLA compiling it into a
jitted step turns ``absmax / 127.0`` into a product with ``1 / 127``, so a
jitted JAX step's scales may differ from these in the last bit.  XLA on
the CPU also flushes float32 subnormals to zero and the port does not: a
block whose absmax is below about 1e-36 quantizes differently.

:func:`me_adamw_update` dispatches by device: CUDA tensors launch the
kernel and count the launch in its ``launches``; CPU tensors run the plain
version.  There is no fallback between the two.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as _F

from . import _build
from ..core import prng

__all__ = ["QMoment", "quantize_blockwise", "dequantize_blockwise",
           "stochastic_round", "me_adamw_plain", "me_adamw_update"]

@dataclasses.dataclass
class QMoment:
    """A blockwise-quantized moment: int8 (signed) or uint8 (sqrt-domain)
    codes in the parameter's shape, and float32 scales ``[nblocks]`` over
    the flattened, block-padded view."""
    codes: torch.Tensor
    scale: torch.Tensor


def _nblocks(n: int, block: int) -> int:
    return -(-n // block)


def _over(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d``, one float32 division (on the card too)."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root: taken in float64 and
    rounded once more, which gives the float32 result exactly (53 bits
    hold twice 24 and 2 more).  PyTorch's CPU ``sqrt`` of float32 vectors
    can miss it by an ulp; XLA's and CUDA's do not."""
    return torch.sqrt(x.double()).float()


def quantize_blockwise(x: torch.Tensor, block: int = 256, *,
                       signed: bool = True) -> QMoment:
    """Linear blockwise quantization of ``x`` (as float32) to 8 bits:
    ``signed`` symmetric int8 codes ``round(x / scale)`` with ``scale =
    absmax / 127``; else ``x`` is non-negative and its ``sqrt`` is coded
    in uint8 with ``scale = max(sqrt(x)) / 255``.  Codes round half to
    even; a block's divisor is ``max(scale, 1e-38)``."""
    shape, n = x.shape, x.numel()
    nb = _nblocks(n, block)
    xb = _F.pad(x.reshape(-1).float(), (0, nb * block - n)).reshape(nb, block)
    if signed:
        scale = _over(xb.abs().amax(1), 127.0)
        lo, hi, dt = -127, 127, torch.int8
    else:
        xb = _sqrt(xb)
        scale = _over(xb.amax(1), 255.0)
        lo, hi, dt = 0, 255, torch.uint8
    codes = torch.round(xb / torch.clamp(scale, min=1e-38)[:, None])
    codes = codes.clamp(lo, hi).to(dt)
    return QMoment(codes=codes.reshape(-1)[:n].reshape(shape), scale=scale)


def dequantize_blockwise(q: QMoment, block: int = 256) -> torch.Tensor:
    """The float32 moment of ``q`` (the inverse of
    :func:`quantize_blockwise`): codes times their block's scale, squared
    for uint8 codes."""
    shape, n = q.codes.shape, q.codes.numel()
    nb = q.scale.shape[0]
    cf = _F.pad(q.codes.reshape(-1).float(), (0, nb * block - n))
    xb = cf.reshape(nb, block) * q.scale[:, None]
    if q.codes.dtype == torch.uint8:
        xb = xb * xb
    return xb.reshape(-1)[:n].reshape(shape)


_MASK = 0xFFFFFFFF


def stochastic_round(x: torch.Tensor, key,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Unbiased float32 -> bfloat16 rounding: the low 16 bits of
    ``prng.random_bits(key, x.shape)`` added below bfloat16's mantissa,
    then truncated; a non-finite value passes untouched (an infinity as
    it is, a NaN as XLA converts it, its sign and ``0x7FC0``).  ``key`` is
    a :mod:`..core.prng` key or its two words."""
    if dtype != torch.bfloat16:
        raise ValueError("stochastic_round targets bfloat16")
    x = x.float()
    bits = x.view(torch.int32).to(torch.int64) & _MASK
    noise = prng.random_bits(prng.as_key(list(prng.key_words(key)),
                                         x.device), x.shape) & 0xFFFF
    top = torch.where(torch.isfinite(x), (bits + noise) >> 16, bits >> 16)
    top = torch.where(torch.isnan(x), (top & 0x8000) | 0x7FC0, top & 0xFFFF)
    top = torch.where(top >= 2 ** 15, top - 2 ** 16, top)
    return top.to(torch.int16).view(torch.bfloat16)


def _load(s, block: int) -> torch.Tensor:
    if isinstance(s, QMoment):
        return dequantize_blockwise(s, block)
    return s.float()


def _store(slot, x: torch.Tensor, block: int, signed: bool) -> None:
    if isinstance(slot, QMoment):
        q = quantize_blockwise(x, block, signed=signed)
        slot.codes.copy_(q.codes)
        slot.scale.copy_(q.scale)
    else:
        slot.copy_(x)


def me_adamw_plain(p: torch.Tensor, g: torch.Tensor, m, v,
                   master: Optional[torch.Tensor], *, lr: float, b1: float,
                   b2: float, eps: float, wd: float, l1: float, l2: float,
                   bc1: float, bc2: float, block: int,
                   key: Optional[Tuple[int, int]]) -> None:
    """The plain version of the kernel (:func:`me_adamw_update`, same
    arguments): the JAX ``MemoryEfficientAdamW``
    update of one parameter as tensor operations, each one float32
    operation in the JAX order, ``p``, ``m``, ``v`` and ``master`` updated
    in place."""
    p32 = master if master is not None else p.float()
    g32 = g.float()
    if l1:
        g32 = g32 + l1 * torch.sign(p32)
    if l2:
        g32 = g32 + l2 * p32
    m1 = b1 * _load(m, block) + (1 - b1) * g32
    v1 = b2 * _load(v, block) + (1 - b2) * (g32 * g32)
    upd = _over(m1, bc1) / (_sqrt(_over(v1, bc2)) + eps)
    if wd:
        upd = upd + wd * p32
    up = p32 - lr * upd
    _store(m, m1, block, True)
    _store(v, v1, block, False)
    if master is not None:
        master.copy_(up)
        p.copy_(up)
    elif key is not None:
        p.copy_(stochastic_round(up, key))
    else:
        p.copy_(up)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MOMENTS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


class _Args(ctypes.Structure):
    """``Args`` of ``csrc/me_adamw.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("p", "g", "master", "m", "v", "m_scale", "v_scale")]
                + [("n", ctypes.c_uint64), ("block", ctypes.c_int64)]
                + [(n, ctypes.c_float) for n in
                   ("lr", "b1", "b2", "omb1", "omb2", "bc1", "bc2", "eps",
                    "wd", "l1", "l2")]
                + [("k0", ctypes.c_uint32), ("k1", ctypes.c_uint32)]
                + [(n, ctypes.c_int) for n in
                   ("dtype", "moments", "has_master", "sr")])


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("me_adamw")
    if lib.prt_me_adamw.argtypes is None:
        lib.prt_me_adamw.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.prt_me_adamw.restype = ctypes.c_int
        lib.prt_me_adamw_args_size.restype = ctypes.c_int
        lib.prt_me_adamw_error_string.argtypes = [ctypes.c_int]
        lib.prt_me_adamw_error_string.restype = ctypes.c_char_p
        size = lib.prt_me_adamw_args_size()
        if size != ctypes.sizeof(_Args):
            raise RuntimeError(f"me_adamw: the C Args is {size} bytes, the "
                               f"ctypes one {ctypes.sizeof(_Args)}")
    return lib


def _f32(x: float) -> float:
    return float(np.float32(x))


def me_adamw_update(p: torch.Tensor, g: torch.Tensor, m, v,
                    master: Optional[torch.Tensor], *, lr: float, b1: float,
                    b2: float, eps: float, wd: float, l1: float, l2: float,
                    bc1: float, bc2: float, block: int,
                    key: Optional[Tuple[int, int]]) -> None:
    """One update of ``p`` in place from its gradient ``g``: the moments
    ``m`` / ``v`` (each a :class:`QMoment` or a bfloat16 / float32
    tensor) and the float32 ``master`` (or None)
    updated in place too.  ``bc1`` / ``bc2`` are the float32 bias
    corrections; ``key`` the stochastic rounding key's two words (a
    bfloat16 ``p`` without a master), else None.  CPU tensors run
    :func:`me_adamw_plain`; CUDA tensors launch the kernel."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd=wd, l1=l1, l2=l2, bc1=bc1,
              bc2=bc2, block=block, key=key)
    if p.device.type == "cpu":
        me_adamw_plain(p, g, m, v, master, **kw)
        return
    if p.device.type != "cuda":
        raise ValueError(f"no me_adamw kernel for device {p.device}")
    if p.dtype not in _DTYPES or g.dtype != p.dtype:
        raise TypeError(f"me_adamw kernel takes float32, bfloat16 or float16 "
                        f"parameters with gradients of their type, got "
                        f"{p.dtype} / {g.dtype}")
    q = isinstance(m, QMoment)
    if q != isinstance(v, QMoment):
        raise TypeError("m and v must both be QMoment or both tensors")
    mt, vt = (m.codes, v.codes) if q else (m, v)
    moments = torch.int8 if q else mt.dtype
    if (moments not in _MOMENTS or (q and vt.dtype != torch.uint8)
            or (not q and vt.dtype != mt.dtype)):
        raise TypeError(f"me_adamw kernel moments: int8 / uint8 codes or two "
                        f"bfloat16 / float32 tensors, got {mt.dtype} / "
                        f"{vt.dtype}")
    n = p.numel()
    tensors = [p, g, mt, vt] + ([master] if master is not None else [])
    if q:
        nb = -(-n // block)
        tensors += [m.scale, v.scale]
        if (m.scale.numel() != nb or v.scale.numel() != nb
                or m.scale.dtype != torch.float32
                or v.scale.dtype != torch.float32):
            raise ValueError(f"me_adamw: {nb} float32 scales wanted for "
                             f"{n} elements in blocks of {block}")
    for t in tensors:
        if t.device != p.device or not t.is_contiguous():
            raise ValueError("me_adamw kernel takes contiguous tensors on "
                             "the parameter's device")
    for t in (g, mt, vt) + ((master,) if master is not None else ()):
        if t.numel() != n:
            raise ValueError("me_adamw: every state tensor has the "
                             "parameter's size")
    if master is not None and master.dtype != torch.float32:
        raise TypeError("me_adamw: the master is float32")
    sr = key is not None
    if sr and (master is not None or p.dtype != torch.bfloat16):
        raise ValueError("me_adamw: stochastic rounding is for a bfloat16 "
                         "parameter without a master")
    if n == 0:
        return
    k0, k1 = key if sr else (0, 0)
    a = _Args(p.data_ptr(), g.data_ptr(),
              master.data_ptr() if master is not None else None,
              mt.data_ptr(), vt.data_ptr(),
              m.scale.data_ptr() if q else None,
              v.scale.data_ptr() if q else None,
              n, int(block),
              *(_f32(x) for x in (lr, b1, b2, 1 - b1, 1 - b2, bc1, bc2, eps,
                                  wd, l1, l2)),
              k0, k1, _DTYPES[p.dtype], _MOMENTS[moments],
              int(master is not None), int(sr))
    lib = _kernel_lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.prt_me_adamw(ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError(f"me_adamw kernel launch failed: cudaError {err} "
                           f"({lib.prt_me_adamw_error_string(err).decode()})")
    me_adamw_update.launches += 1


me_adamw_update.launches = 0
