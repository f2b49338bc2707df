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

The CUDA path is one launch a call: the kernel pre-scales q itself and
reads it through its batch and head strides (``generate()``'s transposed
view needs no copy), and splits a pair's rows over several blocks when
the pairs alone would leave SMs idle (:func:`decode_split_plan`), merging
the splits in the same launch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, _splitk
from .paged_attention import _prescale

__all__ = ["fused_decode_attention", "fused_decode_attention_plain",
           "fused_decode_attention_q8_plain",
           "fused_decode_attention_split_plain", "decode_split_plan",
           "DECODE_BLOCK_T"]

# the decode cache's T-axis block: generate() aligns its allocation for the
# fused path to it, as the JAX package does (the CUDA kernel itself reads
# only the rows up to pos)
DECODE_BLOCK_T = 256

KERNEL_HEAD_DIMS = (64, 80, 96, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel streams a pair's rows in groups of this many (a lane per row
# for the logits); a split is a whole number of groups
ROW_GROUP = 32
# a split takes at least this many rows: below it, or with more blocks
# than half the card's SMs, the merge's workspace round trip (about 2 us)
# costs more than the rows in flight it adds (tools/torch_decode_splits.py)
SPLIT_MIN_ROWS = 512


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


def _partial(logits, v, w_extra):
    """``(m, l, acc)`` of the live ``[B, h, T]`` logits: their max, the sum
    of the plain exponentials and the weighted sum of ``v`` ``[B, h, T,
    d]`` (f32); ``w_extra`` ``[B, h, T]`` multiplies the accumulation
    weights only."""
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    den = e.sum(-1, keepdim=True)
    w = e if w_extra is None else e * w_extra
    return m, den, torch.einsum("bht,bhtd->bhd", w, v)


def _finish(q, logits, v, w_extra):
    """Softmax over the live ``[B, h, T]`` logits and the weighted sum of
    ``v`` ``[B, h, T, d]`` (f32); ``w_extra`` ``[B, h, T]`` multiplies the
    accumulation weights only."""
    _, den, acc = _partial(logits, v, w_extra)
    return (acc / den)[:, :, None, :].to(q.dtype)


def _logits(q, cache, pos, scale):
    """The plain versions' common part: the f32 logits of the pre-scaled q
    against the rows ``t <= pos`` (the int8 K scale folded in after the
    dot), the live f32 values and the V scales (None for a cache in q's
    dtype)."""
    qf = _prescale(q, scale).float()[:, :, 0]                  # [B, h, d]
    if len(cache) == 4:
        k_q, k_s, v_q, v_s = (c[:, :, :pos + 1] for c in cache)
        logits = torch.einsum("bhd,bhtd->bht", qf, k_q.float()) * k_s[..., 0]
        return logits, v_q.float(), v_s[..., 0]
    k, v = (c[:, :, :pos + 1] for c in cache)
    return torch.einsum("bhd,bhtd->bht", qf, k.float()), v.float(), None


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


def decode_split_plan(bh: int, n_live: int,
                      sm_count: int) -> Tuple[int, int]:
    """``(n_splits, rows_per_split)`` of the kernel's split-K over a
    pair's ``n_live`` rows for ``bh`` (batch, head) pairs on a card of
    ``sm_count`` SMs.  A split takes at least :data:`SPLIT_MIN_ROWS` rows,
    and the launch at most half the SMs in blocks, so a card full of work
    (``2 bh > sm_count``) and a short cache are not split, and a single
    stream's long cache is.  Never more splits than groups of
    :data:`ROW_GROUP` rows, and never an empty one: ``rows_per_split`` is
    a whole number of groups, the last split the shorter."""
    groups = -(-max(1, int(n_live)) // ROW_GROUP)
    n = max(1, min(sm_count // 2 // max(1, bh),
                   int(n_live) // SPLIT_MIN_ROWS))
    per = -(-groups // n)
    return -(-groups // per), per * ROW_GROUP


def fused_decode_attention_split_plain(q: torch.Tensor, cache: Tuple,
                                       pos: int, *, scale: float,
                                       n_splits: int,
                                       rows_per_split: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's split-K, for either cache
    kind: each run of ``rows_per_split`` live rows (``n_splits`` runs, the
    last to ``pos``) gives float32 ``(m, l, acc)`` as the unsplit plain
    versions compute them over its rows alone, and the runs are merged in
    order by the log-sum-exp rule, ``o = sum(acc_s e^(m_s - M)) /
    sum(l_s e^(m_s - M))``.  Equal to the unsplit version up to
    rounding."""
    _check(q, cache, pos)
    if (n_splits < 1 or (n_splits - 1) * rows_per_split > pos
            or n_splits * rows_per_split <= pos):
        raise ValueError(f"{n_splits} splits of {rows_per_split} rows do "
                         f"not cut {pos + 1} rows into non-empty runs")
    logits, v, w_v = _logits(q, cache, pos, scale)
    parts = []
    for i in range(n_splits):
        run = slice(i * rows_per_split, (i + 1) * rows_per_split)
        parts.append(_partial(logits[..., run], v[:, :, run],
                              None if w_v is None else w_v[..., run]))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    l_sum = sum(l * torch.exp(m - big) for m, l, _ in parts)
    acc_sum = sum(acc * torch.exp(m - big) for m, _, acc in parts)
    return (acc_sum / l_sum)[:, :, None, :].to(q.dtype)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.prt_fused_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_int64] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 2
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
    # q is read through its batch and head strides, d contiguous
    if q.stride(-1) != 1:
        raise ValueError(f"q's head_dim must be contiguous, strides "
                         f"{q.stride()}")
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


def kernel_plan(q: torch.Tensor, pos: int) -> Tuple[int, int]:
    """``(n_splits, rows_per_split)`` with which
    :func:`fused_decode_attention` launches the kernel for this CUDA q at
    ``pos``: :func:`decode_split_plan` over its pairs and the card's SM
    count."""
    b, h = q.shape[:2]
    return decode_split_plan(b * h, pos + 1, _splitk.sm_count(q.device))


def fused_decode_attention(q: torch.Tensor, cache: Tuple, pos: int, *,
                           scale: float) -> torch.Tensor:
    """One-token attention over an (already appended) dense KV cache.

    q: ``[B, h, 1, d]``; ``cache`` = ``(k, v)`` or ``(k_q, k_s, v_q, v_s)``
    with the current token's row written at ``pos`` (a Python int); rows
    ``t <= pos`` are live.  Returns ``[B, h, 1, d]`` in q's dtype.

    On a CUDA device this launches the CUDA kernel once (q pre-scaled in
    the kernel and read through its strides; split-K by
    :func:`kernel_plan`), counted in ``fused_decode_attention.launches``
    (bf16/f32 cache) or ``.launches_q8`` (int8 cache); on the CPU it runs
    the plain version."""
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
    out = torch.empty(b, h, 1, d, dtype=q.dtype, device=q.device)
    if q8:
        k, ks, v, vs = cache
        scales = (ks.data_ptr(), vs.data_ptr())
    else:
        (k, v), scales = cache, (None, None)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        n_splits, rps = kernel_plan(q, pos)
        ws = (None, None, None)
        if n_splits > 1:
            f32 = dict(dtype=torch.float32, device=q.device)
            ws_acc = torch.empty(b * h * n_splits * d, **f32)
            ws_ml = torch.empty(b * h * n_splits * 2, **f32)
            counters = _splitk.split_counters(q.device, stream, b * h)
            ws = (ws_acc.data_ptr(), ws_ml.data_ptr(), counters.data_ptr())
        err = lib.prt_fused_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales,
            out.data_ptr(), *ws, b * h, h, q.stride(0), q.stride(1), t_len,
            d, pos + 1, _KERNEL_DTYPES[q.dtype], int(q8),
            torch.tensor(scale, dtype=q.dtype).item(), n_splits, rps,
            stream)
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
