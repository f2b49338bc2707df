"""Ragged paged attention: mixed decode/prefill-chunk queries over a paged
KV pool (the port of ``paddle_ray_tpu/ops/paged_attention.py``).

The serving engine keeps the KV cache as fixed-size pages drawn from a
pool ``[num_pages, page, h_kv, d]``; each sequence's page-table row maps
its logical block index to a physical page, and page 0 is the null page
every unused entry points at.  One call attends a ragged chunk of query
rows per sequence (``q_lens[b]`` in ``0..chunk``: 1 for a decoding
sequence, up to ``chunk`` for a prefill slice, 0 for a dead slot) against
that sequence's own pages.  Query row ``i`` of sequence ``b`` sits at
absolute position ``lengths[b] - q_lens[b] + i`` and sees exactly the keys
at positions ``<=`` its own; GQA shares each KV head among
``h_q / h_kv`` query heads; masked terms weigh exactly 0, so dead slots
and pad rows output zeros.  The pool is ``(k, v)`` in q's dtype or the
int8 ``(k_q, k_s, v_q, v_s)`` with scales ``[num_pages, page, h_kv]``
float32: the K scale folds into the logits after the dot, the V scale into
the accumulation weights only (the denominator sums the plain
exponentials), so nothing dequantized is materialized.

:func:`paged_ragged_attention` launches the hand-written CUDA kernel
(``csrc/paged_attention.cu``) for tensors on a CUDA device and runs
:func:`paged_ragged_attention_plain` for tensors on the CPU.  There is no
fallback between the two: a CUDA tensor the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["paged_ragged_attention", "paged_ragged_attention_plain",
           "paged_decode_attention", "DEFAULT_PAGE_SIZE"]

# default pool block size; serving picks it up, tests may shrink it
DEFAULT_PAGE_SIZE = 64

# what the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_PAGE_SIZES = (32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _unpack(q: torch.Tensor, pool: Tuple):
    """``(k, v, k_s, v_s)``; the scales are None for a ``(k, v)`` pool."""
    if len(pool) == 4:
        k, k_s, v, v_s = pool
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError("an int8 pool's values must be int8")
        for s in (k_s, v_s):
            if s.dtype != torch.float32 or s.shape != k.shape[:3]:
                raise TypeError(f"an int8 pool's scales must be float32 "
                                f"{tuple(k.shape[:3])}")
    elif len(pool) == 2:
        (k, v), k_s, v_s = pool, None, None
    else:
        raise ValueError("pool is (k, v) or (k_q, k_s, v_q, v_s)")
    b, chunk, h_q, d = q.shape
    num_pages, page, h_kv, dk = k.shape
    if dk != d:
        raise ValueError(f"head_dim mismatch: q has {d}, pool has {dk}")
    if h_q % h_kv:
        raise ValueError(f"h_q={h_q} not a multiple of h_kv={h_kv} (GQA)")
    if v.shape != k.shape:
        raise ValueError(f"k pool {tuple(k.shape)} != v pool {tuple(v.shape)}")
    return k, v, k_s, v_s


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    # the scale is rounded to q's dtype, as the JAX wrapper does; it stays
    # a Python number so no host-to-device copy (and stream wait) is made
    return q * torch.tensor(scale, dtype=q.dtype).item()


def paged_ragged_attention_plain(q: torch.Tensor, pool: Tuple,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor, q_lens: torch.Tensor,
                                 *, scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_ragged_attention`: gather
    every page of the table, mask, float32 softmax, weighted sum (for an
    int8 pool with the scale folds).  The CPU path, and the yardstick the
    CUDA kernel is held to."""
    k, v, k_s, v_s = _unpack(q, pool)
    b, c, h_q, d = q.shape
    _, page, h_kv, _ = k.shape
    g = h_q // h_kv
    n_blocks = page_table.shape[1]
    t_len = n_blocks * page
    qf = _prescale(q, scale).float().reshape(b, c, h_kv, g, d)
    table = page_table.long()
    kg = k[table].float().reshape(b, t_len, h_kv, d)
    vg = v[table].float().reshape(b, t_len, h_kv, d)
    logits = torch.einsum("bckgd,btkd->bckgt", qf, kg)
    if k_s is not None:                        # K scale fold
        ksg = k_s[table].reshape(b, t_len, h_kv)
        logits = logits * ksg.permute(0, 2, 1)[:, None, :, None, :]
    t = torch.arange(t_len, device=q.device)
    qi = torch.arange(c, device=q.device)
    ln = lengths.long()[:, None, None]
    ql = q_lens.long()[:, None, None]
    mask = ((t[None, None, :] <= ln - ql + qi[None, :, None])
            & (qi[None, :, None] < ql))                         # [b, c, T]
    mask = mask[:, :, None, None, :]
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = e.sum(-1, keepdim=True)
    if v_s is not None:                        # V scale: weights only
        vsg = v_s[table].reshape(b, t_len, h_kv)
        e = e * vsg.permute(0, 2, 1)[:, None, :, None, :]
    o = torch.einsum("bckgt,btkd->bckgd", e, vg)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(b, c, h_q, d).to(q.dtype)


def _check_cuda(q, k, v, k_s, v_s, page_table, lengths, q_lens) -> None:
    dev = q.device
    for name, t in (("k pool", k), ("v pool", v), ("k scales", k_s),
                    ("v scales", v_s), ("page_table", page_table),
                    ("lengths", lengths), ("q_lens", q_lens)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k_s is None and (k.dtype != q.dtype or v.dtype != q.dtype):
        raise TypeError(f"pool dtype {k.dtype} != q dtype {q.dtype}")
    for name, t in (("page_table", page_table), ("lengths", lengths),
                    ("q_lens", q_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    d, page = q.shape[-1], k.shape[1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if page not in KERNEL_PAGE_SIZES:
        raise ValueError(f"kernel page size {page} not in {KERNEL_PAGE_SIZES}")
    b = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table {tuple(page_table.shape)} must be [{b}, P]")
    if lengths.shape != (b,) or q_lens.shape != (b,):
        raise ValueError(f"lengths/q_lens must be [{b}]")
    for name, t in (("k pool", k), ("v pool", v), ("k scales", k_s),
                    ("v scales", v_s)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k pool", k), ("v pool", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.prt_paged_ragged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn_q8 = lib.prt_paged_ragged_attention_q8
        fn_q8.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                          + [ctypes.c_void_p])
        fn_q8.restype = ctypes.c_int
        lib.prt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.prt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def paged_ragged_attention(q: torch.Tensor, pool: Tuple,
                           page_table: torch.Tensor, lengths: torch.Tensor,
                           q_lens: torch.Tensor, *,
                           scale: float) -> torch.Tensor:
    """Ragged mixed-chunk attention over a paged KV pool.

    q: ``[B, chunk, h_q, d]`` right-padded query chunks (``h_q`` a
    multiple of the pool's ``h_kv``); pool: ``(k, v)`` pages
    ``[num_pages, page, h_kv, d]`` in q's dtype, or int8 ``(k_q, k_s, v_q,
    v_s)`` with scales ``[num_pages, page, h_kv]`` float32; page_table: ``[B, P]`` int32 physical
    page per logical block -- entries up to a sequence's last block must
    be valid page ids (the serving allocator reserves page 0 as the null
    page); lengths: ``[B]`` int32 valid tokens per sequence including the
    chunk's own already-appended rows; q_lens: ``[B]`` int32 valid query
    rows (0 = dead slot; dead slots and pad rows output zeros).
    Returns ``[B, chunk, h_q, d]`` in q's dtype.

    On a CUDA device this launches the CUDA kernel and counts the launch
    in ``paged_ragged_attention.launches`` (``.launches_q8`` for an int8
    pool); on the CPU it runs :func:`paged_ragged_attention_plain`.
    """
    k, v, k_s, v_s = _unpack(q, pool)
    if q.device.type == "cpu":
        return paged_ragged_attention_plain(q, pool, page_table, lengths,
                                            q_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    _check_cuda(q, k, v, k_s, v_s, page_table, lengths, q_lens)
    b, chunk, h_q, d = q.shape
    _, page, h_kv, _ = k.shape
    qs = _prescale(q, scale).contiguous()
    table = page_table.contiguous()
    lengths = lengths.contiguous()
    q_lens = q_lens.contiguous()
    out = torch.empty_like(qs)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        dims = (b, chunk, h_q, h_kv, d, page, table.shape[1],
                _KERNEL_DTYPES[q.dtype], stream)
        if k_s is None:
            err = lib.prt_paged_ragged_attention(
                qs.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
                lengths.data_ptr(), q_lens.data_ptr(), out.data_ptr(), *dims)
        else:
            err = lib.prt_paged_ragged_attention_q8(
                qs.data_ptr(), k.data_ptr(), k_s.data_ptr(), v.data_ptr(),
                v_s.data_ptr(), table.data_ptr(), lengths.data_ptr(),
                q_lens.data_ptr(), out.data_ptr(), *dims)
    if err != 0:
        raise RuntimeError(
            f"paged_ragged_attention kernel launch failed: cudaError {err} "
            f"({lib.prt_cuda_error_string(err).decode()})")
    if k_s is None:
        paged_ragged_attention.launches += 1
    else:
        paged_ragged_attention.launches_q8 += 1
    return out


paged_ragged_attention.launches = 0
paged_ragged_attention.launches_q8 = 0


def paged_decode_attention(q: torch.Tensor, pool: Tuple,
                           page_table: torch.Tensor, lengths: torch.Tensor,
                           *, scale: float) -> torch.Tensor:
    """One-token-per-sequence attention over a paged KV pool -- the
    ``chunk == 1`` view of :func:`paged_ragged_attention` (same kernel).

    q: ``[B, h_q, d]``; lengths: ``[B]`` int32 valid tokens per sequence
    including the query's own already-appended row (0 = dead slot ->
    zero output).  Returns ``[B, h_q, d]``."""
    q_lens = (lengths > 0).to(torch.int32)
    return paged_ragged_attention(q[:, None], pool, page_table, lengths,
                                  q_lens, scale=scale)[:, 0]
