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
from typing import Optional, Sequence, Tuple

import torch

from . import _build, _splitk

__all__ = ["paged_ragged_attention", "paged_ragged_attention_plain",
           "paged_ragged_attention_split_plain", "paged_decode_attention",
           "chunk_keys", "kernel_plan", "split_plan", "split_ranges",
           "DEFAULT_PAGE_SIZE"]

# default pool block size; serving picks it up, tests may shrink it
DEFAULT_PAGE_SIZE = 64

# what the CUDA kernel is instantiated for, over either pool: head dims and
# page sizes
KERNEL_HEAD_DIMS = (64, 80, 96, 128)
KERNEL_PAGE_SIZES = (32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's blocks: 16 (row, group member) pairs, 4 warps that take
# chunks of the block's pages in turn
TILE_PAIRS = 16
WARPS = 4


def chunk_keys(page: int, int8_pool: bool) -> int:
    """Keys of the chunk a warp streams at a time: 64 of an int8 pool, 32
    of one in q's dtype (8 KB of K and V at head dim 64 either way), at
    most a page (the CUDA source's ``Cfg::kKC``)."""
    return min(page, 64 if int8_pool else 32)


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


def _scores(q, pool, page_table, lengths, q_lens, scale):
    """The plain versions' common part: float32 logits ``[b, c, h_kv, g,
    T]`` over every page of the table (the K scale folded in), the mask of
    the keys each row sees, the gathered values ``[b, T, h_kv, d]`` and the
    V scales as accumulation weights (None for a pool in q's dtype)."""
    k, v, k_s, v_s = _unpack(q, pool)
    b, c, h_q, d = q.shape
    _, page, h_kv, _ = k.shape
    g = h_q // h_kv
    t_len = page_table.shape[1] * page
    qf = _prescale(q, scale).float().reshape(b, c, h_kv, g, d)
    table = page_table.long()
    kg = k[table].float().reshape(b, t_len, h_kv, d)
    vg = v[table].float().reshape(b, t_len, h_kv, d)
    logits = torch.einsum("bckgd,btkd->bckgt", qf, kg)
    w_v = None
    if k_s is not None:                        # K scale fold
        ksg = k_s[table].reshape(b, t_len, h_kv)
        logits = logits * ksg.permute(0, 2, 1)[:, None, :, None, :]
        w_v = v_s[table].reshape(b, t_len, h_kv).permute(0, 2, 1)[
            :, None, :, None, :]
    t = torch.arange(t_len, device=q.device)
    qi = torch.arange(c, device=q.device)
    ln = lengths.long()[:, None, None]
    ql = q_lens.long()[:, None, None]
    mask = ((t[None, None, :] <= ln - ql + qi[None, :, None])
            & (qi[None, :, None] < ql))                         # [b, c, T]
    return logits, mask[:, :, None, None, :], vg, w_v


def paged_ragged_attention_plain(q: torch.Tensor, pool: Tuple,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor, q_lens: torch.Tensor,
                                 *, scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_ragged_attention`: gather
    every page of the table, mask, float32 softmax, weighted sum (for an
    int8 pool with the scale folds).  The CPU path, and the yardstick the
    CUDA kernel is held to."""
    logits, mask, vg, w_v = _scores(q, pool, page_table, lengths, q_lens,
                                    scale)
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = e.sum(-1, keepdim=True)
    if w_v is not None:                        # V scale: weights only
        e = e * w_v
    o = torch.einsum("bckgt,btkd->bckgd", e, vg)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(q.shape).to(q.dtype)


def split_plan(page: int, n_blocks: int, units_per_slot: int,
               sm_count: int, lengths: Sequence[int],
               chunk: int) -> Tuple[int, int]:
    """``(n_splits, pages_per_split)`` of the kernel's split-K from the
    slots' lengths on the host, for chunks of ``chunk`` keys
    (:func:`chunk_keys`).  A slot's live pages are ``min(ceil(
    length / page), n_blocks)``; the call's work is their sum times
    ``units_per_slot`` (kv heads times pair tiles).  A split takes the
    work's share of one SM, but at least a chunk for every warp, and the
    longest slot gets as many splits as that makes -- so a long slot does
    not trail the short ones, and a card full of work is not split at all.
    Never more splits than the longest slot's pages; a slot's last split is
    the shorter one (and takes any pages past the plan's)."""
    pages = [min(-(-int(n) // page), n_blocks) for n in lengths if n > 0]
    longest = max(pages, default=0)
    if longest <= 0:
        return 1, max(1, n_blocks)
    per_page = max(1, page // chunk)                # chunks a page
    min_pages = -(-WARPS // per_page)
    work = sum(pages) * units_per_slot
    pps = max(min_pages, -(-work // max(1, sm_count)))
    n = -(-longest // pps)
    return n, -(-longest // n)


def split_ranges(lengths, q_lens, page: int, n_blocks: int, n_splits: int,
                 pages_per_split: int) -> list:
    """The ``[first, end)`` page runs of each slot's splits, as the
    kernel walks them: a live slot (``lengths > 0`` and ``q_lens > 0``)
    holds ``min(ceil(lengths / page), n_blocks)`` live pages -- the last
    one its last query row sees -- cut into runs of ``pages_per_split``,
    at most ``n_splits`` of them (the last takes the rest); a dead slot has
    none.  Host sequences of ints in, a list per slot out."""
    out = []
    for ln, ql in zip(lengths, q_lens):
        n = min(-(-int(ln) // page), n_blocks) if ln > 0 and ql > 0 else 0
        starts = list(range(0, n, pages_per_split))[:n_splits]
        out.append([(p, starts[i + 1] if i + 1 < len(starts) else n)
                    for i, p in enumerate(starts)])
    return out


def paged_ragged_attention_split_plain(q: torch.Tensor, pool: Tuple,
                                       page_table: torch.Tensor,
                                       lengths: torch.Tensor,
                                       q_lens: torch.Tensor, *, scale: float,
                                       n_splits: int, pages_per_split: int
                                       ) -> torch.Tensor:
    """Plain PyTorch version of the kernel's split-K: each run of
    ``pages_per_split`` pages (``n_splits`` runs, the last one to the end
    of the table) gives float32 ``(m, l, acc)`` per row as
    :func:`paged_ragged_attention_plain` computes them over its keys alone
    (a run whose keys a row cannot see gives ``l = 0``), and the runs are
    merged by the log-sum-exp rule, ``o = sum(acc_s e^(m_s - M)) /
    sum(l_s e^(m_s - M))`` (0 where the sum of ``l`` is 0).  Equal to the
    unsplit version up to rounding."""
    logits, mask, vg, w_v = _scores(q, pool, page_table, lengths, q_lens,
                                    scale)
    t = torch.arange(logits.shape[-1], device=q.device)
    span = pages_per_split * pool[0].shape[1]
    parts = []
    for i in range(n_splits):
        ms = mask & (t >= i * span)
        if i + 1 < n_splits:
            ms = ms & (t < (i + 1) * span)
        lg = logits.masked_fill(~ms, float("-inf"))
        m = lg.amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.full_like(m, -1e30))
        e = torch.where(ms, torch.exp(lg - m), torch.zeros_like(lg))
        l = e.sum(-1, keepdim=True)
        acc = torch.einsum("bckgt,btkd->bckgd",
                           e if w_v is None else e * w_v, vg)
        parts.append((m, l, acc))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    l_sum = sum(l * torch.exp(m - big) for m, l, _ in parts)
    acc_sum = sum(acc * torch.exp(m - big) for m, _, acc in parts)
    o = acc_sum / torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)
    return o.reshape(q.shape).to(q.dtype)


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
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.prt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.prt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _tiles(q: torch.Tensor, h_kv: int) -> int:
    """The kernel's tiles of ``TILE_PAIRS`` (row, group member) pairs per
    slot and kv head."""
    _, chunk, h_q, _ = q.shape
    return -(-chunk * (h_q // h_kv) // TILE_PAIRS)


def kernel_plan(q: torch.Tensor, pool: Tuple, page_table: torch.Tensor,
                host_lengths: Optional[Sequence[int]] = None
                ) -> Tuple[int, int]:
    """``(n_splits, pages_per_split)`` with which
    :func:`paged_ragged_attention` launches the kernel for these CUDA
    inputs: :func:`split_plan` over the call's pair tiles, the pool's
    chunk and the card's SM count; without ``host_lengths`` every slot
    counts at the table's width."""
    _, page, h_kv, _ = pool[0].shape
    n_blocks = page_table.shape[1]
    lengths = ([n_blocks * page] * q.shape[0] if host_lengths is None
               else host_lengths)
    return split_plan(page, n_blocks, h_kv * _tiles(q, h_kv),
                      _splitk.sm_count(q.device), lengths,
                      chunk_keys(page, pool[0].dtype == torch.int8))


def _launch(lib, qs, k, v, k_s, v_s, pool, table, lengths, q_lens, out,
            host_lengths) -> int:
    """The kernel with its split plan and workspace."""
    b, chunk, h_q, d = qs.shape
    _, page, h_kv, _ = k.shape
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    units = b * h_kv * _tiles(qs, h_kv)
    n_splits, pps = kernel_plan(qs, pool, table, host_lengths)
    ws_acc = ws_ml = counters = None
    if n_splits > 1:
        ws_acc = torch.empty(units * n_splits * TILE_PAIRS * d,
                             dtype=torch.float32, device=qs.device)
        ws_ml = torch.empty(units * n_splits * TILE_PAIRS * 2,
                            dtype=torch.float32, device=qs.device)
        counters = _splitk.split_counters(qs.device, stream, units)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    return lib.prt_paged_ragged_attention(
        qs.data_ptr(), k.data_ptr(), ptr(k_s), v.data_ptr(), ptr(v_s),
        table.data_ptr(), lengths.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), ptr(ws_acc), ptr(ws_ml), ptr(counters), b, chunk,
        h_q, h_kv, d, page, table.shape[1], _KERNEL_DTYPES[qs.dtype],
        int(k_s is not None), n_splits, pps, stream)


def paged_ragged_attention(q: torch.Tensor, pool: Tuple,
                           page_table: torch.Tensor, lengths: torch.Tensor,
                           q_lens: torch.Tensor, *, scale: float,
                           host_lengths: Optional[Sequence[int]] = None
                           ) -> torch.Tensor:
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
    host_lengths: optional host copy of ``lengths``, which sizes the
    kernel's split-K (:func:`split_plan`) and never changes the result.
    Returns ``[B, chunk, h_q, d]`` in q's dtype.

    On a CUDA device this launches the CUDA kernel (split-K over pages,
    :func:`kernel_plan`) and counts the launch in
    ``paged_ragged_attention.launches`` (``.launches_q8`` for an int8
    pool); on the CPU it runs :func:`paged_ragged_attention_plain`.
    """
    k, v, k_s, v_s = _unpack(q, pool)
    if q.device.type == "cpu":
        return paged_ragged_attention_plain(q, pool, page_table, lengths,
                                            q_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    _check_cuda(q, k, v, k_s, v_s, page_table, lengths, q_lens)
    qs = _prescale(q, scale).contiguous()
    out = torch.empty_like(qs)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        err = _launch(lib, qs, k, v, k_s, v_s, pool, page_table.contiguous(),
                      lengths.contiguous(), q_lens.contiguous(), out,
                      host_lengths)
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
