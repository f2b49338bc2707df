"""Free-list page allocator over a preallocated per-layer KV pool (the
port of ``paddle_ray_tpu/serving/page_pool.py``).

The pool is the only KV allocation the serving engine makes: one tensor
``[num_layers, num_pages, page, h_kv, d]`` per operand (K and V) on the
engine's device -- or, quantized, int8 values of that shape plus float32
per-(token, head) scales ``[num_layers, num_pages, page, h_kv]``.  Sequences borrow whole pages and return them on
retirement, so memory in use is ``pages_in_use * page_bytes`` however
long any one request runs.

Pages are refcounted: the prefix cache shares one physical page between
every request whose prompt holds the same token block (plus the cache's
own reference), and a page returns to the free list only when its last
holder lets go (:meth:`PagePool.decref`).  Double free raises, and
:meth:`free` (the strict single-owner release) raises on a page that is
still shared.

Page 0 is reserved as the null page: it is never handed out, every unused
page-table entry points at it, and masked or padded writes land in it.

The JAX pool is an immutable pytree that each compiled step donates and
returns.  Here the step functions update these tensors IN PLACE
(``index_put_`` for row appends, ``copy_`` for copy-on-write pages), so
:attr:`arrays` keeps the same tensors for the pool's whole life.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["PagePool"]


class PagePool:
    """Preallocated paged KV storage + host-side refcounted free list.

    ``arrays`` is the tuple of pool tensors the step functions read and
    update in place: ``(k, v)`` in ``dtype``, or ``(k_q, k_s, v_q, v_s)``
    when ``quantized``."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 quantized: bool = False, device=None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.quantized = quantized
        shape = (num_layers, num_pages, page_size, num_kv_heads, head_dim)
        if quantized:
            leaves = ((shape, torch.int8), (shape[:-1], torch.float32),
                      (shape, torch.int8), (shape[:-1], torch.float32))
        else:
            leaves = ((shape, dtype), (shape, dtype))
        self.arrays: Tuple[torch.Tensor, ...] = tuple(
            torch.zeros(sh, dtype=dt, device=device) for sh, dt in leaves)
        # LIFO free list: recently freed pages are re-issued first, which
        # is what the recycling tests need to prove stale KV cannot leak
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._rc = np.zeros((num_pages,), np.int32)     # 0 = free
        self._peak_in_use = 0
        self.total_pages_allocated = 0
        self.total_pages_freed = 0

    # -- allocation ------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def peak_pages_in_use(self) -> int:
        return self._peak_in_use

    @property
    def shared_pages(self) -> int:
        """Pages held by more than one reference (counted once in
        ``pages_in_use``)."""
        return int(np.sum(self._rc > 1))

    def refcount(self, page: int) -> int:
        return int(self._rc[int(page)])

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n} pages, {len(self._free)} "
                f"free of {self.num_pages - 1}")
        pages = [self._free.pop() for _ in range(n)]
        self._rc[pages] = 1
        self._peak_in_use = max(self._peak_in_use, self.pages_in_use)
        self.total_pages_allocated += n
        return pages

    def incref(self, page: int) -> None:
        """Add a holder to a live page (prefix-cache sharing)."""
        page = self._check_id(page)
        if self._rc[page] == 0:
            raise ValueError(f"incref of free page {page}")
        self._rc[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one holder; the page returns to the free list when the
        last one lets go.  Returns True iff the page was freed."""
        page = self._check_id(page)
        if self._rc[page] == 0:
            raise ValueError(f"double free of page {page}")
        self._rc[page] -= 1
        if self._rc[page] == 0:
            self._free.append(page)
            self.total_pages_freed += 1
            return True
        return False

    def free(self, pages) -> None:
        """Strict single-owner release: raises on a double free and on a
        page something else still holds."""
        for p in pages:
            p = self._check_id(p)
            if self._rc[p] == 0:
                raise ValueError(f"double free of page {p}")
            if self._rc[p] > 1:
                raise ValueError(
                    f"free of page {p} while shared (refcount "
                    f"{int(self._rc[p])}); use decref")
            self._rc[p] = 0
            self._free.append(p)
            self.total_pages_freed += 1

    def _check_id(self, p) -> int:
        p = int(p)
        if not 0 < p < self.num_pages:
            raise ValueError(f"bad page id {p}")
        return p

    # -- accounting ------------------------------------------------------
    @property
    def page_bytes(self) -> int:
        """Bytes of one page across all layers and both operands."""
        return sum(int(np.prod(a.shape[2:])) * a.element_size()
                   for a in self.arrays) * self.num_layers

    def live_bytes(self) -> int:
        """Memory held by live pages, each shared page counted once."""
        return self.pages_in_use * self.page_bytes

    def peak_live_bytes(self) -> int:
        return self._peak_in_use * self.page_bytes

    def capacity_bytes(self) -> int:
        return (self.num_pages - 1) * self.page_bytes

    def stats(self, live_tokens: Optional[int] = None) -> Dict:
        """One snapshot: free/live/shared page counts, bytes, and -- when
        the caller knows how many KV rows are valid -- internal
        fragmentation (the fraction of live page rows holding no token)."""
        live = self.pages_in_use
        frag = None
        if live_tokens is not None:
            cap = live * self.page_size
            frag = round(1.0 - live_tokens / cap, 4) if cap else 0.0
        return {
            "num_pages": self.num_pages - 1,
            "free": self.num_free,
            "live": live,
            "shared": self.shared_pages,
            "peak": self._peak_in_use,
            "live_bytes": self.live_bytes(),
            "peak_bytes": self.peak_live_bytes(),
            "fragmentation": frag,
            "allocated_total": self.total_pages_allocated,
            "freed_total": self.total_pages_freed,
        }

    @staticmethod
    def dense_bytes(batch: int, seq_len: int, num_layers: int,
                    num_kv_heads: int, head_dim: int,
                    dtype: torch.dtype = torch.bfloat16,
                    quantized: bool = False) -> int:
        """What a dense ``[B, h, T, d]`` cache would allocate for the
        same shapes (int8: a byte per value plus a float32 scale per row
        and head)."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        per_tok = (2 * num_kv_heads * (head_dim + 4) if quantized
                   else 2 * num_kv_heads * head_dim * itemsize)
        return batch * seq_len * num_layers * per_tok
