"""Cross-request prefix cache: a token-id radix tree over KV pages (a
copy of ``paddle_ray_tpu/serving/prefix_cache.py``, which is host-only
numpy code, held against the port's :class:`~.page_pool.PagePool`).

Millions of users share system prompts and few-shot templates; their
KV rows are identical (same token ids at the same absolute positions,
so even rotary agrees), yet a cold engine recomputes and re-stores
them per request.  This cache turns the page table into a
content-addressed store, vLLM-style:

* the tree is keyed by FULL pages of token ids (``page_size`` tokens
  per node, path = prompt prefix); each node pins one physical page in
  the :class:`~.page_pool.PagePool` with a cache-resident reference;
* a **full-page hit** shares the physical page outright: the request
  increfs it and maps it read-only in its page table — zero compute,
  zero copy, zero extra HBM (refcounted pages count once);
* **partial-page divergence** (the prompt leaves a cached page's token
  run mid-page, or the hit would swallow the whole prompt) is resolved
  by COPY-ON-WRITE: the engine allocates a fresh page and device-copies
  the cached rows, so the request appends into its own copy and the
  shared page is never mutated — a page copy replaces recomputing up
  to ``page_size - 1`` tokens of prefill;
* nodes whose page nobody else holds (refcount 1 = cache only) are
  LRU-EVICTED leaf-first under pool pressure, so the cache borrows
  only otherwise-idle pages and admission can always reclaim them.

Insertion happens when a request finishes prefill (its prompt KV is
then bit-complete): every full prompt page either joins the tree (one
incref — the cache's own hold) or is deduped against an existing node.
Partial tail pages are never inserted, so a request's mutable tail —
the page decode appends into — is never shared and decode needs no
write barrier.

The cache moves no data itself: lookups return share/copy *decisions*
(:class:`PrefixMatch`) and the engine executes the whole-page copy
those decisions need.  All bookkeeping is host-side
Python, same as the pool's free list.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from .page_pool import PagePool

__all__ = ["PrefixCache", "PrefixMatch"]


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = 0


@dataclasses.dataclass
class PrefixMatch:
    """A lookup decision: which cached pages to share outright, and
    (at most) one page to copy-on-write.  ``hit_tokens`` =
    ``len(shared) * page_size + copy_rows`` — prompt rows whose KV the
    engine gets without prefill compute; capped at ``t0 - 1`` so there
    is always one token left to prefill (its logits seed sampling)."""
    shared: List[int]                  # physical page per full-hit block
    copy_src: Optional[int] = None     # page to CoW (None = no copy)
    copy_rows: int = 0                 # valid rows inside the CoW page
    hit_tokens: int = 0
    # the tree nodes behind the decision (for lock's incref/LRU touch)
    nodes: List = dataclasses.field(default_factory=list, repr=False)


def _common(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixCache:
    """Token-id radix tree mapping cached prompt prefixes to page ids."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._clock = itertools.count(1)
        self.hits = 0                   # lookups that shared/copied >0
        self.misses = 0
        self.hit_tokens_total = 0
        # bumped on every structural change (insert/evict/clear) — lets
        # callers memoize match() results safely
        self.generation = 0

    # -- introspection ---------------------------------------------------
    def _nodes(self) -> List[_Node]:
        out, stack = [], list(self._root.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    @property
    def cached_pages(self) -> int:
        return len(self._nodes())

    def pages(self) -> List[int]:
        """Physical page ids the cache currently pins (each holds a
        FULL page of prompt tokens)."""
        return [n.page for n in self._nodes()]

    def evictable_pages(self) -> int:
        """Pages the cache could hand back under pressure: every
        cache-only (refcount 1) node.  Pinned DESCENDANTS don't shelter
        them — :meth:`evict` may drop a pinned leaf node (releasing
        only the cache's hold, the page stays with its other holders)
        to expose a reclaimable interior, so every refcount-1 page is
        eventually reachable."""
        return sum(1 for n in self._nodes()
                   if self.pool.refcount(n.page) == 1)

    # -- lookup ----------------------------------------------------------
    def match(self, prompt: np.ndarray) -> PrefixMatch:
        """Pure decision (no refcount side effects): longest cached
        prefix of ``prompt`` as full-page shares plus an optional
        partial-page CoW.  Call :meth:`lock` to take the shares."""
        tokens = tuple(int(t) for t in prompt)
        page = self.page_size
        max_match = len(tokens) - 1
        shared_nodes: List[_Node] = []
        level = self._root
        i = 0
        while i + page <= max_match:
            child = level.get(tokens[i:i + page])
            if child is None:
                break
            shared_nodes.append(child)
            i += page
            level = child.children
        # partial tail: the child sharing the longest in-page run (a
        # divergent continuation, a short remainder, or a whole-prompt
        # hit demoted so one token is left to prefill)
        best, best_c = None, 0
        rem = tokens[i:]
        for key, child in level.items():
            c = _common(key, rem)
            if c > best_c:
                best, best_c = child, c
        copy_rows = min(best_c, max_match - i) if best else 0
        return PrefixMatch(
            shared=[n.page for n in shared_nodes],
            copy_src=best.page if copy_rows > 0 else None,
            copy_rows=copy_rows,
            hit_tokens=i + copy_rows,
            nodes=shared_nodes + ([best] if copy_rows > 0 else []))

    def lock(self, m: PrefixMatch) -> None:
        """Take the match: incref every shared page (the requester's
        hold) and refresh LRU clocks on the touched path.  The CoW
        source is pinned too — page allocation between lock and the
        copy may trigger eviction, which must not free (and recycle!)
        the very page about to be read; the engine drops the pin via
        :meth:`release_copy_src` once the copy ran."""
        now = next(self._clock)
        for n in m.nodes:
            n.last_used = now
        for p in m.shared:
            self.pool.incref(p)
        if m.copy_src is not None:
            self.pool.incref(m.copy_src)

    def unlock(self, m: PrefixMatch) -> None:
        """Roll a :meth:`lock` back (admission gate said no)."""
        for p in m.shared:
            self.pool.decref(p)
        if m.copy_src is not None:
            self.pool.decref(m.copy_src)

    def release_copy_src(self, m: PrefixMatch) -> None:
        """Drop the CoW-source pin after the page copy has run."""
        if m.copy_src is not None:
            self.pool.decref(m.copy_src)

    def record(self, m: PrefixMatch) -> None:
        """Count the match in the hit-rate stats — called once per
        ADMITTED request (a gated-then-requeued request re-matches)."""
        if m.hit_tokens > 0:
            self.hits += 1
            self.hit_tokens_total += m.hit_tokens
        else:
            self.misses += 1

    # -- insertion -------------------------------------------------------
    def insert(self, prompt: np.ndarray, block_pages: List[int]) -> int:
        """Register a fully-prefilled prompt's FULL pages.  For each
        full page of ``prompt``: dedupe against an existing node, else
        adopt the request's physical page (one incref — the cache's
        hold).  Partial tails never enter the tree (they are the rows
        decode appends into).  Returns the number of new nodes."""
        tokens = tuple(int(t) for t in prompt)
        page = self.page_size
        now = next(self._clock)
        level, parent, added = self._root, None, 0
        for bi in range(len(tokens) // page):
            key = tokens[bi * page:(bi + 1) * page]
            node = level.get(key)
            if node is None:
                node = _Node(key, int(block_pages[bi]), parent)
                self.pool.incref(node.page)
                level[key] = node
                added += 1
            node.last_used = now
            level, parent = node.children, node
        if added:
            self.generation += 1
        return added

    # -- eviction --------------------------------------------------------
    def evict(self, n_pages: int) -> int:
        """Free at least ``n_pages`` pages by dropping LEAVES in LRU
        order — evicting an interior node would orphan reachable
        children, so pressure eats the tree from the tips inward.
        Cache-only (refcount-1) leaves actually free their page; when
        none remain but reclaimable interiors exist, the LRU PINNED
        leaf is dropped too — that releases only the cache's hold (the
        page lives on under the running request that shares it) and
        exposes the interior for the next round, so a still-running
        request's freshly-inserted chain can never deadlock eviction.
        One tree walk frees a whole LRU batch; returns pages freed."""
        freed = 0
        reclaimable = self.evictable_pages()
        while freed < n_pages and reclaimable > 0:
            leaves = sorted((n for n in self._nodes() if not n.children),
                            key=lambda n: n.last_used)
            free_leaves = [n for n in leaves
                           if self.pool.refcount(n.page) == 1]
            if free_leaves:
                for v in free_leaves:
                    if freed >= n_pages:
                        break
                    self._drop(v)
                    freed += 1
                    reclaimable -= 1
            else:
                # every leaf pinned but reclaimable interiors remain:
                # shed the whole pinned tier (frees nothing — only the
                # cache's holds — and exposes the parents next round)
                for v in leaves:
                    self._drop(v)
        return freed

    def _drop(self, node: _Node) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._root)
        del siblings[node.key]
        self.pool.decref(node.page)
        self.generation += 1

    def clear(self) -> int:
        """Release every cache-held page (leaf-first); pages shared
        with live requests stay alive under the requests' own refs."""
        freed = 0
        # leaf-first cascade until the tree is empty
        while True:
            leaves = [n for n in self._nodes() if not n.children]
            if not leaves:
                break
            for n in leaves:
                self._drop(n)
                freed += 1
        return freed
