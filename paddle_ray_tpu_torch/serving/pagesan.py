"""pagesan: shadow-state lifetime sanitizer for the paged KV allocator
(the port of ``paddle_ray_tpu/serving/pagesan.py``, host-only numpy code).

The pool's refcounts are hard errors already, but they only see what the
pool is told.  Serving bugs live one level up, in the engine and cache
choreography: a page-table row that still points at a freed page, a write
to a page two requests share (copy-on-write skipped), a recycled page
read through a retired mapping (stale KV), pages that never return (a
leak).  The sanitizer is opt-in (``ServingEngine(sanitize=True)``) and
host-only; it changes nothing the device runs.

Every page carries a shadow refcount (kept by wrapping the pool's
``alloc`` / ``incref`` / ``decref`` / ``free``, so the prefix cache's own
traffic is seen), a write epoch (bumped by every allocation and write;
a gather must find the epoch its owner recorded), and a row watermark.
Speculative decoding adds the append-only rule: an owner's append must
start at its committed watermark on the page unless :meth:`note_rollback`
retreated it first.  Async dispatch adds the deferred ledger: every
dispatched step reconciles or aborts exactly once, in dispatch order
(:meth:`note_defer` / :meth:`note_reconcile` / :meth:`note_abort`).

The port's engine writes its pool tensors in place on one stream; a
discarded in-flight lane has already written its rows, and the rollback
books here (watermark retreat, emptied pages unmapped) describe exactly
what the host then knows: those rows sit past the slot's length, where
attention never reads them.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from .page_pool import PagePool

__all__ = ["PageSanError", "PageSanitizer"]


class PageSanError(RuntimeError):
    """A page-lifetime invariant violation caught by the shadow state."""


class PageSanitizer:
    """Shadow page-lifecycle tracker wrapped around one :class:`PagePool`.

    Construction instruments the pool instance in place (its
    ``alloc``/``incref``/``decref``/``free`` become checking wrappers);
    :meth:`detach` restores it.  ``owner`` in the note_* API is any
    hashable id for the reading/writing sequence — the engine uses the
    request id.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        n = pool.num_pages
        self._rc = np.zeros((n,), np.int64)
        self._epoch = np.zeros((n,), np.int64)
        self._rows = np.zeros((n,), np.int32)
        self._peak = 0
        self._clock = 0
        self._allocated = 0                # shadow churn counters
        self._freed = 0
        # owner -> {page: epoch the owner's mapping expects}
        self._expected: Dict[object, Dict[int, int]] = {}
        # owner -> {page: committed in-page row watermark} — appends may
        # only start AT the watermark (append-only unless rolled back)
        self._committed: Dict[object, Dict[int, int]] = {}
        # dispatched-but-unreconciled step ids, in dispatch order: the
        # double-buffered engine defers each step's commit by one
        # dispatch, and the books only stay exact if every deferred
        # step reconciles exactly once, in the order it was dispatched
        self._deferred: List[object] = []
        self.events = 0                    # checks performed (telemetry)
        self._orig = {name: getattr(pool, name)
                      for name in ("alloc", "incref", "decref", "free")}
        pool.alloc = self._alloc           # type: ignore[method-assign]
        pool.incref = self._incref         # type: ignore[method-assign]
        pool.decref = self._decref         # type: ignore[method-assign]
        pool.free = self._free             # type: ignore[method-assign]

    def detach(self) -> None:
        """Un-instrument the pool (the shadow state stops updating)."""
        for name, fn in self._orig.items():
            setattr(self.pool, name, fn)

    # -- pool lifecycle wrappers -----------------------------------------
    def _bump(self, page: int) -> int:
        self._clock += 1
        self._epoch[page] = self._clock
        return self._clock

    def _alloc(self, n: int) -> List[int]:
        pages = self._orig["alloc"](n)
        for p in pages:
            self.events += 1
            if self._rc[p] != 0:
                raise PageSanError(
                    f"allocator handed out page {p} with live shadow "
                    f"refcount {int(self._rc[p])} (free-list corruption)")
            self._rc[p] = 1
            self._rows[p] = 0
            self._bump(p)                  # new lifetime: old maps go stale
        self._peak = max(self._peak, int(np.sum(self._rc > 0)))
        self._allocated += len(pages)
        return pages

    def _incref(self, page) -> None:
        page = int(page)
        self.events += 1
        if not 0 < page < self.pool.num_pages:
            raise PageSanError(f"incref of invalid page id {page}")
        if self._rc[page] == 0:
            raise PageSanError(f"incref of free page {page} "
                               "(use-after-free share)")
        self._rc[page] += 1
        self._orig["incref"](page)

    def _decref(self, page) -> bool:
        page = int(page)
        self.events += 1
        if not 0 < page < self.pool.num_pages:
            raise PageSanError(f"decref of invalid page id {page}")
        if self._rc[page] == 0:
            raise PageSanError(f"double free of page {page} (decref of a "
                               "page already on the free list)")
        self._rc[page] -= 1
        if self._rc[page] == 0:
            self._freed += 1
        return self._orig["decref"](page)

    def _free(self, pages) -> None:
        pages = [int(p) for p in pages]
        for p in pages:
            self.events += 1
            if not 0 < p < self.pool.num_pages:
                raise PageSanError(f"free of invalid page id {p}")
            if self._rc[p] == 0:
                raise PageSanError(f"double free of page {p}")
            if self._rc[p] > 1:
                raise PageSanError(
                    f"free of page {p} while shared (shadow refcount "
                    f"{int(self._rc[p])}); shared pages release through "
                    "decref")
        self._orig["free"](pages)
        for p in pages:
            self._rc[p] = 0
        self._freed += len(pages)

    # -- engine-reported data movement -----------------------------------
    def note_append(self, owner, pages: List[int], start: int, end: int,
                    page_size: int) -> None:
        """A slot is about to append KV rows ``[start, end)`` of its
        sequence into its page run ``pages``.  Each touched page must be
        exclusively held (a write to a refcount>1 page is a missed
        copy-on-write, silently corrupting every other holder), and the
        write must START at the owner's committed watermark on that
        page — rewinding into committed rows without an intervening
        :meth:`note_rollback` means a verify step's rejected draft rows
        were never rolled back (the books say they are valid KV)."""
        if end <= start:
            return
        wm = self._committed.setdefault(owner, {})
        for bi in range(start // page_size, (end - 1) // page_size + 1):
            page = int(pages[bi])
            if page == 0:                  # null page: masked writes
                continue
            self.events += 1
            if self._rc[page] == 0:
                raise PageSanError(
                    f"write to freed page {page} (rows "
                    f"{start}:{end} of owner {owner!r}): use-after-free")
            if self._rc[page] > 1:
                raise PageSanError(
                    f"write to SHARED page {page} (shadow refcount "
                    f"{int(self._rc[page])}) by owner {owner!r}; "
                    "copy-on-write was skipped")
            r0 = max(start - bi * page_size, 0)
            r1 = min(end - bi * page_size, page_size)
            committed = wm.get(page)
            if committed is not None and r0 < committed:
                raise PageSanError(
                    f"append by owner {owner!r} rewinds into committed "
                    f"rows on page {page} (write starts at row {r0}, "
                    f"watermark {committed}) without a rollback — "
                    "rejected draft tokens were not rolled back")
            self._expected.setdefault(owner, {})[page] = self._bump(page)
            wm[page] = r1
            self._rows[page] = max(int(self._rows[page]), r1)

    def note_rollback(self, owner, pages: List[int], new_end: int,
                      old_end: int, page_size: int) -> None:
        """A verify step rejected draft rows ``[new_end, old_end)`` that
        :meth:`note_append` had recorded: retreat the owner's committed
        watermark and the page row accounting so the next step may
        legally re-append at ``new_end``.  Pages the retreat empties
        entirely are UNMAPPED from the owner (the engine frees them
        back to the pool; a later gather through one is caught as
        unmapped/use-after-free)."""
        if old_end <= new_end:
            return
        exp = self._expected.get(owner, {})
        wm = self._committed.get(owner, {})
        for bi in range(new_end // page_size, (old_end - 1) // page_size + 1):
            page = int(pages[bi])
            if page == 0:
                continue
            self.events += 1
            if self._rc[page] == 0:
                raise PageSanError(
                    f"rollback by owner {owner!r} touches freed page "
                    f"{page}: use-after-free")
            keep = max(new_end - bi * page_size, 0)
            if page in wm:
                wm[page] = min(wm[page], keep)
            self._rows[page] = min(int(self._rows[page]), keep)
            if keep == 0:
                exp.pop(page, None)
                wm.pop(page, None)

    def note_gather(self, owner, pages: Iterable[int]) -> None:
        """A slot's attention is about to gather from ``pages``.  Every
        page must be live, mapped by this owner, and carry the exact
        write-epoch the owner recorded — a newer epoch means the rows
        were recycled or overwritten under the mapping (stale KV)."""
        exp = self._expected.get(owner, {})
        for p in pages:
            p = int(p)
            if p == 0:
                continue
            self.events += 1
            if self._rc[p] == 0:
                raise PageSanError(
                    f"use-after-free gather: owner {owner!r} reads page "
                    f"{p} which is on the free list")
            want = exp.get(p)
            if want is None:
                raise PageSanError(
                    f"gather through unmapped page-table entry: owner "
                    f"{owner!r} reads page {p} it never wrote, shared "
                    "or copied")
            if int(self._epoch[p]) != want:
                raise PageSanError(
                    f"stale-KV read: owner {owner!r} expects epoch "
                    f"{want} on page {p}, but the page is at epoch "
                    f"{int(self._epoch[p])} (rows were recycled or "
                    "overwritten under a live mapping)")

    def note_share(self, owner, page: int) -> None:
        """``owner`` maps a cache-shared page read-only (full-page
        prefix hit): record the epoch its rows must keep."""
        page = int(page)
        self.events += 1
        if self._rc[page] == 0:
            raise PageSanError(
                f"share of freed page {page} with owner {owner!r}")
        self._expected.setdefault(owner, {})[page] = int(self._epoch[page])

    def note_copy(self, owner, src: int, dst: int, rows: int) -> None:
        """Copy-on-write: ``src``'s rows device-copied into ``owner``'s
        own ``dst``.  ``src`` must still be live (the eviction-recycle
        race the cache's lock pin exists for), ``dst`` exclusively
        owned."""
        src, dst = int(src), int(dst)
        self.events += 1
        if self._rc[src] == 0:
            raise PageSanError(
                f"copy-on-write reads freed source page {src}")
        if self._rc[dst] != 1:
            raise PageSanError(
                f"copy-on-write target page {dst} has shadow refcount "
                f"{int(self._rc[dst])}, want exclusive ownership")
        self._rows[dst] = max(int(self._rows[dst]), int(rows))
        self._expected.setdefault(owner, {})[dst] = self._bump(dst)
        # appends into the CoW page legally start at the copied rows
        self._committed.setdefault(owner, {})[dst] = int(rows)

    # -- deferred (double-buffered) commits --------------------------------
    def note_defer(self, step_id) -> None:
        """A step was DISPATCHED with its commit deferred (async
        double-buffering): it must later reconcile via
        :meth:`note_reconcile`, in dispatch order."""
        if step_id in self._deferred:
            raise PageSanError(
                f"step {step_id!r} deferred twice (double dispatch)")
        self._deferred.append(step_id)

    def _settle_deferred(self, step_id, verb: str) -> None:
        """The ONE deferred-ledger settlement: the step must be the
        OLDEST outstanding deferred step — settling out of order means
        commits (or their rollbacks) are applied against the wrong
        predicted state; settling a step that was never deferred means
        a commit/discard path bypassed dispatch bookkeeping."""
        self.events += 1
        if not self._deferred:
            raise PageSanError(
                f"{verb} of step {step_id!r} that was never deferred "
                f"({verb} without a dispatch record)")
        if self._deferred[0] != step_id:
            raise PageSanError(
                f"out-of-order {verb}: step {step_id!r} settled while "
                f"step {self._deferred[0]!r} (dispatched earlier) is "
                f"still outstanding — deferred steps {verb} in "
                "dispatch order")
        self._deferred.pop(0)

    def note_reconcile(self, step_id) -> None:
        """A deferred step's commit was reconciled (oldest-first —
        see :meth:`_settle_deferred`)."""
        self._settle_deferred(step_id, "reconcile")

    def note_abort(self, step_id) -> None:
        """A deferred step was DISCARDED whole (step-failure
        containment: the engine rolled every lane back to the last
        reconciled state instead of committing).  Same oldest-first
        contract as :meth:`note_reconcile`, so a discard can never
        leapfrog an earlier step whose rows the books still count as
        in flight."""
        self._settle_deferred(step_id, "abort")

    def note_release(self, owner) -> None:
        """``owner`` retired: its mappings end (the pages live on under
        their remaining refs)."""
        self._expected.pop(owner, None)
        self._committed.pop(owner, None)

    # -- terminal checks --------------------------------------------------
    def check_drain(self, accounted: Iterable[int] = ()) -> None:
        """At engine drain every live page must be deliberately held —
        ``accounted`` is the prefix cache's page list.  Anything else
        still off the free list leaked."""
        if self._deferred:
            raise PageSanError(
                f"{len(self._deferred)} dispatched step(s) never "
                f"reconciled at drain ({self._deferred[:8]}): their "
                "commits were DROPPED — appended rows are unaccounted "
                "and requests may be missing tokens")
        held = set(int(p) for p in accounted)
        leaked = [int(p) for p in np.nonzero(self._rc > 0)[0]
                  if int(p) not in held]
        if leaked:
            raise PageSanError(
                f"{len(leaked)} page(s) leaked at drain: {leaked[:16]} "
                "are live but neither a slot nor the prefix cache "
                "accounts for them")

    def verify_pool(self) -> None:
        """The shadow state and the pool's own accounting must agree
        EXACTLY — a mismatch means a lifecycle event bypassed the
        wrappers (or the pool's books drifted)."""
        rc = self.pool._rc
        if not np.array_equal(self._rc, rc.astype(np.int64)):
            bad = np.nonzero(self._rc != rc)[0]
            raise PageSanError(
                f"shadow/pool refcount mismatch on pages {bad[:16]}: "
                f"shadow {self._rc[bad[:16]]}, pool {rc[bad[:16]]}")
        free_set = set(self.pool._free)
        shadow_free = set(int(p) for p in np.nonzero(self._rc == 0)[0]
                          if p != 0)
        if free_set != shadow_free:
            raise PageSanError(
                "shadow free set disagrees with the pool free list: "
                f"only-pool={sorted(free_set - shadow_free)[:8]} "
                f"only-shadow={sorted(shadow_free - free_set)[:8]}")
        if self._peak != self.pool.peak_pages_in_use:
            raise PageSanError(
                f"shadow peak {self._peak} != pool peak "
                f"{self.pool.peak_pages_in_use}")

    def snapshot(self) -> Dict:
        """One-line shadow-state summary: enough to see at a glance
        whether the books were mid-flight (outstanding deferred steps,
        live owners)."""
        return {
            "events": self.events,
            "live_pages": self.live_pages,
            "shared_pages": self.shared_pages,
            "live_rows": self.live_rows(),
            "peak_pages": self._peak,
            "deferred_steps": len(self._deferred),
            "owners": len(self._expected),
        }

    # -- shadow accounting -------------------------------------------------
    @property
    def live_pages(self) -> int:
        return int(np.sum(self._rc > 0))

    @property
    def shared_pages(self) -> int:
        return int(np.sum(self._rc > 1))

    def live_rows(self) -> int:
        """Valid KV rows across live pages (each page counted once)."""
        return int(np.sum(self._rows[self._rc > 0]))

    def shared_bytes(self) -> int:
        """HBM the sharing actually saves: every holder past the first
        on every shared page."""
        extra = np.maximum(self._rc - 1, 0)
        return int(np.sum(extra[1:])) * self.pool.page_bytes

    def shadow_stats(self, live_tokens: Optional[int] = None) -> Dict:
        """Shadow reconstruction of :meth:`PagePool.stats` — must agree
        exactly (the property tests interleave adversarial alloc/free/
        CoW sequences and diff the two dicts)."""
        live = self.live_pages
        frag = None
        if live_tokens is not None:
            cap = live * self.pool.page_size
            frag = round(1.0 - live_tokens / cap, 4) if cap else 0.0
        pb = self.pool.page_bytes
        return {
            "num_pages": self.pool.num_pages - 1,
            "free": (self.pool.num_pages - 1) - live,
            "live": live,
            "shared": self.shared_pages,
            "peak": self._peak,
            "live_bytes": live * pb,
            "peak_bytes": self._peak * pb,
            "fragmentation": frag,
            "allocated_total": self._allocated,
            "freed_total": self._freed,
        }
