"""Draft sources for speculative decoding (a copy of
``paddle_ray_tpu/serving/spec/draft.py``, host-only numpy code).

A draft source proposes up to ``k`` continuation tokens for a decoding
request; the engine packs them behind the request's pending token as one
ragged chunk of the ordinary mixed step and keeps the longest prefix the
model's greedy argmax agrees with (``spec/verify.py``).  A draft source
never touches the device, and a bad draft costs verify work, never
correctness.

:class:`NGramDrafter` is prompt lookup: it matches the last ``n``
committed tokens of a request against that request's own prompt and
generation and proposes what followed the most recent earlier occurrence
-- no second model, per-request state only.
"""
from __future__ import annotations

from typing import Dict, List, Protocol, Sequence, runtime_checkable

import numpy as np

__all__ = ["DraftSource", "NGramDrafter"]


@runtime_checkable
class DraftSource(Protocol):
    """Host-side draft proposer, driven per request by the engine:
    ``register`` at admission with the whole prompt, ``observe`` with every
    run of committed tokens (accepted drafts and the bonus token, never a
    rejected draft), ``propose`` each step a slot decodes, ``release`` at
    retirement.  ``propose`` returns up to ``k`` tokens guessing what
    follows the pending one; an empty array means no speculation this
    step."""

    def register(self, rid: int, prompt: np.ndarray) -> None: ...

    def observe(self, rid: int, tokens: Sequence[int]) -> None: ...

    def propose(self, rid: int, k: int) -> np.ndarray: ...

    def release(self, rid: int) -> None: ...


class NGramDrafter:
    """Prompt-lookup drafting: match the request's last ``n`` tokens
    against its own history and propose what followed last time.

    ``propose`` tries n-gram sizes from ``max_ngram`` down to
    ``min_ngram``; for each it takes the most recent earlier occurrence of
    the history's last ``n`` tokens and proposes the ``k`` tokens after
    it.  A match that overlaps the history's tail means the tail is
    periodic, and its cycle is tiled out to ``k`` tokens.  A miss at every
    size proposes nothing.

    Per request: the history plus an incremental index holding, for each
    n-gram size, the last and the previous position of every n-gram seen,
    so ``observe`` costs O(tokens x sizes) and ``propose`` O(sizes),
    independent of the history's length."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}..{max_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self._hist: Dict[int, List[int]] = {}
        # rid -> {n: {ngram: (last position, previous position)}}
        self._index: Dict[int, Dict[int, Dict[tuple, tuple]]] = {}
        self.proposed_tokens = 0
        self.proposals = 0
        self.empty_proposals = 0

    # -- lifecycle -------------------------------------------------------
    def register(self, rid: int, prompt: np.ndarray) -> None:
        self._hist[rid] = []
        self._index[rid] = {n: {} for n in range(self.min_ngram,
                                                 self.max_ngram + 1)}
        self._extend(rid, np.asarray(prompt).reshape(-1))

    def observe(self, rid: int, tokens: Sequence[int]) -> None:
        self._extend(rid, tokens)

    def _extend(self, rid: int, tokens) -> None:
        h = self._hist[rid]
        idx = self._index[rid]
        for t in tokens:
            h.append(int(t))
            end = len(h)
            for n, d in idx.items():
                if end >= n:
                    pat = tuple(h[end - n:])
                    old = d.get(pat)
                    d[pat] = (end - n, old[0] if old else None)

    def release(self, rid: int) -> None:
        self._hist.pop(rid, None)
        self._index.pop(rid, None)

    def history_len(self, rid: int) -> int:
        return len(self._hist.get(rid, ()))

    # -- proposal --------------------------------------------------------
    def propose(self, rid: int, k: int) -> np.ndarray:
        h = self._hist.get(rid)
        self.proposals += 1
        if h is None or k <= 0 or len(h) < self.min_ngram + 1:
            self.empty_proposals += 1
            return np.zeros((0,), np.int32)
        idx = self._index[rid]
        for n in range(min(self.max_ngram, len(h) - 1),
                       self.min_ngram - 1, -1):
            # the index's last entry for the suffix's own n-gram is the
            # suffix itself, so the previous one is the match
            ent = idx[n].get(tuple(h[-n:]))
            j = None if ent is None else (
                ent[0] if ent[0] + n < len(h) else ent[1])
            if j is None:
                continue
            cont = h[j + n:j + n + k]
            if len(cont) < k:
                # the match overlaps the tail: the tail is periodic with
                # period len(h) - (j + n); tile the cycle out to k tokens
                p = len(h) - (j + n)
                cont = [h[j + n + (i % p)] for i in range(k)]
            self.proposed_tokens += len(cont)
            return np.asarray(cont, np.int32)
        self.empty_proposals += 1
        return np.zeros((0,), np.int32)
