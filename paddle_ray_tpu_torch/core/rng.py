"""Named key streams (the port of ``paddle_ray_tpu/core/rng.py``).

The tracker keeps named streams of threefry keys (:mod:`.prng`); a draw
splits the stream's key, keeps the first half and hands out the second,
as ``jax.random.split`` does in the JAX tracker, so after :func:`seed`
the port draws the JAX package's keys bit for bit.  ``rng_state(name)``
switches the default stream: the ``LOCAL_RNG`` stream of
:func:`model_parallel_rng` is offset by the tensor-parallel rank, the
``GLOBAL_RNG`` one equal on every rank.

Keys stay on the host: a stream's key is two Python integers, and every
draw, split and fold-in hashes a few counters on Python integers
(:func:`.prng.threefry2x32` takes ints as well as tensors), so the
tracker costs no launch and no device sync.  A draw returns the port's
key, a CPU ``int64`` tensor ``[2]`` of uint32 words.

The JAX train step refuses a default draw while it traces without a key
(it would leak a tracer into the global tracker);
:meth:`..parallel.api.TrainState.step` called without ``rng`` refuses it
the same way, through :func:`refuse_default_draws`.  With a key, the step
serves draws from :func:`key_scope`: the key folded with the stream's
tag and a counter, fresh every step.  Outside a step, eager draws advance
the stream as JAX's eager draws do.

``torch.utils.checkpoint`` runs a block's Python again in the backward;
:func:`checkpoint_contexts` gives it the tracker and scope state of the
forward, so a recomputed draw gets the forward's key.
"""
from __future__ import annotations

import contextlib
import threading
import zlib
from typing import Dict, Iterator, Optional, Tuple

import torch

from . import prng

__all__ = ["seed", "next_key", "key_scope", "refuse_default_draws",
           "checkpoint_contexts", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_rng", "LOCAL_RNG",
           "GLOBAL_RNG"]

GLOBAL_RNG = "global_seed"
LOCAL_RNG = "local_seed"

_Words = Tuple[int, int]


def _key(words: _Words) -> torch.Tensor:
    return torch.tensor(words, dtype=torch.int64)


def _split2(words: _Words) -> Tuple[_Words, _Words]:
    """``jax.random.split(key)`` on host words: the hashes of the counters
    0 and 1."""
    a = prng.threefry2x32(*words, 0, 0)
    b = prng.threefry2x32(*words, 0, 1)
    return a, b


def _fold_in(words: _Words, data: int) -> _Words:
    """``jax.random.fold_in(key, data)`` on host words."""
    return prng.threefry2x32(*words, 0, int(data) & 0xFFFFFFFF)


_SCOPE = threading.local()


def _refusing() -> bool:
    return getattr(_SCOPE, "refuse", False)


class RNGStatesTracker:
    """Named key streams (mirrors ``RNGStatesTracker``,
    ``fleet/layers/mpu/random.py:35``)."""

    def __init__(self):
        self._states: Dict[str, _Words] = {}
        self._current: str = GLOBAL_RNG
        self._lock = threading.Lock()
        self.add(GLOBAL_RNG, 0)

    def reset(self) -> None:
        with self._lock:
            self._states.clear()
            self._current = GLOBAL_RNG
        self.add(GLOBAL_RNG, 0)

    def add(self, name: str, seed: int) -> None:
        with self._lock:
            # jax.random.PRNGKey(seed): [0, seed mod 2**32]
            self._states[name] = prng.key_words((0, seed))

    def states(self) -> Dict[str, torch.Tensor]:
        with self._lock:
            return {n: _key(w) for n, w in self._states.items()}

    def set_states(self, states: Dict[str, torch.Tensor]) -> None:
        """Full overwrite: streams not in ``states`` are dropped, so a
        restore really restores."""
        words = {n: prng.key_words(k) for n, k in states.items()}
        with self._lock:
            self._states = words

    def next(self, name: Optional[str] = None) -> torch.Tensor:
        """Split the named stream, advance it, return a fresh key.  Inside
        a train step given no key this raises, as the traced JAX step
        does, and leaves the stream as it was."""
        name = name or self._current
        if _refusing():
            raise RuntimeError(
                "default-rng draw inside a train step given no key: pass "
                "rng= to TrainState.step / the module call, or wrap the "
                "computation in core.rng.key_scope(key)")
        with self._lock:
            if name not in self._states:
                raise KeyError(f"rng stream {name!r} not initialized; call "
                               f"seed() or add()")
            keep, sub = _split2(self._states[name])
            self._states[name] = keep
            return _key(sub)

    @contextlib.contextmanager
    def rng_state(self, name: str = GLOBAL_RNG) -> Iterator[None]:
        prev = self._current
        self._current = name
        try:
            yield
        finally:
            self._current = prev

    @property
    def current(self) -> str:
        return self._current


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    """Mirror of ``get_rng_state_tracker`` (``mpu/random.py:85``)."""
    return _TRACKER


def seed(value: int) -> None:
    """Seed the global stream (mirror of ``paddle.seed``)."""
    _TRACKER.reset()
    _TRACKER.add(GLOBAL_RNG, value)


@contextlib.contextmanager
def key_scope(key) -> Iterator[None]:
    """Serve :func:`next_key` from ``key`` folded with the stream's tag
    (``crc32(name) >> 1``) and then with the stream's own counter (1 for
    the first draw), instead of from the tracker: fresh across steps
    because each step passes a new key, the same within a step."""
    prev = getattr(_SCOPE, "state", None)
    _SCOPE.state = (prng.key_words(key), {})
    try:
        yield
    finally:
        _SCOPE.state = prev


@contextlib.contextmanager
def refuse_default_draws() -> Iterator[None]:
    """Make a tracker draw outside any :func:`key_scope` raise
    ``RuntimeError`` (a train step given no key)."""
    prev = _refusing()
    _SCOPE.refuse = True
    try:
        yield
    finally:
        _SCOPE.refuse = prev


def next_key(name: Optional[str] = None) -> torch.Tensor:
    """A fresh key: from the active :func:`key_scope`, else from the
    default (or named) tracker stream."""
    st = getattr(_SCOPE, "state", None)
    if st is not None:
        key, counters = st
        name = name or _TRACKER.current
        counters[name] = counters.get(name, 0) + 1
        tagged = _fold_in(key, zlib.crc32(name.encode()) >> 1)
        return _key(_fold_in(tagged, counters[name]))
    return _TRACKER.next(name)


def model_parallel_rng(base_seed: int, mp_rank: int, mp_degree: int) -> None:
    """Seed the tracker as hybrid-parallel training does: the global
    stream equal on every tensor-parallel rank, the local stream offset by
    the rank."""
    _TRACKER.reset()
    _TRACKER.add(GLOBAL_RNG, base_seed)
    _TRACKER.add(LOCAL_RNG, base_seed + 2718 + mp_rank)


def _capture():
    """Everything a draw reads and advances: the streams, the default
    stream's name, the key scope (its counters copied) and the refusal."""
    t = _TRACKER
    with t._lock:
        streams = (dict(t._states), t._current)
    st = getattr(_SCOPE, "state", None)
    return (streams, None if st is None else (st[0], dict(st[1])),
            _refusing())


def _restore(snap) -> None:
    (states, current), st, refuse = snap
    t = _TRACKER
    with t._lock:
        t._states, t._current = dict(states), current
    _SCOPE.state = None if st is None else (st[0], dict(st[1]))
    _SCOPE.refuse = refuse


def checkpoint_contexts():
    """``(forward, recompute)`` context managers for the ``context_fn`` of
    ``torch.utils.checkpoint``: the forward notes the tracker and scope
    state as the checkpointed function starts; the recompute runs under
    that state (on whatever thread autograd runs it) and then puts back
    the state it found.  So every draw of the recompute returns the key
    the forward drew."""
    snap = []

    @contextlib.contextmanager
    def forward():
        snap[:] = [_capture()]
        yield

    @contextlib.contextmanager
    def recompute():
        prev = _capture()
        _restore(snap[0])
        try:
            yield
        finally:
            _restore(prev)

    return forward(), recompute()
