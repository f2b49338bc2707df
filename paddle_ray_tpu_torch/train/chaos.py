"""Deterministic fault schedules for the train loop (the port of
``paddle_ray_tpu/train/chaos.py``, host-only numpy code).

A :class:`TrainFaultPlan` is a seeded, step-indexed schedule of faults
that :class:`~.loop.ResilientTrainLoop` consults at its hook sites, with
the surface of the serving :class:`~..serving.chaos.FaultPlan`: consumed
on fire, journaled, and round-tripped by :meth:`TrainFaultPlan.to_dict`
/ :meth:`TrainFaultPlan.from_dict` (a dump of either package loads in the
other, and one seed draws one schedule in both).  The kinds:

* ``kill`` -- a simulated process death at the start of the scheduled
  step, raised as :class:`ChaosKill`: no cleanup, no final save; the next
  life recovers from committed checkpoints alone.  A kill one step after
  a checkpoint boundary lands between the overlapped save and its commit;
* ``save_io`` -- the checkpoint write at the scheduled step tag fails
  (through ``CheckpointManager.fault_injector``, after the scratch
  directory exists): training goes on, the checkpoint is skipped, and the
  orphaned directory is reaped;
* ``fetch`` -- the loss fetch raises once: the loop reads the still-live
  device tensor again, so the curve cannot change;
* ``preempt_signal`` -- the SIGTERM-style notice: the loop saves out of
  interval, synchronously, and returns with status ``"preempted"``.

With ``chaos=None`` every hook site is a guarded no-op.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..serving.chaos import ChaosError

__all__ = ["ChaosKill", "PreemptSignal", "TRAIN_FAULT_KINDS",
           "TrainFaultEvent", "TrainFaultPlan"]

TRAIN_FAULT_KINDS = ("kill", "save_io", "fetch", "preempt_signal")

# plan dict schema version (dumps embed it; from_dict validates)
TRAIN_FAULT_PLAN_SCHEMA = 1


class ChaosKill(ChaosError):
    """An injected process death.  It escapes ``ResilientTrainLoop.run``
    unsoftened (a SIGKILL runs no cleanup that matters); the one
    in-process concession is joining the background checkpoint write
    uncommitted (``CheckpointManager.abandon``), so that the next life's
    orphan reaper does not race the writer thread."""


@dataclasses.dataclass
class TrainFaultEvent:
    """One scheduled fault: fires when the loop consults the hook of its
    kind at its step index (for ``save_io``, the checkpoint's step tag)."""
    step: int
    kind: str

    def as_dict(self) -> Dict:
        return {"step": int(self.step), "kind": self.kind}


class TrainFaultPlan:
    """A deterministic, step-indexed fault schedule for the train loop: at
    most one event per ``(step, kind)``; :meth:`take` consumes the event
    and journals it in :attr:`fired`, so a site reached again after a
    recovery does not fire again."""

    def __init__(self, events: Optional[List[TrainFaultEvent]] = None, *,
                 seed: Optional[int] = None):
        self.seed = seed
        self._events: Dict[Tuple[int, str], TrainFaultEvent] = {}
        for ev in (events or []):
            if ev.kind not in TRAIN_FAULT_KINDS:
                raise ValueError(f"unknown train fault kind {ev.kind!r}; "
                                 f"have {TRAIN_FAULT_KINDS}")
            key = (int(ev.step), ev.kind)
            if key in self._events:
                raise ValueError(
                    f"duplicate fault event for step {ev.step} kind "
                    f"{ev.kind!r} (one event per (step, kind))")
            self._events[key] = ev
        self._all: Tuple[TrainFaultEvent, ...] = tuple(
            sorted(self._events.values(),
                   key=lambda e: (e.step, TRAIN_FAULT_KINDS.index(e.kind))))
        self.fired: List[TrainFaultEvent] = []

    @classmethod
    def random(cls, seed: int, *, steps: int = 64,
               p_kill: float = 0.04, p_save_io: float = 0.04,
               p_fetch: float = 0.04,
               p_preempt: float = 0.0) -> "TrainFaultPlan":
        """A seeded random plan over steps ``1..steps-1`` (the JAX plan's
        draws from the same seed): step 0 is never faulted, so a run makes
        progress before its first recovery, and a ``run(steps)`` consults
        its hooks at ``0..steps-1`` only.  ``p_preempt`` is 0 unless
        given: a preempt ends the run."""
        r = np.random.RandomState(int(seed) % (2 ** 32))
        rates = {"kill": p_kill, "save_io": p_save_io, "fetch": p_fetch,
                 "preempt_signal": p_preempt}
        events: List[TrainFaultEvent] = []
        for step in range(1, steps):
            for kind in TRAIN_FAULT_KINDS:   # fixed order: stream stable
                if rates[kind] <= 0.0:
                    continue
                if r.random_sample() < rates[kind]:
                    events.append(TrainFaultEvent(step, kind))
        return cls(events, seed=seed)

    def take(self, kind: str, step: int) -> Optional[TrainFaultEvent]:
        """Consume and return the event scheduled for ``(step, kind)``, or
        None.  A resumed life that replays the step does not fire again a
        fault the previous life took: pass a fresh plan to each life to
        model faults that outlive the process."""
        ev = self._events.pop((int(step), kind), None)
        if ev is not None:
            self.fired.append(ev)
        return ev

    @property
    def pending(self) -> int:
        return len(self._events)

    def events(self) -> List[TrainFaultEvent]:
        return list(self._all)

    def reset(self) -> "TrainFaultPlan":
        """Restore every consumed event (same object, fresh run)."""
        self._events = {(e.step, e.kind): e for e in self._all}
        self.fired = []
        return self

    def fired_log(self) -> List[Tuple[int, str]]:
        """The ``(step, kind)`` sequence that fired, in firing order."""
        return [(int(e.step), e.kind) for e in self.fired]

    def to_dict(self) -> Dict:
        return {
            "train_fault_plan": TRAIN_FAULT_PLAN_SCHEMA,
            "seed": self.seed,
            "events": [e.as_dict() for e in self._all],
            "fired": [e.as_dict() for e in self.fired],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "TrainFaultPlan":
        if d.get("train_fault_plan") != TRAIN_FAULT_PLAN_SCHEMA:
            raise ValueError(
                f"not a TrainFaultPlan dump (schema "
                f"{d.get('train_fault_plan')!r}, want "
                f"{TRAIN_FAULT_PLAN_SCHEMA})")
        events = [TrainFaultEvent(int(e["step"]), str(e["kind"]))
                  for e in d.get("events", [])]
        return cls(events, seed=d.get("seed"))

    def __repr__(self) -> str:
        return (f"TrainFaultPlan(seed={self.seed}, "
                f"scheduled={len(self._all)}, pending={self.pending}, "
                f"fired={len(self.fired)})")


class PreemptSignal:
    """The "this worker is being preempted" flag the loop polls at each
    step boundary.  Set from a ``SIGTERM`` handler (:meth:`install`), a
    cluster manager's callback or a chaos ``preempt_signal`` event, it
    makes the loop save out of interval and return with status
    ``"preempted"``."""

    def __init__(self):
        self._flag = threading.Event()
        self._prev_handler = None

    def set(self) -> None:
        self._flag.set()

    def clear(self) -> None:
        self._flag.clear()

    def is_set(self) -> bool:
        return self._flag.is_set()

    def install(self, signum: int = signal.SIGTERM) -> "PreemptSignal":
        """Install a handler of ``signum`` that sets this flag (a
        scheduler sends SIGTERM a grace window before it takes the
        machine).  Main thread only, as every signal handler."""
        self._prev_handler = signal.signal(
            signum, lambda _s, _f: self.set())
        return self
