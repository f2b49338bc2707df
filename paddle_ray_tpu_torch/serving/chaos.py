"""Deterministic fault injection for the serving engine (the port of
``paddle_ray_tpu/serving/chaos.py``, host-only numpy code).

A :class:`FaultPlan` is a seeded, step-indexed schedule of faults that the
engine consults at a few hook sites.  The plan is built from a seed
(:meth:`FaultPlan.random`), so a failing chaos run is reproduced by its
seed; every fired event is journaled (:attr:`FaultPlan.fired`); and
:meth:`FaultPlan.to_dict` / :meth:`FaultPlan.from_dict` round-trip the
plan, so a dumped plan replays the same events.

Engine fault kinds (the recovery obligations live in ``engine.py``):

* ``pool_alloc`` -- the next :meth:`PagePool.alloc` of the step raises
  through the pool's ``fault_injector`` hook, before the free list moves;
* ``dispatch`` -- the mixed-step launch raises after the scheduler moved
  its predicted state;
* ``fetch`` -- the step's token fetch raises: the step ran on the device
  but its result is lost;
* ``fetch_delay`` -- the fetch takes ``delay_s`` longer (never an error);
* ``pool_spike`` -- ``pages`` free pages vanish for ``hold_steps``
  iterations, then return.

The fleet kinds (``replica_kill``, ``replica_hang``) and the events'
``replica`` tag stay in the schema, so a plan of either package
round-trips and one seed draws one schedule in both; no engine of the
port consumes them (the cluster that would is not ported).

With ``chaos=None`` every hook site in the engine and the pool is a
guarded no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ChaosError", "EngineStallError", "FaultEvent", "FaultPlan",
           "FAULT_KINDS", "ENGINE_FAULT_KINDS", "CLUSTER_FAULT_KINDS"]

ENGINE_FAULT_KINDS = ("pool_alloc", "dispatch", "fetch", "fetch_delay",
                      "pool_spike")
CLUSTER_FAULT_KINDS = ("replica_kill", "replica_hang")
FAULT_KINDS = ENGINE_FAULT_KINDS + CLUSTER_FAULT_KINDS

# plan dict schema version (dumps embed it; from_dict validates)
FAULT_PLAN_SCHEMA = 1


class ChaosError(RuntimeError):
    """An injected fault.  The engine's recovery treats it as the failure
    it stands in for; nothing special-cases it."""


class EngineStallError(RuntimeError):
    """The stuck-step watchdog tripped: the engine made no progress for
    longer than ``max_stall_s``.  Raised by ``ServingEngine.run`` after
    every live request was failed."""


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault: fires when the engine's iteration counter
    reaches ``step`` and the matching hook site is consulted."""
    step: int
    kind: str
    pages: int = 0                     # pool_spike: free pages to hide
    hold_steps: int = 0                # pool_spike: iterations held
    delay_s: float = 0.0               # fetch_delay: extra blocking time
    replica: int = 0                   # fleet scope (0 = first/only)

    def as_dict(self) -> Dict:
        return {"step": int(self.step), "kind": self.kind,
                "pages": int(self.pages),
                "hold_steps": int(self.hold_steps),
                "delay_s": float(self.delay_s),
                "replica": int(self.replica)}


class FaultPlan:
    """A deterministic, step-indexed fault schedule: at most one event per
    ``(step, kind, replica)``.  :meth:`take` consumes (and journals) an
    event, so a site re-reached while recovering does not fire it twice."""

    def __init__(self, events: Optional[List[FaultEvent]] = None, *,
                 seed: Optional[int] = None):
        self.seed = seed
        self._events: Dict[Tuple[int, str, int], FaultEvent] = {}
        for ev in (events or []):
            if ev.kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {ev.kind!r}; have {FAULT_KINDS}")
            key = (int(ev.step), ev.kind, int(ev.replica))
            if key in self._events:
                raise ValueError(
                    f"duplicate fault event for step {ev.step} kind "
                    f"{ev.kind!r} replica {ev.replica} (one event per "
                    "(step, kind, replica))")
            self._events[key] = ev
        # everything ever scheduled: reset()/to_dict() work after a run
        self._all: Tuple[FaultEvent, ...] = tuple(
            sorted(self._events.values(),
                   key=lambda e: (e.step, FAULT_KINDS.index(e.kind),
                                  e.replica)))
        self.fired: List[FaultEvent] = []

    # -- construction -----------------------------------------------------
    @classmethod
    def random(cls, seed: int, *, steps: int = 64,
               p_pool_alloc: float = 0.03, p_dispatch: float = 0.03,
               p_fetch: float = 0.03, p_fetch_delay: float = 0.02,
               p_pool_spike: float = 0.03, max_spike_pages: int = 3,
               max_spike_hold: int = 3,
               delay_s: float = 0.002) -> "FaultPlan":
        """A seeded plan of engine faults over iterations ``1..steps``:
        each (step, kind) fires independently at its kind's rate; the same
        seed builds the same plan (the JAX package's draw order, so both
        build one schedule from one seed)."""
        r = np.random.RandomState(int(seed) % (2 ** 32))
        rates = {"pool_alloc": p_pool_alloc, "dispatch": p_dispatch,
                 "fetch": p_fetch, "fetch_delay": p_fetch_delay,
                 "pool_spike": p_pool_spike}
        events: List[FaultEvent] = []
        for step in range(1, steps + 1):
            for kind in ENGINE_FAULT_KINDS:  # fixed order: stable draws
                if r.random_sample() >= rates[kind]:
                    continue
                if kind == "pool_spike":
                    events.append(FaultEvent(
                        step, kind,
                        pages=int(r.randint(1, max_spike_pages + 1)),
                        hold_steps=int(r.randint(1, max_spike_hold + 1))))
                elif kind == "fetch_delay":
                    events.append(FaultEvent(step, kind, delay_s=delay_s))
                else:
                    events.append(FaultEvent(step, kind))
        return cls(events, seed=seed)

    @classmethod
    def merge(cls, *plans: "FaultPlan") -> "FaultPlan":
        """Combine schedules into one plan (duplicate ``(step, kind,
        replica)`` keys raise)."""
        events = [e for p in plans for e in p.events()]
        seeds = {p.seed for p in plans}
        return cls(events,
                   seed=seeds.pop() if len(seeds) == 1 else None)

    # -- the engine-facing surface ----------------------------------------
    def take(self, kind: str, step: int) -> Optional[FaultEvent]:
        """Consume and return the event scheduled for ``(step, kind)`` (of
        replica 0, the single engine), or None."""
        ev = self._events.pop((int(step), kind, 0), None)
        if ev is not None:
            self.fired.append(ev)
        return ev

    @property
    def pending(self) -> int:
        """Events scheduled but not yet fired."""
        return len(self._events)

    def events(self) -> List[FaultEvent]:
        """Every event of the plan (fired or not), in (step, kind,
        replica) order."""
        return list(self._all)

    def reset(self) -> "FaultPlan":
        """Restore every consumed event (same object, fresh run)."""
        self._events = {(e.step, e.kind, e.replica): e for e in self._all}
        self.fired = []
        return self

    def fired_log(self) -> List[Tuple[int, str]]:
        """The (step, kind) sequence that fired, in firing order."""
        return [(int(e.step), e.kind) for e in self.fired]

    # -- replay round-trip -------------------------------------------------
    def to_dict(self) -> Dict:
        """JSON-clean dump: seed, the whole schedule, what fired."""
        return {
            "fault_plan": FAULT_PLAN_SCHEMA,
            "seed": self.seed,
            "events": [e.as_dict() for e in self._all],
            "fired": [e.as_dict() for e in self.fired],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultPlan":
        """Rebuild a plan from :meth:`to_dict` (the fired state is not
        restored: a replay starts from the whole schedule)."""
        if d.get("fault_plan") != FAULT_PLAN_SCHEMA:
            raise ValueError(
                f"not a FaultPlan dump (schema {d.get('fault_plan')!r}, "
                f"want {FAULT_PLAN_SCHEMA})")
        events = [FaultEvent(int(e["step"]), str(e["kind"]),
                             pages=int(e.get("pages", 0)),
                             hold_steps=int(e.get("hold_steps", 0)),
                             delay_s=float(e.get("delay_s", 0.0)),
                             replica=int(e.get("replica", 0)))
                  for e in d.get("events", [])]
        return cls(events, seed=d.get("seed"))

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, scheduled={len(self._all)}, "
                f"pending={self.pending}, fired={len(self.fired)})")
