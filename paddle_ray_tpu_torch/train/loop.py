"""ResilientTrainLoop: a supervised train loop that survives kills,
save-IO failures, fetch failures and preemption, and resumes bit for bit
(the port of ``paddle_ray_tpu/train/loop.py`` without its telemetry).

It composes :meth:`TrainState.capture <..parallel.api.TrainState.
capture>` (the whole state: parameters, every optimizer slot and master,
the scaler's state, the step counter), the background
:class:`~..checkpoint.CheckpointManager` commit pipeline (write, manifest
checksums, ``COMMITTED``) and :class:`~.chaos.TrainFaultPlan` hooks at
every site that recovery depends on (guarded no-ops when ``chaos=None``).

Determinism shapes the design:

* the step key is ``fold_in(PRNGKey(seed), step)``, with the port's
  JAX-exact threefry (:mod:`..core.prng`), so a resumed life makes the
  same keys without saving key state;
* the data cursor is the step index: ``data_fn(step)`` is a pure function
  of the step (an indexable dataset is wrapped), so a resume at step k
  replays the batches the uninterrupted run saw;
* a checkpoint is tagged with the steps completed, so a restore leaves the
  loop where the save happened;
* the optimizer updates in place, so a save snapshots the tree before the
  next update may write it (:mod:`..checkpoint.sharded`), and the write
  overlaps ``commit_lag`` training steps.

The JAX loop's telemetry (``telemetry``, ``attribution``,
``sanitize_threads``, ``step_budget``, ``goodput``,
``telemetry_snapshot``, ``prometheus_text``, ``dump_flight``,
``last_flight``) is not ported; with it off the JAX loop trains, saves and
restores as this one does.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, List, Optional

from ..checkpoint.manager import CheckpointManager
from ..checkpoint.sharded import restore_train_state
from ..core import prng
from ..serving.chaos import ChaosError
from .chaos import ChaosKill, PreemptSignal

__all__ = ["ResilientTrainLoop", "TrainRunResult"]


@dataclasses.dataclass
class TrainRunResult:
    """What one ``run()`` (one process life) did.  ``losses`` holds only
    this life's losses; the curve across lives is ``loop.step_losses``
    (step -> loss)."""
    status: str                 # "complete" | "preempted"
    start_step: int             # first step this life executed
    next_step: int              # where a resumed life will continue
    losses: List[float]


class ResilientTrainLoop:
    """Checkpoint-supervised training over a
    :class:`~..parallel.api.TrainState`.

    Args:
      ts: the train state (``build_train_step``'s result).
      data_fn: ``data_fn(step) -> batch``, or an indexable sequence
        (wrapped as ``seq[step % len(seq)]``).
      directory / manager: where the checkpoints live; pass one of them.
      seed: the base key's seed; with ``rng=True`` step k's key is
        ``fold_in(PRNGKey(seed), k)``.
      save_interval_steps: save every N completed steps.
      commit_lag: training steps the background write overlaps before the
        loop joins it and commits (0: synchronous saves).
      chaos: a :class:`~.chaos.TrainFaultPlan`, or None.
      preempt: a :class:`~.chaos.PreemptSignal` to poll (one is made
        otherwise; ``loop.preempt.install()`` arms SIGTERM).
      fetch_retries: reads of the loss again after a failed fetch.
    """

    def __init__(self, ts, data_fn, directory: Optional[str] = None, *,
                 manager: Optional[CheckpointManager] = None,
                 seed: int = 0, rng: bool = False,
                 save_interval_steps: Optional[int] = None,
                 max_to_keep: Optional[int] = None,
                 commit_lag: int = 1, use_async: Optional[bool] = None,
                 chaos=None, preempt: Optional[PreemptSignal] = None,
                 fetch_retries: int = 2):
        if (directory is None) == (manager is None):
            raise ValueError("pass exactly one of directory / manager")
        if manager is not None and not (save_interval_steps is None
                                        and max_to_keep is None
                                        and use_async is None):
            # ignoring these would make the caller believe in a cadence
            # the passed manager does not implement
            raise ValueError(
                "save_interval_steps/max_to_keep/use_async configure the "
                "loop-owned manager; a passed-in manager brings its own")
        self.ts = ts
        if not callable(data_fn):
            seq = data_fn
            data_fn = lambda step: seq[step % len(seq)]  # noqa: E731
        self.data_fn = data_fn
        self.manager = manager or CheckpointManager(
            directory,
            max_to_keep=3 if max_to_keep is None else max_to_keep,
            save_interval_steps=(5 if save_interval_steps is None
                                 else save_interval_steps),
            use_async=True if use_async is None else use_async)
        self.seed = int(seed)
        self._use_rng = bool(rng)
        self.commit_lag = max(0, int(commit_lag))
        self.fetch_retries = max(0, int(fetch_retries))
        self.chaos = chaos
        self.preempt = preempt or PreemptSignal()
        self.step_losses: Dict[int, float] = {}
        self.status = "idle"
        self._commit_due: Optional[int] = None
        self._pending_tag: Optional[int] = None
        self._last_committed: Optional[int] = None
        self._base_key = None
        # the loop owns the manager's save-fault hook while it drives it:
        # armed with this loop's plan, or cleared, so that a relaunch
        # without chaos over a reused manager never fires a dead loop's
        # schedule
        self.manager.fault_injector = (
            self._chaos_save_injector if chaos is not None else None)

    # -- chaos helpers (entered only when a plan is armed) ----------------
    def _chaos_take(self, kind: str, step: int):
        return self.chaos.take(kind, step)

    def _chaos_save_injector(self, _kind: str, step: int) -> None:
        if self.chaos.take("save_io", step) is not None:
            raise ChaosError(
                f"injected save-IO failure for checkpoint step_{step}")

    # -- determinism ------------------------------------------------------
    def _derive_rng(self, step: int):
        if not self._use_rng:
            return None
        if self._base_key is None:
            self._base_key = prng.PRNGKey(self.seed)
        # the key of step k depends only on (seed, k)
        return prng.fold_in(self._base_key, step)

    # -- checkpoint plumbing ----------------------------------------------
    def resume(self) -> int:
        """Restore the newest verified committed checkpoint into
        ``self.ts``; returns the step to continue from (0 on a fresh
        directory).  A torn or corrupt step falls back to the previous
        committed one, with a warning."""
        self.manager.wait()
        step = self.manager.latest_step(verified=True)
        if step is None:
            return 0
        restore_train_state(
            os.path.join(self.manager.step_path(step), "state"), self.ts)
        self._last_committed = step
        if self.ts.step_count != step:
            # saves are tagged with the captured counter, so this is a
            # legacy or foreign dump (no step leaf): the directory's tag
            # knows how many steps the parameters trained
            warnings.warn(
                f"checkpoint step tag ({step}) disagrees with the "
                f"captured step counter ({self.ts.step_count}); "
                "trusting the step tag")
            self.ts.step_count = step
        return int(self.ts.step_count)

    def _save(self, tag: int, sync: bool = False) -> bool:
        """Dispatch a background save of the whole state tagged ``tag``
        (= steps completed).  Returns False when the save failed (an
        injected or real IO error): training goes on without that
        checkpoint, and its torn directory is reaped at the next
        commit."""
        # settle the previous save first: manager.save() would commit it
        # inside anyway, and the commit must land in _last_committed
        if self._pending_tag is not None:
            self._finalize_commit()
        tree = self.ts.capture()
        meta = {"schema": "graftsurvive/1", "step": int(tag),
                "fingerprint": int(self.ts.schedule_fingerprint()),
                "seed": self.seed}
        try:
            self.manager.save(tag, tree, meta=meta,
                              fence=self.ts.fence_writes)
        except (ChaosError, OSError) as e:
            warnings.warn(f"checkpoint save for step_{tag} failed "
                          f"({e}); continuing without it")
            return False
        self._pending_tag = tag
        if sync or self.commit_lag == 0:
            self._finalize_commit()
        else:
            # join the write (and commit) only after commit_lag more
            # training steps have overlapped it
            self._commit_due = tag + self.commit_lag
        return True

    def _finalize_commit(self) -> None:
        self.manager.wait()
        self._commit_due = None
        if self._pending_tag is None:
            return                      # nothing was in flight
        self._last_committed = self._pending_tag
        self._pending_tag = None

    # -- loss fetch (the one deliberate host sync a step) -----------------
    def _fetch_loss(self, loss, step: int) -> float:
        fail_first = False
        if self.chaos is not None:
            fail_first = self._chaos_take("fetch", step) is not None
        last: Optional[Exception] = None
        for attempt in range(self.fetch_retries + 1):
            try:
                if fail_first and attempt == 0:
                    raise ChaosError(
                        f"injected loss-fetch failure at step {step}")
                return float(loss)
            except (ChaosError, RuntimeError) as e:
                # the device tensor is still live: a re-read returns the
                # same value, so recovery never perturbs the curve
                last = e
        raise last  # a real, persistent fetch failure: surface it

    # -- the loop ---------------------------------------------------------
    def run(self, num_steps: int, *, resume: bool = True) -> TrainRunResult:
        """Train until ``num_steps`` steps in all have completed (restored
        progress counted), saving on the manager's interval.  Raises
        :class:`~.chaos.ChaosKill` on an injected death (the harness
        relaunches, and the next life resumes)."""
        start = self.resume() if resume else int(self.ts.step_count)
        self.status = "running"
        losses: List[float] = []
        try:
            for step in range(start, num_steps):
                # 1. a preemption wins over everything: commit what there
                # is and leave cleanly
                preempted = self.preempt.is_set()
                if not preempted and self.chaos is not None:
                    preempted = (self._chaos_take("preempt_signal", step)
                                 is not None)
                if preempted:
                    self._preempt_exit(step)
                    return TrainRunResult("preempted", start, step, losses)
                # 2. simulated process death: no cleanup, no save
                if self.chaos is not None:
                    if self._chaos_take("kill", step) is not None:
                        raise ChaosKill(f"injected kill at step {step}")
                # 3. commit the overlapped save once its lag is up
                if self._commit_due is not None and \
                        step >= self._commit_due:
                    self._finalize_commit()
                # 4. one training step
                loss = self.ts.step(self.data_fn(step),
                                    self._derive_rng(step))
                val = self._fetch_loss(loss, step)
                self.step_losses[step] = val
                losses.append(val)
                # 5. save on the interval (tag = steps completed)
                done = step + 1
                if self.manager.should_save(done):
                    self._save(done)
            self._finalize_commit()
            self.status = "complete"
            return TrainRunResult("complete", start, num_steps, losses)
        except ChaosKill:
            # a SIGKILL runs nothing; the one in-process concession is
            # joining the background write uncommitted, so that the next
            # life's orphan reaper does not race the writer thread
            self.status = "killed"
            self.manager.abandon()
            raise

    def _preempt_exit(self, step: int) -> None:
        """Out-of-interval save and a clean exit (the SIGTERM grace
        window): commit the current state synchronously, so that the
        relaunched job resumes from this step, not the last interval."""
        # commit an in-flight boundary save first: it may cover this very
        # step, and the grace window is too short to capture the state
        # again
        self._finalize_commit()
        if self._last_committed != step:
            self._save(step, sync=True)
        self.status = "preempted"
