"""Checkpoint lifecycle: step-numbered saves, retention, resume and crash
consistency (the port of ``paddle_ray_tpu/checkpoint/manager.py``, pure
Python over :class:`.sharded.ShardedCheckpointer`).

A ``step_N/`` directory becomes restorable only at the end of the commit
pipeline:

1. the background write finishes (:meth:`CheckpointManager.wait` joins
   it);
2. ``MANIFEST.json`` is written: the byte size and CRC32 of every file
   the write produced, and the saver's ``meta`` dict (the train loop
   records its schema, step and fingerprint there);
3. the ``COMMITTED`` marker lands.

The write goes to a hidden ``.step_N.pending-*`` scratch directory that
is renamed to ``step_N/`` only after step 3, so re-saving a committed
step (a preempt's re-save, a resumed run's boundary) never destroys the
old checkpoint before the new one is durable.  A kill before the rename
leaves scratch debris that ``latest_step`` and ``restore`` never see and
the reaper removes; a torn or corrupt committed directory (a truncated
file, flipped bits) fails manifest verification, and ``restore(step=
None)`` falls back to the previous committed step with a warning.
``fault_injector`` is the chaos hook: the train loop arms it to fail a
save where a real filesystem would (after the scratch directory exists,
before the write), leaving the orphan the reaper must handle.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import warnings
import zlib
from typing import Any, Callable, List, Optional, Tuple

from .sharded import ShardedCheckpointer

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_PENDING_RE = re.compile(r"^\.step_(\d+)\.pending-")
_COMMIT = "COMMITTED"
_MANIFEST = "MANIFEST.json"
MANIFEST_SCHEMA = 1


def _crc32_file(path: str) -> Tuple[int, int]:
    """(bytes, crc32) of one file, read in bounded chunks."""
    crc = 0
    n = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)
    return n, crc & 0xFFFFFFFF


class CheckpointManager:
    """Directory of ``step_N/`` checkpoints with retention + resume.

    Usage::

        mgr = CheckpointManager(dir, max_to_keep=3, save_interval_steps=100)
        for step in range(start, n):
            ...
            if mgr.should_save(step):
                mgr.save(step, ts.capture())
        latest = mgr.latest_step()          # None if fresh run
        tree = mgr.restore(latest, target=...)
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, use_async: bool = True,
                 fault_injector: Optional[Callable[[str, int], None]] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)
        self._ckptr = ShardedCheckpointer(use_async)
        self._pending_commit: Optional[str] = None
        self._pending_final: Optional[str] = None
        self._pending_meta: Optional[dict] = None
        # the chaos hook: called as fault_injector("save", step) after
        # the step dir exists but before any state is written; a raise
        # leaves exactly the orphan a crashed save leaves
        self.fault_injector = fault_injector
        # a previous process may have died mid-save: its torn dirs are
        # unrestorable by construction (no COMMITTED), reap them now
        self._reap_orphans()

    # -- introspection ---------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.directory, name, _COMMIT)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self, verified: bool = False) -> Optional[int]:
        """Newest COMMITTED step; with ``verified=True`` the newest
        committed step whose manifest checksums still hold (torn or
        bit-rotted steps are skipped with a warning)."""
        steps = self.all_steps()
        if not verified:
            return steps[-1] if steps else None
        for step in reversed(steps):
            ok, why = self.verify_step(step)
            if ok:
                return step
            warnings.warn(f"checkpoint step_{step} failed verification "
                          f"({why}); falling back to an older step")
        return None

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def should_save(self, step: int) -> bool:
        return step % self.save_interval_steps == 0

    # -- crash consistency ----------------------------------------------
    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.step_path(step), _MANIFEST)

    def load_manifest(self, step: int) -> Optional[dict]:
        """The committed step's manifest dict (schema, files, saver
        ``meta``), or None when absent/unreadable."""
        try:
            with open(self._manifest_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_manifest(self, path: str, meta: Optional[dict]) -> None:
        files = {}
        for dirpath, _, names in os.walk(path):
            for name in names:
                if name in (_MANIFEST, _COMMIT):
                    continue
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, path)
                size, crc = _crc32_file(full)
                files[rel] = {"bytes": size, "crc32": crc}
        doc = {"manifest": MANIFEST_SCHEMA, "files": files,
               "meta": meta or {}}
        tmp = os.path.join(path, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, _MANIFEST))

    def verify_step(self, step: int) -> Tuple[bool, str]:
        """Is ``step_N/`` restorable?  Committed, manifest checksums
        hold: every manifest-listed file still exists with its recorded
        size and CRC32 (a torn write, truncation, or bit flip fails
        here BEFORE the restore path touches the data).  A committed
        step with NO manifest at all is a pre-manifest legacy
        checkpoint and stays restorable (the new commit pipeline always
        writes the manifest before the marker, so new steps can never
        legitimately lack one — only an unreadable/truncated manifest
        is treated as corruption)."""
        path = self.step_path(step)
        if not os.path.exists(os.path.join(path, _COMMIT)):
            return False, "no COMMITTED marker"
        if not os.path.exists(os.path.join(path, _MANIFEST)):
            return True, "legacy checkpoint (no manifest)"
        doc = self.load_manifest(step)
        if doc is None or doc.get("manifest") != MANIFEST_SCHEMA:
            return False, "unreadable manifest"
        for rel, want in doc.get("files", {}).items():
            full = os.path.join(path, rel)
            if not os.path.exists(full):
                return False, f"missing file {rel}"
            size, crc = _crc32_file(full)
            if size != want.get("bytes") or crc != want.get("crc32"):
                return False, f"checksum mismatch in {rel}"
        return True, ""

    # -- save / restore --------------------------------------------------
    def save(self, step: int, tree: Any, meta: Optional[dict] = None,
             fence: Optional[Callable] = None) -> None:
        """Background save of ``tree`` destined for ``step_N/``
        (joins any previous in-flight save first, then commits it).
        The write goes into a hidden scratch dir and is renamed into
        place only at commit — a failed or abandoned save (injected
        fault, ENOSPC, kill) can never destroy an existing committed
        ``step_N/``.  ``meta`` is a JSON-clean dict recorded in the
        step's manifest (the train loop stores its capture
        schema/step/fingerprint there).  ``fence`` goes to
        :meth:`.sharded.ShardedCheckpointer.save`."""
        import tempfile
        self._finalize_pending()
        tmp = tempfile.mkdtemp(prefix=f".step_{step}.pending-",
                               dir=self.directory)
        if self.fault_injector is not None:
            # may raise: the torn scratch dir it leaves behind is
            # exactly what a crashed save leaves (reaped as an orphan)
            self.fault_injector("save", step)
        self._ckptr.save(os.path.join(tmp, "state"), tree, fence=fence)
        self._pending_commit = tmp
        self._pending_final = self.step_path(step)
        self._pending_meta = meta

    @staticmethod
    def _fsync_dir(path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _finalize_pending(self) -> None:
        if self._pending_commit is None:
            return
        self._ckptr.wait()
        self._write_manifest(self._pending_commit, self._pending_meta)
        with open(os.path.join(self._pending_commit, _COMMIT), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        # marker + dir entries reach stable storage before the old copy
        # goes away (a machine crash, not just a SIGKILL, must not
        # leave a committed-looking step with lost pages): the
        # non-restorable window is this rmtree+rename pair, not the
        # whole write
        self._fsync_dir(self._pending_commit)
        if os.path.exists(self._pending_final):
            shutil.rmtree(self._pending_final)
        os.rename(self._pending_commit, self._pending_final)
        self._fsync_dir(self.directory)
        self._pending_commit = None
        self._pending_final = None
        self._pending_meta = None
        # GC only after the new step is committed — never drop the last
        # restorable checkpoint while a save is still in flight
        self._gc()

    def wait(self) -> None:
        self._finalize_pending()

    def abandon(self) -> None:
        """Join any in-flight async write WITHOUT committing it: the
        scratch dir is left torn (no manifest, no COMMITTED, never
        renamed into place) — exactly what a process kill mid-save
        leaves on disk.  Test harness for simulated death in-process,
        where the background write thread would otherwise race a
        successor manager's orphan reaper."""
        self._ckptr.wait()
        self._pending_commit = None
        self._pending_final = None
        self._pending_meta = None

    def restore(self, step: Optional[int] = None, target: Any = None,
                shardings: Any = None) -> Any:
        """Restore ``step`` (explicit steps must verify — a corrupt
        explicit step raises) or, with ``step=None``, the newest
        committed step that PASSES manifest verification — torn/corrupt
        steps are skipped with a warning (fall back rather than resume
        from poisoned state)."""
        self.wait()
        if step is None:
            step = self.latest_step(verified=True)
            if step is None:
                raise FileNotFoundError(
                    f"no restorable checkpoints in {self.directory}")
        else:
            ok, why = self.verify_step(step)
            if not ok:
                raise ValueError(
                    f"checkpoint step_{step} is not restorable: {why}")
        return self._ckptr.restore(
            os.path.join(self.step_path(step), "state"), target, shardings)

    # -- retention -------------------------------------------------------
    def _orphans(self) -> List[str]:
        """Crash/fault debris that is NOT the in-flight save: torn
        ``.step_N.pending-*`` scratch dirs, plus any uncommitted
        ``step_N/`` (external tampering, or dirs from before the
        scratch-rename pipeline)."""
        out = []
        for name in os.listdir(self.directory):
            p = os.path.join(self.directory, name)
            if p == self._pending_commit:
                continue
            if _PENDING_RE.match(name):
                out.append(p)
            elif _STEP_RE.match(name) and \
                    not os.path.exists(os.path.join(p, _COMMIT)):
                out.append(p)
        return out

    def _reap_orphans(self) -> None:
        for p in self._orphans():
            m = _PENDING_RE.match(os.path.basename(p))
            if m and os.path.exists(os.path.join(p, _COMMIT)):
                # a FULLY durable commit (data + manifest + marker) that
                # died between _finalize_pending's rmtree and rename:
                # promote it into place instead of deleting the only
                # surviving copy of that step
                final = self.step_path(int(m.group(1)))
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(p, final)
                continue
            shutil.rmtree(p, ignore_errors=True)

    def _gc(self) -> None:
        # retention counts COMMITTED steps only — an uncommitted dir is
        # never a retention victim (it is not a checkpoint) and never
        # inflates the count; it is reaped as an orphan instead
        steps = self.all_steps()
        while len(steps) > max(self.max_to_keep, 1):
            victim = steps.pop(0)
            shutil.rmtree(self.step_path(victim), ignore_errors=True)
        self._reap_orphans()

    def close(self) -> None:
        self.wait()
        self._ckptr.close()
