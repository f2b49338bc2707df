"""Whole-state checkpoints of tensor trees, written in the background
(the port of ``paddle_ray_tpu/checkpoint/sharded.py`` on one device).

The JAX package writes an orbax checkpoint, each device its own shards.
The port writes a format of its own, which loads with no process group:
a directory with ``data.bin``, every tensor's bytes back to back (each at
a 64-byte-aligned offset), and ``tree.json``, the tree's structure in the
encoding of :mod:`.serialization` with a ``{"__tensor__": i, "dtype",
"shape", "offset", "nbytes"}`` node for each tensor.  Every leaf comes
back bit for bit (bfloat16, int8 and uint8 codes included).

The port's train step updates the parameters and the optimizer's state in
place, so a write that lags behind training must not read the live
tensors: :meth:`ShardedCheckpointer.save` first snapshots the tree.  A
CUDA tensor is copied into pinned host memory on a side stream that waits
for the current stream; an event recorded after the copies is what every
later in-place write must wait for -- by default the current stream waits
for it at once, and a caller that holds its own writes (``fence=``, as
``TrainState.fence_writes`` does) lets the next forward and backward
overlap the copies.  A CPU tensor is cloned before ``save`` returns.  The
writer thread waits for the event, writes the file and frees the
snapshot.
"""
from __future__ import annotations

import collections
import json
import os
import shutil
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .serialization import decode_tree, encode_tree

__all__ = ["ShardedCheckpointer", "save_sharded", "load_sharded",
           "restore_train_state", "LeafMeta"]

_TREE = "tree.json"
_DATA = "data.bin"
_FORMAT = "paddle_ray_tpu_torch/tree"
_VERSION = 1
_ALIGN = 64
_DTYPES = {str(dt).replace("torch.", ""): dt for dt in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}

# a saved tensor's description, read from tree.json without its bytes
LeafMeta = collections.namedtuple("LeafMeta", "dtype shape")


def _dtype_name(dt: torch.dtype) -> str:
    name = str(dt).replace("torch.", "")
    if name not in _DTYPES:
        raise TypeError(f"checkpoint: unsupported tensor dtype {dt}")
    return name


def _as_tensor(x) -> torch.Tensor:
    return (torch.from_numpy(np.ascontiguousarray(x))
            if isinstance(x, np.ndarray) else x.detach())


def _flat(tree, prefix: Tuple[str, ...] = ()):
    """``(path, value)`` of every leaf of a dict / list / tuple tree, the
    path a tuple of key strings (the JAX ``_path_names``)."""
    if isinstance(tree, (LeafMeta, _Saved)):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _leaf_map(tree) -> dict:
    """``{path: leaf}`` of the tensor (or :class:`LeafMeta`) leaves."""
    return {p: x for p, x in _flat(tree)
            if isinstance(x, (torch.Tensor, np.ndarray, LeafMeta))}


class _Saved:
    """A saved tensor's node in ``tree.json`` (dtype, shape, offset)."""
    __slots__ = ("node",)

    def __init__(self, node: dict):
        self.node = node


class _Snapshot:
    """A tree's structure and a private copy of its tensors, with the
    events recorded after the copies of CUDA tensors (one a device)."""

    def __init__(self, tree, streams: dict):
        self.nodes: List[dict] = []
        leaves: List[torch.Tensor] = []

        def leaf(x):
            t = _as_tensor(x)
            node = {"__tensor__": len(leaves), "dtype": _dtype_name(t.dtype),
                    "shape": list(t.shape)}
            leaves.append(t)
            self.nodes.append(node)
            return node

        self.skeleton = encode_tree(tree, leaf)
        offset = 0
        for node, t in zip(self.nodes, leaves):
            offset = -(-offset // _ALIGN) * _ALIGN
            node.update(offset=offset, nbytes=t.numel() * t.element_size())
            offset += node["nbytes"]
        self.nbytes = offset
        self.host: List[Optional[torch.Tensor]] = [None] * len(leaves)
        self.events: Dict[torch.device, torch.cuda.Event] = {}
        by_device: Dict[torch.device, List[int]] = {}
        for i, t in enumerate(leaves):
            if t.is_cuda:
                by_device.setdefault(t.device, []).append(i)
            else:
                self.host[i] = t.clone(memory_format=torch.contiguous_format)
        for dev, idx in by_device.items():
            side = streams.get(dev)
            if side is None:
                side = streams[dev] = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for i in idx:
                    t = leaves[i]
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    self.host[i] = h
            ev = torch.cuda.Event()
            ev.record(side)
            self.events[dev] = ev

    def write(self, path: str, force: bool) -> None:
        """Wait for the copies, write ``path`` and free the snapshot."""
        for ev in self.events.values():
            ev.synchronize()
        if os.path.exists(path):
            if not force:
                raise FileExistsError(f"checkpoint {path} exists")
            shutil.rmtree(path)
        os.makedirs(path)
        data = os.path.join(path, _DATA)
        with open(data + ".tmp", "wb") as f:
            for node, h in zip(self.nodes, self.host):
                pad = node["offset"] - f.tell()
                if pad:
                    f.write(b"\0" * pad)
                if node["nbytes"]:
                    f.write(memoryview(h.reshape(-1).view(torch.uint8)
                                       .numpy()))
            f.flush()
            os.fsync(f.fileno())
        os.replace(data + ".tmp", data)
        doc = {"format": _FORMAT, "version": _VERSION, "data": _DATA,
               "nbytes": self.nbytes, "tree": self.skeleton}
        with open(os.path.join(path, _TREE + ".tmp"), "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(os.path.join(path, _TREE + ".tmp"),
                   os.path.join(path, _TREE))
        self.host = []


def _read_doc(path: str) -> dict:
    with open(os.path.join(path, _TREE)) as f:
        doc = json.load(f)
    if doc.get("format") != _FORMAT or doc.get("version", 0) > _VERSION:
        raise ValueError(f"{path} is not a checkpoint of this format "
                         f"(format {doc.get('format')!r}, version "
                         f"{doc.get('version')!r})")
    return doc


def _read_leaf(f, node: dict, pinned: bool = False) -> torch.Tensor:
    """One saved tensor from the open data file, into a new CPU tensor
    (pinned memory for a copy to the device)."""
    n = node["nbytes"]
    buf = torch.empty(n, dtype=torch.uint8, pin_memory=pinned)
    if n:
        f.seek(node["offset"])
        got = f.readinto(memoryview(buf.numpy()))
        if got != n:
            raise ValueError(f"checkpoint data truncated: read {got} of "
                             f"{n} bytes at offset {node['offset']}")
    return buf.view(_DTYPES[node["dtype"]]).reshape(node["shape"])


class ShardedCheckpointer:
    """Save and restore tensor trees.  ``save`` is asynchronous by default:
    it snapshots the tree and returns while a thread writes it; call
    :meth:`wait` (or save again) to join the write, which re-raises its
    error."""

    def __init__(self, use_async: bool = True):
        self.use_async = use_async
        self._streams: dict = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, path: str, tree: Any, force: bool = True,
             fence: Optional[Callable] = None) -> None:
        """Snapshot ``tree`` and write it to ``path`` (in the background
        when asynchronous).  ``fence(event)`` takes each CUDA snapshot's
        event: the caller holds its next in-place write to those tensors
        behind it.  Without ``fence`` the current stream waits for it."""
        self.wait()
        path = os.path.abspath(path)
        snap = _Snapshot(tree, self._streams)
        for dev, ev in snap.events.items():
            if fence is not None:
                fence(ev)
            else:
                torch.cuda.current_stream(dev).wait_event(ev)
        if not self.use_async:
            snap.write(path, force)
            return

        def run():
            try:
                snap.write(path, force)
            except Exception as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e
        self._thread = threading.Thread(target=run, name="checkpoint-write")
        self._thread.start()

    def metadata(self, path: str) -> Any:
        """The saved tree with a :class:`LeafMeta` for each tensor, read
        without its bytes."""
        doc = _read_doc(os.path.abspath(path))
        return decode_tree(doc["tree"], lambda node: LeafMeta(
            _DTYPES[node["dtype"]], tuple(node["shape"])))

    def restore(self, path: str, target: Any = None,
                shardings: Any = None) -> Any:
        """The saved tree, its tensors on the CPU; with ``target`` (a
        matching tree), each tensor of ``target`` replaced by the saved
        one on the target's device and in its dtype (a shape that
        differs raises).  ``shardings`` (multi-device placement) is not
        ported."""
        if shardings is not None:
            raise NotImplementedError("restore: shardings (multi-device "
                                      "placement) are not ported yet")
        path = os.path.abspath(path)
        doc = _read_doc(path)
        with open(os.path.join(path, doc["data"]), "rb") as f:
            saved = decode_tree(doc["tree"], lambda node: _read_leaf(f, node))
        if target is None:
            return saved
        got = _leaf_map(saved)

        def place(tree, prefix):
            if isinstance(tree, dict):
                return {k: place(v, prefix + (str(k),))
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(place(v, prefix + (str(i),))
                                  for i, v in enumerate(tree))
            if not isinstance(tree, (torch.Tensor, np.ndarray)):
                return tree
            tgt = _as_tensor(tree)
            if prefix not in got:
                raise ValueError(f"checkpoint at {path} has no leaf "
                                 f"{'.'.join(prefix)}")
            src = got[prefix]
            if tuple(src.shape) != tuple(tgt.shape):
                raise ValueError(f"shape of {'.'.join(prefix)}: saved "
                                 f"{tuple(src.shape)}, target "
                                 f"{tuple(tgt.shape)}")
            return src.to(device=tgt.device, dtype=tgt.dtype)
        return place(target, ())

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def save_sharded(tree: Any, path: str, *,
                 use_async: bool = False) -> Optional[ShardedCheckpointer]:
    """One-shot save.  With ``use_async=True`` returns the checkpointer
    (the caller must :meth:`~ShardedCheckpointer.wait`)."""
    ck = ShardedCheckpointer(use_async)
    ck.save(path, tree)
    if use_async:
        return ck
    ck.close()
    return None


def load_sharded(path: str, target: Any = None, shardings: Any = None) -> Any:
    return ShardedCheckpointer(use_async=False).restore(path, target,
                                                        shardings)


def restore_train_state(path: str, ts):
    """Restore the port's :class:`~..parallel.api.TrainState` from
    ``path`` in place.

    Takes both schemas: a full :meth:`TrainState.capture` dump (the
    parameters and buffers, every optimizer slot, master and step count,
    the live learning rate and a bound schedule's state, the scaler's
    state and the step counter), or a legacy ``{"model": ..., "opt":
    ...}`` dump (no step counter).  Each saved tensor is copied into the
    live one, so the optimizer's state keeps its identity and, when
    offloaded, its pinned host memory.  A live leaf the checkpoint lacks
    raises; a leaf whose saved shape differs keeps its fresh value, with
    one warning."""
    from ..parallel.api import TRAIN_STATE_SCHEMA

    path = os.path.abspath(path)
    try:
        doc = _read_doc(path)
    except (OSError, ValueError) as e:
        raise FileNotFoundError(
            f"no readable checkpoint metadata at {path}: {e}") from e
    md = decode_tree(doc["tree"], _Saved)
    md_map = {p: s.node for p, s in _flat(md) if isinstance(s, _Saved)}
    full = ("step",) in md_map
    cap = ts.capture()
    # a snapshot still copying the live tensors reads them first
    ts._wait_fences()
    target = cap if full else {"model": cap["model"], "opt": cap["opt"]}
    live = _leaf_map(target)
    missing = [k for k in live if k not in md_map]
    if missing:
        raise ValueError(
            f"checkpoint at {path} does not match the live train state: "
            f"{len(missing)} leaf/leaves absent (first: "
            f"{'.'.join(missing[0])}).  Rebuild the TrainState with the "
            "same scaler/comm_dtype options the checkpoint was saved with.")
    with open(os.path.join(path, doc["data"]), "rb") as f:
        if full:
            saved_schema = int(_read_leaf(f, md_map[("schema",)]))
            if saved_schema > TRAIN_STATE_SCHEMA:
                raise ValueError(
                    f"checkpoint at {path} uses capture schema "
                    f"{saved_schema}, newer than this build's "
                    f"{TRAIN_STATE_SCHEMA}: leaves may have changed meaning "
                    "-- upgrade before restoring")
        skipped, staged = [], []
        for key, t in live.items():
            node = md_map[key]
            if tuple(node["shape"]) != tuple(t.shape):
                skipped.append(key)
                continue
            src = _read_leaf(f, node, pinned=t.is_cuda)
            t.copy_(src, non_blocking=t.is_cuda)
            if t.is_cuda:
                staged.append(src)
    if staged:
        # the pinned buffers stay alive until their copies are done
        torch.cuda.synchronize()
    if skipped:
        warnings.warn(
            f"{len(skipped)} checkpoint leaf/leaves have a different shape "
            "from the live train state and keep their fresh values: "
            + ", ".join(".".join(k) for k in skipped[:4])
            + ("..." if len(skipped) > 4 else ""))
    opt_md = dict(md["opt"]) if isinstance(md.get("opt"), dict) else {}
    ts._restore_host_state(cap, lr_value=opt_md.get("lr_value"),
                           lr_sched=opt_md.get("lr_sched"))
    if full:
        ts.step_count = int(cap["step"])
        saved_fp = int(cap["fingerprint"])
        if saved_fp != ts.schedule_fingerprint():
            warnings.warn(
                "checkpoint comm/gather schedule fingerprint mismatch "
                f"(saved {saved_fp}, live {ts.schedule_fingerprint()}): "
                "the checkpoint was taken under another communication "
                "schedule")
    return ts
