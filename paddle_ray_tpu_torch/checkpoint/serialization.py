"""Pickle-free object serialization: ``save`` / ``load`` (the port of
``paddle_ray_tpu/checkpoint/serialization.py``, in its on-disk format).

A checkpoint is a directory: ``manifest.json`` (version 2) holds the
structure, with ``{"__array__": key}``, ``{"__tuple__": [...]}`` and
``{"__dict__": [[key, value], ...]}`` nodes, and names the
``arrays-<uuid>.npz`` that holds the array leaves; the manifest's rename
is the commit point, so a crash leaves the previous pair intact.  Files
pass both ways between the packages.

numpy has no bfloat16: ``np.savez`` stores a JAX bfloat16 leaf as raw
two-byte voids (``|V2``) with no dtype.  The port writes a bfloat16 tensor
the same way, with ``"dtype": "bfloat16"`` beside its ``__array__`` key
(the JAX reader ignores the key), and reads a ``|V2`` leaf, tagged or
not, as bfloat16.  :func:`load` returns CPU tensors for the array leaves.
"""
from __future__ import annotations

import json
import os
import uuid
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ["save", "load", "save_state_dict", "load_state_dict"]

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_V2 = np.dtype("V2")


def encode_tree(obj: Any, on_leaf: Callable[[Any], dict],
                path: str = "$") -> Any:
    """A JSON-able skeleton of ``obj``; each array leaf (a tensor or a
    numpy array) becomes the node ``on_leaf(leaf)`` returns."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return on_leaf(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (list, tuple)):
        node = [encode_tree(v, on_leaf, f"{path}[{i}]")
                for i, v in enumerate(obj)]
        return {"__tuple__": node} if isinstance(obj, tuple) else node
    if isinstance(obj, dict):
        # pairs, not a JSON object, so non-string keys round-trip
        items = []
        for k, v in obj.items():
            if not (k is None or isinstance(k, (bool, int, float, str))):
                raise TypeError(
                    f"save(): unsupported dict key type {type(k).__name__} "
                    f"at {path!r}")
            items.append([k, encode_tree(v, on_leaf, f"{path}.{k}")])
        return {"__dict__": items}
    if isinstance(obj, torch.nn.Module):
        return {"__module_state__": encode_tree(
            dict(obj.state_dict()), on_leaf, path)}
    raise TypeError(
        f"save(): unsupported type {type(obj).__name__} at {path!r} "
        "(supported: tensors, arrays, scalars, str, None, dict/list/tuple, "
        "Module)")


def decode_tree(node: Any, on_leaf: Callable[[dict], Any]) -> Any:
    """The inverse of :func:`encode_tree`: ``on_leaf(node)`` gives the
    value of each leaf node (an ``__array__`` or ``__tensor__`` node)."""
    if isinstance(node, dict):
        if "__array__" in node or "__tensor__" in node:
            return on_leaf(node)
        if "__tuple__" in node:
            return tuple(decode_tree(v, on_leaf) for v in node["__tuple__"])
        if "__dict__" in node:
            items = node["__dict__"]
            if isinstance(items, dict):      # v1 checkpoints: str keys only
                return {k: decode_tree(v, on_leaf) for k, v in items.items()}
            return {k: decode_tree(v, on_leaf) for k, v in items}
        if "__module_state__" in node:
            return decode_tree(node["__module_state__"], on_leaf)
    if isinstance(node, list):
        return [decode_tree(v, on_leaf) for v in node]
    return node


def _to_numpy(x) -> np.ndarray:
    """A leaf as the array ``np.savez`` stores: a bfloat16 tensor as
    ``|V2`` voids of its bits."""
    if isinstance(x, np.ndarray):
        return x
    t = x.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_V2)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype) -> torch.Tensor:
    if dtype == "bfloat16" or arr.dtype == _V2:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def save(obj: Any, path: str) -> None:
    """Serialize ``obj`` (nested dict / list / tuple of tensors, arrays
    and scalars, or a module, whose state dict is taken) into the
    directory ``path``."""
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}

    def leaf(x):
        key = f"a{len(arrays)}"
        arrays[key] = _to_numpy(x)
        node = {"__array__": key}
        if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
            node["dtype"] = "bfloat16"
        return node

    skeleton = encode_tree(obj, leaf)
    # crash-safe overwrite: the arrays go to a uniquely named file that
    # the manifest names, and the manifest's rename is the one commit
    # point -- a crash leaves the previous (manifest, arrays) pair intact
    arrays_name = f"arrays-{uuid.uuid4().hex[:12]}.npz"
    tmp_npz = os.path.join(path, arrays_name + ".tmp.npz")
    np.savez(tmp_npz, **arrays)
    os.replace(tmp_npz, os.path.join(path, arrays_name))
    tmp = os.path.join(path, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"version": 2, "tree": skeleton, "arrays": arrays_name}, f)
    os.replace(tmp, os.path.join(path, _MANIFEST))
    # the superseded arrays files go once the new manifest is committed
    for name in os.listdir(path):
        if name.startswith("arrays") and name != arrays_name:
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass


def load(path: str) -> Any:
    """The inverse of :func:`save`: array leaves as CPU tensors."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    arrays_name = manifest.get("arrays", _ARRAYS)
    with np.load(os.path.join(path, arrays_name)) as npz:
        arrays = {k: npz[k] for k in npz.files}
    return decode_tree(manifest["tree"], lambda node: _from_numpy(
        arrays[node["__array__"]], node.get("dtype")))


def save_state_dict(module: torch.nn.Module, path: str) -> None:
    """``save(module.state_dict(), path)``."""
    save(dict(module.state_dict()), path)


def load_state_dict(module: torch.nn.Module, path: str, strict: bool = True):
    """``module.load_state_dict(load(path))``."""
    return module.load_state_dict(load(path), strict=strict)
