"""Per-device state of the split-K kernels (paged attention, fused decode
attention and the weight-streaming int8 matmul): the card's SM count,
which their split plans read, the int32 counters by which the last block
of a split finds that it merges the splits, and a float32 workspace for
the splits' partial sums."""
from __future__ import annotations

import torch

__all__ = ["sm_count", "split_counters", "split_workspace"]

_SM_COUNT = {}
_COUNTERS = {}
_WORKSPACE = {}


def sm_count(dev: torch.device) -> int:
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNT[dev]


def split_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The split counters for launches on ``stream`` of ``dev``: zero, and
    left zero by every launch that runs to its end, so one buffer serves
    every call on that stream, whichever split-K kernel it launches;
    another stream gets its own, as launches that share counters must not
    overlap."""
    buf = _COUNTERS.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _COUNTERS[(dev, stream)] = buf
    return buf


def split_workspace(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` float32 values of scratch for the partial sums of a
    launch on ``stream`` of ``dev``, kept across calls (a launch writes
    every value it reads, so one buffer serves every call on that stream;
    another stream gets its own)."""
    buf = _WORKSPACE.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1 << 20), dtype=torch.float32, device=dev)
        _WORKSPACE[(dev, stream)] = buf
    return buf
