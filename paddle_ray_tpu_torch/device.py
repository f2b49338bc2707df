"""Device selection: the port runs on CUDA unless the caller asks for the
CPU by name (the idea of ``paddle_ray_tpu/device.py``, without its JAX
platform registry)."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """``cuda``; raises when no CUDA device is available (only an explicit
    ``device="cpu"`` selects the host)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_ray_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch paths")
    return torch.device("cuda")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`, or :func:`default_device`
    when it is None."""
    return default_device() if device is None else torch.device(device)
