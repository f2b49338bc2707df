"""The AMP policy and the ``auto_cast`` context (the port's counterpart of
``paddle_ray_tpu/amp/auto_cast.py``)."""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from ..core import dtypes as _dt

__all__ = ["AmpPolicy", "auto_cast", "amp_guard", "current_policy",
           "policy_scope", "cast_if_enabled", "decorate"]


@dataclasses.dataclass(frozen=True)
class AmpPolicy:
    enabled: bool = False
    compute_dtype: torch.dtype = torch.bfloat16
    # O1: cast at compute boundaries only; O2: the parameters are cast too
    level: str = "O1"

    def cast(self, x):
        """``x`` in the compute dtype if the policy is on and ``x`` is a
        floating tensor; anything else as it is."""
        if (self.enabled and isinstance(x, torch.Tensor)
                and x.is_floating_point()):
            return x.to(self.compute_dtype)
        return x


_STATE = threading.local()


def current_policy() -> AmpPolicy:
    """The policy of the calling thread (off outside ``auto_cast``)."""
    return getattr(_STATE, "policy", AmpPolicy())


@contextlib.contextmanager
def policy_scope(policy: AmpPolicy):
    """Run under ``policy`` on the calling thread, then restore the one
    found.  A checkpointed block's recompute (which autograd may run on
    another thread, after ``auto_cast`` has exited) re-enters the policy
    its forward ran under with it, as a JAX remat traces once under it."""
    prev = current_policy()
    _STATE.policy = policy
    try:
        yield
    finally:
        _STATE.policy = prev


@contextlib.contextmanager
def auto_cast(enable: bool = True, dtype="bfloat16", level: str = "O1"):
    """``paddle.amp.auto_cast``: the layers inside compute in ``dtype``
    (O1, O2); ``"O0"`` or ``enable=False`` turns the casts off.  The
    previous policy is restored on exit."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"bad AMP level {level}")
    with policy_scope(AmpPolicy(enabled=enable and level != "O0",
                                compute_dtype=_dt.canonicalize_dtype(dtype),
                                level=level)):
        yield


amp_guard = auto_cast  # the reference's older name


def cast_if_enabled(*xs):
    """Cast tensors to the active compute dtype (the identity when AMP is
    off); one argument gives one value, several a tuple."""
    p = current_policy()
    out = tuple(p.cast(x) for x in xs)
    return out[0] if len(out) == 1 else out


def decorate(model: torch.nn.Module, optimizer=None, dtype="bfloat16",
             level: str = "O2"):
    """O2 decoration: every floating parameter and buffer of ``model`` cast
    to ``dtype`` in place (``paddle.amp.decorate``).  The float32 masters
    live in the optimizer (``multi_precision``): bind it after this call.
    Returns ``model``, or ``(model, optimizer)`` when one is passed."""
    cd = _dt.canonicalize_dtype(dtype)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.is_floating_point() and t.dtype != cd:
                t.data = t.data.to(cd)
    if optimizer is None:
        return model
    return model, optimizer
