"""Automatic mixed precision (the port's counterpart of
``paddle_ray_tpu/amp``).

A thread-local policy that the compute layers consult (``Linear``, the
convolutions, the tensor-parallel linears, ``QATLinear``): inside
:func:`auto_cast` they cast their input to the compute dtype at the matmul
boundary, so the product runs in it (``F.linear`` casts the weight to the
input's dtype), while parameters, normalisation and losses stay as they
are -- the O1 lists of the reference expressed structurally, as in JAX.
:func:`decorate` (O2) casts the parameters themselves; the optimizer's
``multi_precision`` masters keep them in float32.  :class:`GradScaler`
scales the loss of float16 training
(``build_train_step(..., scaler=)``).
"""
from .auto_cast import (AmpPolicy, amp_guard, auto_cast, cast_if_enabled,
                        current_policy, decorate)
from .grad_scaler import GradScaler, ScalerState

__all__ = ["AmpPolicy", "auto_cast", "amp_guard", "current_policy",
           "cast_if_enabled", "decorate", "GradScaler", "ScalerState"]
