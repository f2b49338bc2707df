"""Memory-efficient AdamW (the port's counterpart of
``paddle_ray_tpu/optimizer/memory_efficient.py``): blockwise 8-bit moments
and master-free stochastic rounding.

- The moments may be blockwise-quantized to 8 bits (Dettmers et al. 2021):
  a float32 absmax scale per ``block_size`` flat elements, the first
  moment signed-linear (int8), the second kept in the sqrt domain
  (uint8), each :class:`QMoment` holding codes in the parameter's shape
  and the scales of its flattened, block-padded view.  Or bfloat16, or
  float32.
- Without ``master_weights`` a bfloat16 parameter keeps no float32 master:
  the update is computed in float32 and written back by
  :func:`stochastic_round`, keyed on ``fold_in(fold_in(PRNGKey(sr_seed),
  step), leaf)``, ``leaf`` the parameter's index among the JAX module's
  leaves (:func:`.optimizer.jax_leaf_order`).

On CUDA a parameter's whole update is one launch of the hand-written
kernel (:func:`..ops.me_adamw.me_adamw_update`, counted in its
``launches``); on the CPU it is its plain version,
:func:`..ops.me_adamw.me_adamw_plain`.  The quantization and rounding
functions live beside the kernel's wrapper and are re-exported here.
State a parameter for ``moment_dtype="int8"`` without masters: two code
bytes and ``8 / block_size`` bytes of scales, against 12 for AdamW's
float32 moments and master.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import prng
from ..ops.me_adamw import (QMoment, dequantize_blockwise, me_adamw_plain,
                            me_adamw_update, quantize_blockwise,
                            stochastic_round)
from .optimizer import Adam

__all__ = ["QMoment", "MemoryEfficientAdamW", "quantize_blockwise",
           "dequantize_blockwise", "stochastic_round", "me_adamw_plain"]


class MemoryEfficientAdamW(Adam):
    """AdamW with blockwise 8-bit (or bfloat16) moments and, for bfloat16
    parameters, optional master-free stochastic-rounding updates.

    Args beyond :class:`~.optimizer.AdamW`:
      moment_dtype: ``"int8"`` (blockwise-quantized), ``"bfloat16"`` or
        ``"float32"``.
      block_size: quantization block (flat elements a float32 scale).
      master_weights: False (default) keeps no float32 master: bfloat16
        parameters are updated in float32 and written back by stochastic
        rounding keyed on ``(sr_seed, step, leaf index)``; True keeps the
        float32 master (``multi_precision`` is derived from it).
    """

    slot_names = ("m", "v")
    decoupled_wd = True

    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay: float = 0.01, *,
                 moment_dtype: str = "int8", block_size: int = 256,
                 master_weights: bool = False, sr_seed: int = 0x5EED, **kw):
        if moment_dtype not in ("int8", "bfloat16", "float32"):
            raise ValueError(f"moment_dtype {moment_dtype!r}")
        if int(block_size) < 1:
            raise ValueError(f"block_size {block_size} must be positive")
        if kw.pop("multi_precision", master_weights) != master_weights:
            raise ValueError("multi_precision is derived from "
                             "master_weights here; pass master_weights "
                             "only")
        kw["multi_precision"] = master_weights
        parameters = kw.pop("parameters", None)
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         weight_decay=weight_decay, **kw)
        self.moment_dtype = moment_dtype
        self.block_size = int(block_size)
        self.sr_seed = sr_seed
        self._step_key: Tuple[int, Optional[Tuple[int, int]]] = (0, None)
        if parameters is not None:
            self.bind(parameters)

    def _check_params(self, params) -> None:
        if not self.multi_precision and any(p.dtype == torch.float16
                                            for p in params):
            raise ValueError(
                "master_weights=False relies on stochastic rounding, "
                "which targets bfloat16 params; float16 params would "
                "get deterministic round-to-nearest (dropped small "
                "updates). Use master_weights=True for fp16.")

    def _init_slot(self, name: str, p: torch.Tensor):
        if self.moment_dtype == "float32":
            return super()._init_slot(name, p)
        if self.moment_dtype == "bfloat16":
            return torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
        nb = -(-p.numel() // self.block_size)
        return QMoment(
            codes=torch.zeros(p.shape, dtype=torch.int8 if name == "m"
                              else torch.uint8, device=p.device),
            scale=torch.zeros(nb, dtype=torch.float32, device=p.device))

    def _sr_key(self, t: int, leaf_idx: int) -> Tuple[int, int]:
        """``fold_in(fold_in(PRNGKey(sr_seed), t), leaf_idx)``'s words,
        on the host."""
        if self._step_key[0] != t:
            self._step_key = (t, prng.key_words(
                prng.fold_in(prng.PRNGKey(self.sr_seed), t)))
        k0, k1 = self._step_key[1]
        return prng.threefry2x32(k0, k1, 0, leaf_idx & 0xFFFFFFFF)

    def _step_leaf(self, p, g, st, lr, t, decays, leaf_idx):
        master = st.get("master")
        key = (self._sr_key(t, leaf_idx)
               if p.dtype == torch.bfloat16 and master is None else None)
        bc1, bc2 = self._bias_corrections(t, self.beta1, self.beta2)
        # the kernel takes the flat (row-major) order the blocks and the
        # rounding bits are defined over
        pc, gc = p.contiguous(), g.contiguous()
        me_adamw_update(
            pc, gc, st["m"], st["v"], master, lr=lr, b1=self.beta1,
            b2=self.beta2, eps=self.epsilon,
            wd=self.weight_decay if decays else 0.0,
            l1=self._l1_coeff if decays else 0.0,
            l2=self._l2_coeff if decays else 0.0, bc1=bc1, bc2=bc2,
            block=self.block_size, key=key)
        if pc is not p:
            p.copy_(pc)
