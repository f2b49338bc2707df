"""Weight regularizers (the port of ``paddle_ray_tpu/regularizer.py``).

``L1Decay(coeff)`` adds ``coeff * sign(w)`` to the gradient,
``L2Decay(coeff)`` adds ``coeff * w`` (coupled into the gradient); pass
either as ``weight_decay=`` to an optimizer, which applies it in float32
to the parameters its decay mask selects.  Decoupled decay (AdamW style)
remains the plain-float ``weight_decay``.
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class _Decay:
    kind = ""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L1Decay(_Decay):
    """loss += coeff * sum(|w|)  ->  grad += coeff * sign(w)."""

    kind = "l1"


class L2Decay(_Decay):
    """loss += 0.5 * coeff * sum(w^2)  ->  grad += coeff * w."""

    kind = "l2"
