"""Accept/reject for draft-verify speculative decoding, greedy (a copy of
``paddle_ray_tpu/serving/spec/verify.py``, which is numpy only).

The engine packs a decoding slot's chunk as ``[pending, d_1, ..., d_k]``
(the pending token sampled last step plus ``k`` draft guesses) and runs it
through the ordinary mixed step with the LM head over the whole chunk:
row ``j``'s argmax is the model's greedy token after consuming the chunk
through row ``j``.  :func:`greedy_accept` keeps the longest draft prefix
the model agrees with:

* row 0's argmax ``g_0`` is the token one-token decode would have given --
  always emitted, so a fully rejected draft still advances one token;
* draft ``d_{j+1}`` is accepted iff it equals ``g_j`` -- then row ``j+1``
  consumed what greedy decoding would have, and ``g_{j+1}`` is the next
  greedy token in turn;
* the first disagreement rejects ``d_{j+1}`` and all after it; ``g_j`` is
  still emitted as the bonus token.

The emitted tokens ``g_0 .. g_acc`` are therefore the token-by-token
greedy stream for every draft; only the steps per token change.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["greedy_accept"]


def greedy_accept(draft: np.ndarray,
                  row_argmax: np.ndarray) -> Tuple[int, np.ndarray]:
    """Longest-agreeing-prefix acceptance for one sequence.

    draft: ``[k]`` tokens guessed after the pending token; row_argmax:
    ``[>= k+1]`` the model's argmax at each chunk row (row 0 after the
    pending token, row j after draft ``d_j``).  Returns ``(accepted,
    emitted)`` with ``emitted = row_argmax[:accepted + 1]`` int32."""
    draft = np.asarray(draft).reshape(-1)
    row_argmax = np.asarray(row_argmax).reshape(-1)
    if len(row_argmax) < len(draft) + 1:
        raise ValueError(
            f"need {len(draft) + 1} argmax rows to verify {len(draft)} "
            f"draft tokens, got {len(row_argmax)}")
    accepted = 0
    while accepted < len(draft) and int(draft[accepted]) == int(
            row_argmax[accepted]):
        accepted += 1
    return accepted, row_argmax[:accepted + 1].astype(np.int32)
