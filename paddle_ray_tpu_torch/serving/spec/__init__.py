"""Speculative decoding (the port of ``paddle_ray_tpu/serving/spec``): a
draft source guesses ``k`` tokens per decoding sequence, the engine packs
``[pending, d_1..d_k]`` as one ragged chunk through the same mixed step
every other slot uses (the ragged paged kernel's per-sequence ``q_len``
and causal-within-chunk masking are the verification; one launch per
layer, no new kernel), and :func:`greedy_accept` keeps the longest prefix
the model's argmax agrees with plus one bonus token.  Outputs equal
token-by-token greedy decoding; only the steps per token change.

* :class:`DraftSource` -- the proposer protocol; :class:`NGramDrafter`
  looks the request's own prompt and generation up (``draft.py``);
* :func:`greedy_accept` -- the accept rule (``verify.py``);
* the scheduler side lives in :class:`~..engine.ServingEngine`
  (``spec_decode=``).
"""
from .draft import DraftSource, NGramDrafter
from .verify import greedy_accept

__all__ = ["DraftSource", "NGramDrafter", "greedy_accept"]
