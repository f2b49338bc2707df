"""Kernels of the port: each hand-written for Hopper, with its plain
PyTorch version beside it."""
from .paged_attention import (DEFAULT_PAGE_SIZE, paged_decode_attention,
                              paged_ragged_attention,
                              paged_ragged_attention_plain)

__all__ = ["DEFAULT_PAGE_SIZE", "paged_decode_attention",
           "paged_ragged_attention", "paged_ragged_attention_plain"]
