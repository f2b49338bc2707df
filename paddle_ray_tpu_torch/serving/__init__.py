"""Paged continuous-batching serving of the port."""
from .engine import (RequestStats, RequestStatus, ServingEngine,
                     ServingStats, paged_decode_step, paged_mixed_step)
from .page_pool import PagePool
from .prefix_cache import PrefixCache, PrefixMatch

__all__ = ["PagePool", "PrefixCache", "PrefixMatch", "RequestStats",
           "RequestStatus", "ServingEngine", "ServingStats",
           "paged_decode_step", "paged_mixed_step"]
