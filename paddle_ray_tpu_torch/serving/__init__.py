"""Paged continuous-batching serving of the port: the engine with its
prefix cache, speculative decoding, double-buffered dispatch, request
lifecycle, fault injection (:class:`FaultPlan`) and the page sanitizer
(:class:`PageSanitizer`)."""
from .chaos import ChaosError, EngineStallError, FaultEvent, FaultPlan
from .page_pool import PagePool
from .pagesan import PageSanError, PageSanitizer
from .prefix_cache import PrefixCache, PrefixMatch
from .spec import DraftSource, NGramDrafter, greedy_accept
from .engine import (RequestStats, RequestStatus, ServingEngine,
                     ServingStats, paged_decode_step, paged_mixed_step,
                     paged_prefill)

__all__ = ["ChaosError", "DraftSource", "EngineStallError", "FaultEvent",
           "FaultPlan", "NGramDrafter", "PagePool", "PageSanError",
           "PageSanitizer", "PrefixCache", "PrefixMatch", "RequestStats",
           "RequestStatus", "ServingEngine", "ServingStats",
           "greedy_accept", "paged_decode_step", "paged_mixed_step",
           "paged_prefill"]
