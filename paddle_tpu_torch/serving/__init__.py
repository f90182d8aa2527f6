"""Serving: the cooperative continuous-batching `Engine` over dense slot
caches or the paged KV pool (with the radix prefix cache and chunked
prefill), with its request handles, scheduler and stats."""
from .engine import Engine
from .errors import ServingError
from .kv_slots import SlotKVCache
from .metrics import EngineStats
from .paged import PagedKVCache, PagePool
from .prefix_cache import PrefixCache
from .request import RequestHandle, SamplingParams

__all__ = ["Engine", "EngineStats", "PagePool", "PagedKVCache",
           "PrefixCache", "RequestHandle", "SamplingParams", "ServingError",
           "SlotKVCache"]
