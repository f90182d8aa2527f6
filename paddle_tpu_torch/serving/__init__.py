"""Serving: the cooperative continuous-batching `Engine` over the paged
KV pool, with its request handles, scheduler and stats."""
from .engine import Engine
from .errors import ServingError
from .metrics import EngineStats
from .paged import PagedKVCache, PagePool
from .request import RequestHandle, SamplingParams

__all__ = ["Engine", "EngineStats", "PagePool", "PagedKVCache",
           "RequestHandle", "SamplingParams", "ServingError"]
