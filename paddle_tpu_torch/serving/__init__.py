"""Serving: the continuous-batching `Engine` over dense slot caches or
the paged KV pool (with the radix prefix cache, chunked prefill, n-gram,
draft-model and adaptive speculation, deadlines, bounded admission and
a background step loop), with its request handles and timelines, fault
injection, scheduler and stats."""
from .engine import Engine
from .errors import (DeadlineExceededError, EngineClosedError, HungStepError,
                     InfeasibleDeadlineError, OverloadedError,
                     PoolExhaustedError, ServingError)
from .faults import FaultInjector, InjectedFault
from .kv_slots import SlotKVCache
from .metrics import EngineStats
from .paged import PagedKVCache, PagePool
from .prefix_cache import PrefixCache
from .request import RequestHandle, SamplingParams
from .speculative import (AdaptiveSpecK, CallableDrafter, NgramDrafter,
                          spec_k_ladder)
from .timeline import Timeline, TimelineRing, cause_of

__all__ = ["Engine", "EngineStats", "PagePool", "PagedKVCache",
           "PrefixCache", "RequestHandle", "SamplingParams", "ServingError",
           "SlotKVCache", "DeadlineExceededError", "EngineClosedError",
           "HungStepError", "InfeasibleDeadlineError", "OverloadedError",
           "PoolExhaustedError", "FaultInjector", "InjectedFault",
           "AdaptiveSpecK", "CallableDrafter", "NgramDrafter",
           "spec_k_ladder", "Timeline", "TimelineRing", "cause_of"]
