"""Observability: the recompile sentinel and the metrics registry.

Counterpart: ``paddle_tpu/observability/``. Ported so far: the sentinel
(`sentinel`) and, of the registry (`registry`), labeled counters, gauges
and fixed-bucket histograms with `bucket_quantile`. The rest (the
exposition, the profiler, the flight recorder) is ROADMAP A9.
"""
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       bucket_quantile, get_registry)
from .sentinel import RecompileError, RecompileSentinel, get_sentinel, traced

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "bucket_quantile", "get_registry", "RecompileError",
           "RecompileSentinel", "get_sentinel", "traced"]
