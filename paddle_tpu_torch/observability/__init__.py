"""Observability: the recompile sentinel and the metrics registry.

Counterpart: ``paddle_tpu/observability/``. Ported so far: the sentinel
(`sentinel`); of the registry (`registry`), labeled counters, gauges
and fixed-bucket histograms with `bucket_quantile`; trace spans
(`tracing`), the training introspection plane (`train_introspection`)
and `guarded_target` (`threads`). The rest (the exposition, the
profiler, the flight recorder, the scrape endpoint) is ROADMAP A9.
"""
from . import tracing, train_introspection  # noqa: F401
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       bucket_quantile, get_registry)
from .sentinel import RecompileError, RecompileSentinel, get_sentinel, traced
from .threads import guarded_target

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "bucket_quantile", "get_registry", "RecompileError",
           "RecompileSentinel", "get_sentinel", "traced", "guarded_target",
           "tracing", "train_introspection"]
