"""Observability: the recompile sentinel and the counter family it bumps.

Counterpart: ``paddle_tpu/observability/``. Ported so far: the sentinel
(`sentinel`) and, of the registry (`registry`), labeled counters and
gauges. The rest (histograms, the exposition, the profiler, the flight
recorder) is ROADMAP A9.
"""
from .registry import Counter, Gauge, MetricsRegistry, get_registry
from .sentinel import RecompileError, RecompileSentinel, get_sentinel, traced

__all__ = ["Counter", "Gauge", "MetricsRegistry", "get_registry", "RecompileError",
           "RecompileSentinel", "get_sentinel", "traced"]
