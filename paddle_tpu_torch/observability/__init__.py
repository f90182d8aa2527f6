"""Observability: the recompile sentinel and the counter family it bumps.

Counterpart: ``paddle_tpu/observability/``. Ported so far: the sentinel
(`sentinel`) and, of the registry (`registry`), the one counter family
it writes. The rest (gauges, histograms, the exposition, the profiler,
the flight recorder) is ROADMAP A9.
"""
from .registry import Counter, MetricsRegistry, get_registry
from .sentinel import RecompileError, RecompileSentinel, get_sentinel, traced

__all__ = ["Counter", "MetricsRegistry", "get_registry", "RecompileError",
           "RecompileSentinel", "get_sentinel", "traced"]
