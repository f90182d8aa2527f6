"""The profiler: host ranges over the port's trace spans, the device
trace from `torch.profiler` (`profiler.Profiler`)."""
from .profiler import (  # noqa: F401
    Profiler, ProfilerState, ProfilerTarget, RecordEvent, SortedKeys,
    SummaryView, export_chrome_tracing, export_protobuf,
    load_profiler_result, make_scheduler)

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "SortedKeys", "SummaryView", "export_chrome_tracing",
           "export_protobuf", "load_profiler_result", "make_scheduler"]
