"""Profiler.

Counterpart: ``paddle_tpu/profiler/profiler.py`` (Paddle's
``paddle.profiler.Profiler``: a host tracer of `RecordEvent` ranges
beside a device tracer, driven step by step by a scheduler). The host
tracer is the port's `observability.tracing`: a `RecordEvent` is a
`tracing.Span`, and each recording `Profiler` owns a sink of its own, so
two instances never share events. The device tracer is `torch.profiler`
(CUPTI) where the reference has ``jax.profiler`` (:124-145): a
``ProfilerTarget.GPU`` target starts it on the card for each recording
window and stops it at the window's end; its result is
``Profiler.device_profile`` (``key_averages()``, ``export_chrome_trace``).
If it cannot start, the profiler raises: only a caller that asks for
CPU targets alone gets no device trace (the reference swallows the
failure, :132-136). The default targets are CPU and GPU, so a default
`Profiler` needs a card, as every entry point of the port does.

`export_chrome_tracing(dir)` writes the host ranges as chrome-trace
JSON and, beside them, the device trace of the window. `export_protobuf`
cannot write the reference's xplane.pb (``jax.profiler``'s format,
:244-257): it writes the device trace as `torch.profiler`'s chrome trace
and the host-event table beside it (a documented deviation).
"""
from __future__ import annotations

import enum
import json
import os
import time

from ..observability import tracing as _tracing


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


class RecordEvent(_tracing.Span):
    """A host range (Paddle's ``RecordEvent``), as a context manager or
    ``begin()``/``end()``: a `tracing.Span` carrying ``args`` and the
    ambient request id, delivered to the span buffer and to every
    recording `Profiler`."""

    def __init__(self, name, event_type=None, args=None):
        super().__init__(name, args=args)


def make_scheduler(*, closed, ready, record, repeat=0, skip_first=0):
    """The step-indexed state machine (Paddle's ``make_scheduler``):
    after ``skip_first`` steps, periods of ``closed`` + ``ready`` +
    ``record`` steps, the last recording step of each
    ``RECORD_AND_RETURN``; ``repeat`` periods (0: forever)."""
    period = closed + ready + record

    def scheduler(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat > 0 and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def export_chrome_tracing(dir_name, worker_name=None):
    """``on_trace_ready`` factory: each window's host ranges to
    ``<dir>/<worker>_time_<t>.json`` and, with a device trace, that
    trace to ``<worker>_time_<t>.device.json`` beside it. The handler
    returns the host file's path."""
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        stem = os.path.join(dir_name, f"{name}_time_{int(time.time())}")
        prof._export(stem + ".json")
        if prof.device_profile is not None:
            prof.device_profile.export_chrome_trace(stem + ".device.json")
        return stem + ".json"
    return handler


def load_profiler_result(path):
    with open(path) as f:
        return json.load(f)


class Profiler:
    """Paddle's ``Profiler``: ``targets`` (default CPU and GPU), a
    ``scheduler`` (a `make_scheduler` function or a ``(start, end)``
    step pair), ``on_trace_ready`` called at the end of each recording
    window, ``timer_only`` (host ranges only, no device trace)."""

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False, emit_nvtx=False):
        self.targets = list(targets or [ProfilerTarget.CPU,
                                        ProfilerTarget.GPU])
        for t in self.targets:
            if t not in (ProfilerTarget.CPU, ProfilerTarget.GPU):
                raise ValueError(
                    f"Profiler target {t}: the port traces the host (CPU) "
                    "and NVIDIA cards (GPU) only")
        if isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            scheduler = make_scheduler(closed=max(start, 0), ready=0,
                                       record=end - start, repeat=1)
        self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.with_flops = with_flops
        self.step_num = 0
        self.state = ProfilerState.CLOSED
        self._events = []
        #: the recording window's span sink (registered while recording)
        self._sink = None
        self._device = None
        #: the last window's `torch.profiler.profile` (GPU target), else
        #: None
        self.device_profile = None

    # -- lifecycle -------------------------------------------------------
    def start(self):
        self.state = (self.scheduler(self.step_num) if self.scheduler
                      else ProfilerState.RECORD)
        if self.state in (ProfilerState.RECORD,
                          ProfilerState.RECORD_AND_RETURN):
            self._start_record()

    def _start_record(self):
        self._sink = []
        _tracing.add_sink(self._sink)
        if ProfilerTarget.GPU in self.targets and not self.timer_only:
            import torch
            from torch.profiler import ProfilerActivity, profile

            if not torch.cuda.is_available():
                _tracing.remove_sink(self._sink)
                self._sink = None
                raise RuntimeError(
                    "Profiler: the GPU target needs a CUDA device — pass "
                    "targets=[ProfilerTarget.CPU] to trace the host alone")
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           record_shapes=self.record_shapes,
                           profile_memory=self.profile_memory,
                           with_flops=self.with_flops)
            try:
                prof.__enter__()
            except Exception:
                _tracing.remove_sink(self._sink)
                self._sink = None
                raise
            self._device = prof

    def _stop_record(self):
        if self._sink is not None:
            _tracing.remove_sink(self._sink)
            self._events = list(self._sink)
            self._sink = None
        if self._device is not None:
            prof, self._device = self._device, None
            prof.__exit__(None, None, None)
            self.device_profile = prof

    def stop(self):
        if self.state in (ProfilerState.RECORD,
                          ProfilerState.RECORD_AND_RETURN):
            self._stop_record()
            if self.on_trace_ready:
                self.on_trace_ready(self)
        self.state = ProfilerState.CLOSED

    def step(self):
        """Advance the scheduler one step. ``RECORD_AND_RETURN`` ends a
        recording window at the end of its step, also when the next
        window starts at once (back-to-back periods export once each)."""
        prev = self.state
        self.step_num += 1
        new = (self.scheduler(self.step_num) if self.scheduler
               else ProfilerState.RECORD)
        recording = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if prev is ProfilerState.RECORD_AND_RETURN:
            self._stop_record()
            if self.on_trace_ready:
                self.on_trace_ready(self)
            if new in recording:
                self._start_record()
        elif prev in recording and new not in recording:
            self._stop_record()
            if self.on_trace_ready:
                self.on_trace_ready(self)
        elif prev not in recording and new in recording:
            self._start_record()
        self.state = new

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- results ---------------------------------------------------------
    def _export(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events}, f)

    def export(self, path, format="json"):
        self._export(path)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Print and return the host ranges by name: calls, total and
        mean ms (async and instant events have no duration and are
        left out)."""
        by_name = {}
        for e in self._events:
            if "dur" not in e:
                continue
            agg = by_name.setdefault(e["name"], {"calls": 0,
                                                 "total_us": 0.0})
            agg["calls"] += 1
            agg["total_us"] += e["dur"]
        rows = sorted(by_name.items(), key=lambda kv: -kv[1]["total_us"])
        print(f"{'Name':<40}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>12}")
        print("-" * 72)
        for name, agg in rows:
            total_ms = agg["total_us"] / 1000.0
            print(f"{name:<40}{agg['calls']:>8}{total_ms:>12.3f}"
                  f"{total_ms / agg['calls']:>12.3f}")
        return by_name


class SortedKeys(enum.Enum):
    """Summary-table sort keys (Paddle's ``SortedKeys``)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(enum.Enum):
    """Summary views (Paddle's ``SummaryView``)."""
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def export_protobuf(dir_name, worker_name=None):
    """``on_trace_ready`` factory in place of the reference's xplane.pb
    export: the window's device trace as `torch.profiler`'s chrome trace,
    ``<dir>/<worker>.pt.trace.json``, and the host-event table,
    ``<dir>/host_events.json``."""
    def handle_fn(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        if prof.device_profile is not None:
            prof.device_profile.export_chrome_trace(
                os.path.join(dir_name, f"{name}.pt.trace.json"))
        prof.export(os.path.join(dir_name, "host_events.json"),
                    format="json")
    return handle_fn


__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "SortedKeys", "SummaryView", "export_chrome_tracing",
           "export_protobuf", "load_profiler_result", "make_scheduler"]
