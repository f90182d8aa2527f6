"""Process-level self-telemetry: RSS, uptime, thread count.

Counterpart: ``paddle_tpu/observability/process_stats.py``, copied (it
imports nothing of JAX). Three gauges a fleet dashboard can alert on,
read the cheapest way the platform allows (one ``/proc`` read on Linux,
``resource.getrusage`` elsewhere): ``process_rss_bytes`` (the current
resident set from ``/proc/self/statm``, else the ``ru_maxrss`` peak),
``process_uptime_seconds`` (since the kernel's start time of the
process, else since this module was imported) and
``process_thread_count`` (live Python threads). `ProcessSampler`
refreshes them on a guarded daemon thread; the `ObservabilityServer`
starts the process-wide one (`ensure_process_sampler`) with its first
instance and puts a fresh sample in every ``/healthz`` payload."""
from __future__ import annotations

import os
import resource
import socket
import sys
import threading
import time

from .registry import get_registry
from .threads import guarded_target

#: fallback process-start reference when /proc is unavailable —
#: import time is the closest observable stand-in
_IMPORT_T = time.monotonic()

#: explicit instance override (list cell so tests can reset it); when
#: unset the gauges label themselves ``host:pid``
_INSTANCE: list = [None]


def set_process_instance(instance) -> None:
    """Name this process in the ``instance`` label of the process_*
    gauges (and so in federated views). ``None`` reverts to the
    ``host:pid`` default. The `ObservabilityServer` calls this with its
    own instance name, so a federator's ``/metrics`` shows each
    target's self-telemetry under the same identity it scrapes it by."""
    _INSTANCE[0] = instance


def process_instance() -> str:
    return _INSTANCE[0] or f"{socket.gethostname()}:{os.getpid()}"


def _proc_start_age_s() -> float | None:
    """Seconds since the kernel started this process, off
    /proc/self/stat (field 22, clock ticks) vs /proc/uptime."""
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        # comm (field 2) may contain spaces/parens: split after it
        start_ticks = float(stat.rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return max(0.0, uptime - start_ticks / hz)
    except (OSError, ValueError, IndexError):
        return None


def _rss_bytes() -> int:
    """Current resident bytes (/proc), else the getrusage PEAK — a
    coarser but portable stand-in (ru_maxrss is KiB on Linux but
    BYTES on macOS, the one platform likely to take this branch)."""
    try:
        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
        return resident_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024


def read_process_stats() -> dict:
    """One sample, as a plain dict (the /healthz payload block)."""
    age = _proc_start_age_s()
    return {
        "rss_bytes": _rss_bytes(),
        "uptime_s": age if age is not None else time.monotonic() - _IMPORT_T,
        "thread_count": threading.active_count(),
    }


def publish_process_stats(registry=None, instance=None) -> dict:
    """Sample AND set the three gauges; returns the sample. The gauges
    carry an ``instance`` label (r24: ``host:pid`` unless overridden via
    ``instance=`` or `set_process_instance`) so N processes' rows merge
    into one federated exposition without colliding."""
    reg = registry or get_registry()
    inst = instance or process_instance()
    s = read_process_stats()
    reg.gauge("process_rss_bytes",
              "resident set size of this process",
              ("instance",)).set(s["rss_bytes"], instance=inst)
    reg.gauge("process_uptime_seconds",
              "seconds since process start",
              ("instance",)).set(s["uptime_s"], instance=inst)
    reg.gauge("process_thread_count",
              "live Python threads (engines, drainers, watchdogs, HTTP "
              "handlers)",
              ("instance",)).set(s["thread_count"], instance=inst)
    return s


class ProcessSampler:
    """Periodic `publish_process_stats` on a guarded daemon thread."""

    def __init__(self, interval_s=5.0, registry=None):
        self._interval = float(interval_s)
        self._registry = registry
        self._stop = threading.Event()
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        if self.running:
            return self
        self._stop.clear()
        publish_process_stats(self._registry)   # gauges exist immediately
        self._thread = threading.Thread(
            target=guarded_target("process-sampler", self._loop),
            daemon=True, name="paddle_tpu_torch-process-sampler")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self._interval + 1.0)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self._interval):
            publish_process_stats(self._registry)


_singleton_lock = threading.Lock()
_singleton: list = []


def ensure_process_sampler(interval_s=5.0) -> ProcessSampler:
    """Start (once) and return the process-wide sampler — the
    observability server calls this; a dedicated deployment can too.
    Idempotent; the singleton is never stopped implicitly (it is one
    daemon thread waking every ``interval_s``)."""
    with _singleton_lock:
        if not _singleton:
            _singleton.append(ProcessSampler(interval_s=interval_s))
        sampler = _singleton[0]
    sampler.start()
    return sampler


__all__ = ["ProcessSampler", "ensure_process_sampler",
           "publish_process_stats", "read_process_stats",
           "set_process_instance", "process_instance"]
