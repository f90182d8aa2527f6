"""Trace spans: host ranges + request-lifecycle events -> chrome trace.

Counterpart: ``paddle_tpu/observability/tracing.py``, copied (it imports
nothing of JAX). Spans carry an ``args`` dict and an ambient
**request-id context**, and every span has ONE delivery path with two
consumers:

- the always-on bounded span buffer this module owns (a serving or
  training run exports it with ``export_chrome_trace``), and
- whatever sinks are registered (`add_sink`, `collect`): each consumer
  registers its own, so two never clobber each other.

Async events (``ph: b/e/n``) keyed by a request id nest under that id's
lane in the trace viewer, interleaved with the ordinary ``X`` host
ranges (``span``) on the thread tracks. The training loop
(`framework.train_loop`) emits its ``train.*`` spans and instants here;
the serving engine's lifecycle events are ROADMAP A9.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque

#: ambient request id — set by `request_scope`, stamped into every span
#: (and async event) finished inside the scope
_request_id: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_request_id", default=None)
#: ambient DISTRIBUTED trace id — set by `request_scope(trace_id=)`
#: so host ranges emitted inside the scope join the request's federated
#: lane even when the local rid collides across processes
_trace_id: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_trace_id", default=None)

_lock = threading.Lock()
#: instance-scoped sinks (profiler.Profiler recordings register here)
_sinks: list = []
#: default span-ring capacity (events); `set_buffer_capacity` resizes
DEFAULT_BUFFER_CAPACITY = 65536
#: the always-on span buffer — a RING: at capacity the oldest events
#: fall off, and every eviction is counted on
#: ``trace_events_dropped_total`` so a long-lived serving process shows
#: how much of its trace history has rolled over rather than silently
#: growing (or silently forgetting)
_buffer: deque = deque(maxlen=DEFAULT_BUFFER_CAPACITY)
_buffer_enabled = [True]
#: monotone event cursor: total events EVER appended to the ring (ring
#: rollover and `clear()` never rewind it). Event i of the current ring
#: snapshot has sequence ``_appended - len(ring) + i`` — `events_since`
#: turns that into incremental scrapes for the telemetry federator
#: (``/trace?since=<cursor>``) with an exact count of events that
#: rolled off between scrapes (those are the same evictions
#: ``trace_events_dropped_total`` counts).
_appended = [0]


#: cached handle for the drop counter — at steady state a full ring
#: drops on EVERY emit, so the hot path must not re-resolve through the
#: registry's constructor each time. The identity re-check keeps a
#: test's `registry.reset()` from leaving us incrementing an orphan.
_dropped_counter: list = []


def _note_dropped(n: int):
    from .registry import get_registry  # late: registry is dependency-
    # free, but keep tracing importable in any order

    reg = get_registry()
    c = _dropped_counter[0] if _dropped_counter else None
    if c is None or reg.get("trace_events_dropped_total") is not c:
        c = reg.counter(
            "trace_events_dropped_total",
            "span events evicted from the bounded trace ring buffer")
        _dropped_counter[:] = [c]
    c.inc(n)


def current_request_id():
    return _request_id.get()


@contextlib.contextmanager
def request_scope(request_id, trace_id=None):
    """Make ``request_id`` ambient: spans finished inside the scope carry
    ``args["request_id"]`` without threading it through call sites.
    ``trace_id`` additionally stamps ``args["trace_id"]`` — the
    distributed trace id a federated merger joins lanes by (local rids
    collide across processes; trace ids don't)."""
    tok = _request_id.set(request_id)
    ttok = _trace_id.set(trace_id) if trace_id is not None else None
    try:
        yield
    finally:
        if ttok is not None:
            _trace_id.reset(ttok)
        _request_id.reset(tok)


def add_sink(sink):
    """Register a list-like event sink (append-only). The profiler's
    recording windows use this; each Profiler owns its own sink.
    Matching is by IDENTITY, not equality — two freshly-started
    profilers both hold empty lists, which compare ``==`` equal."""
    with _lock:
        if not any(s is sink for s in _sinks):
            _sinks.append(sink)


def remove_sink(sink):
    with _lock:
        for i, s in enumerate(_sinks):
            if s is sink:
                del _sinks[i]
                break


def sinks_active() -> bool:
    return bool(_sinks)


def buffer_enabled() -> bool:
    return _buffer_enabled[0]


def set_buffer_enabled(flag: bool):
    """Turn the always-on span buffer off (and back on). With the buffer
    off and no profiler recording, span emission — including the
    engine's per-token lifecycle events — short-circuits before taking
    the lock, for serving deployments that scrape metrics but don't
    want per-request tracing overhead."""
    with _lock:
        _buffer_enabled[0] = bool(flag)


def active() -> bool:
    """Cheap hot-path check: is anything consuming span events?"""
    return _buffer_enabled[0] or bool(_sinks)


def emit_event(evt: dict):
    """Deliver one chrome-trace event dict to the buffer + active sinks.
    No-op (before taking the lock) when the buffer is disabled and no
    profiler is recording."""
    if not (_buffer_enabled[0] or _sinks):
        return
    rid = _request_id.get()
    if rid is not None and "request_id" not in evt.setdefault("args", {}):
        evt["args"]["request_id"] = rid
    tid = _trace_id.get()
    if tid is not None and "trace_id" not in evt.setdefault("args", {}):
        evt["args"]["trace_id"] = tid
    dropped = 0
    with _lock:
        if _buffer_enabled[0]:
            if len(_buffer) == _buffer.maxlen:
                dropped = 1
            _buffer.append(evt)
            _appended[0] += 1
        for s in _sinks:
            s.append(evt)
    if dropped:
        _note_dropped(dropped)


def emit_events(evts):
    """Bulk delivery: one lock acquisition for a whole batch (the
    engine's per-token lifecycle events for one decode step)."""
    if not evts or not (_buffer_enabled[0] or _sinks):
        return
    dropped = 0
    with _lock:
        if _buffer_enabled[0]:
            dropped = max(0, len(_buffer) + len(evts) - _buffer.maxlen)
            _buffer.extend(evts)
            _appended[0] += len(evts)
        for s in _sinks:
            s.extend(evts)
    if dropped:
        _note_dropped(dropped)


def _base(name, ph, cat):
    return {"name": name, "ph": ph, "cat": cat, "pid": os.getpid(),
            "tid": threading.get_ident() % 100000,
            "ts": time.perf_counter_ns() / 1000.0}


class Span:
    """Named host range with args and request-id context.

    Context manager or explicit ``begin()``/``end()`` — the duration
    event (``ph: X``) is recorded at ``end()``. ``profiler.RecordEvent``
    is the args-free subclass kept for Paddle API parity.
    """

    def __init__(self, name, args=None, cat="host"):
        self.name = name
        self.args = dict(args) if args else {}
        self.cat = cat
        self._begin_ns = None

    def set_args(self, **kw):
        self.args.update(kw)
        return self

    def begin(self):
        self._begin_ns = time.perf_counter_ns()
        return self

    def end(self):
        if self._begin_ns is None:
            return
        if not (_buffer_enabled[0] or _sinks):
            # nothing consumes the event: build none
            self._begin_ns = None
            return
        end_ns = time.perf_counter_ns()
        evt = {"name": self.name, "ph": "X", "cat": self.cat,
               "ts": self._begin_ns / 1000.0,
               "dur": (end_ns - self._begin_ns) / 1000.0,
               "pid": os.getpid(),
               "tid": threading.get_ident() % 100000}
        if self.args:
            evt["args"] = dict(self.args)
        self._begin_ns = None
        emit_event(evt)

    def __enter__(self):
        return self.begin()

    def __exit__(self, *exc):
        self.end()


def span(name, **args):
    """``with observability.span("serving.prefill", slot=3): ...``"""
    return Span(name, args)


def instant(name, **args):
    """Zero-duration marker (``ph: i``)."""
    if not (_buffer_enabled[0] or _sinks):
        return
    evt = _base(name, "i", "host")
    evt["s"] = "t"  # thread-scoped instant
    if args:
        evt["args"] = args
    emit_event(evt)


# -- async request-lifecycle events ------------------------------------------

def async_begin(name, aid, cat="request", **args):
    """Open an async span keyed by ``aid`` (the request id): the trace
    viewer groups/nests b/n/e events sharing (cat, id)."""
    if not (_buffer_enabled[0] or _sinks):
        return
    evt = _base(name, "b", cat)
    evt["id"] = str(aid)
    evt["args"] = {"request_id": aid, **args}
    emit_event(evt)


def async_instant_evt(name, aid, cat="request", **args) -> dict:
    """Build (don't emit) an async-instant event dict — hot loops batch
    these and deliver them with one `emit_events` call."""
    evt = _base(name, "n", cat)
    evt["id"] = str(aid)
    evt["args"] = {"request_id": aid, **args}
    return evt


def async_instant(name, aid, cat="request", **args):
    if not (_buffer_enabled[0] or _sinks):
        return
    emit_event(async_instant_evt(name, aid, cat, **args))


def async_end(name, aid, cat="request", **args):
    if not (_buffer_enabled[0] or _sinks):
        return
    evt = _base(name, "e", cat)
    evt["id"] = str(aid)
    evt["args"] = {"request_id": aid, **args}
    emit_event(evt)


# -- distributed trace context -----------------------------------------------

class TraceContext:
    """The identity a request keeps across engines AND processes.

    A disaggregated request's spans are emitted by two engines — under
    federation, by two *processes* whose local rids collide. The trace
    context is created once by the ORIGIN engine (first enqueue), rides
    the `Request`, ships inside the `HandoffState` (the cross-process
    path serializes it with ``as_dict``), and is restored by
    ``adopt_handoff`` — so every async lifecycle event on both sides is
    keyed by the same ``trace_id`` and the merged chrome trace shows
    one lane. Each engine that takes ownership stamps a HOP (engine id
    + wall/monotonic clocks at adoption); the hop index rides every
    event's args, giving the federated merger a causal order that
    survives cross-host clock skew (hop k's events can never sort
    before hop k-1's after the monotone clamp).
    """

    __slots__ = ("trace_id", "origin", "hops")

    def __init__(self, trace_id, origin, hops=None):
        self.trace_id = str(trace_id)
        self.origin = origin
        #: per-hop stamps, adoption order: {"engine", "wall_time_s",
        #: "perf_us"} — the origin engine is hop 0
        self.hops = list(hops) if hops else []

    @classmethod
    def new(cls, origin, rid) -> "TraceContext":
        """Fresh context stamped by the origin engine. The id embeds
        origin + local rid for debuggability plus random bits for
        global uniqueness (two processes both number requests from 0)."""
        ctx = cls(f"{origin}/{rid}#{uuid.uuid4().hex[:8]}", origin)
        ctx.stamp(origin)
        return ctx

    def stamp(self, engine_id):
        """Record that ``engine_id`` took ownership (origin enqueue /
        handoff adoption) — wall + monotonic clocks sampled together so
        a merger can align this hop's timestamps."""
        self.hops.append({"engine": engine_id,
                          "wall_time_s": time.time(),
                          "perf_us": time.perf_counter_ns() / 1000.0})

    @property
    def hop(self) -> int:
        """Index of the CURRENT hop (0 = origin)."""
        return max(0, len(self.hops) - 1)

    def as_dict(self) -> dict:
        return {"trace_id": self.trace_id, "origin": self.origin,
                "hops": [dict(h) for h in self.hops]}

    @classmethod
    def from_dict(cls, d) -> "TraceContext":
        return cls(d["trace_id"], d.get("origin"), d.get("hops"))

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, origin={self.origin!r}, "
                f"hops={[h['engine'] for h in self.hops]})")


def clock_anchor() -> dict:
    """Wall-clock <-> monotonic-clock anchor for THIS process, sampled
    back-to-back. Event timestamps are perf_counter microseconds —
    mutually meaningless across processes; a trace bundle that carries
    this anchor lets the federated merger shift its events onto the
    wall clock (``ts_wall_us = ts - perf_us + wall_time_s*1e6``). The
    residual error is the wall-clock skew between hosts, which the
    merger bounds with the scrape round-trip and flattens with the
    monotone clamp."""
    return {"wall_time_s": time.time(),
            "perf_us": time.perf_counter_ns() / 1000.0,
            "pid": os.getpid()}


# -- buffer management / export ----------------------------------------------

def cursor() -> int:
    """Monotone ring cursor: total events ever appended (survives ring
    rollover and `clear()`)."""
    with _lock:
        return _appended[0]


def events_since(since=None):
    """Incremental ring read -> ``(events, next_cursor, missed)``.

    ``since`` is a cursor from a previous call (or None for the whole
    ring). ``missed`` counts events that rolled off the ring between
    that cursor and now — the federator's share of what
    ``trace_events_dropped_total`` counted globally. A cursor FROM THE
    FUTURE (the scraped process restarted and its cursor reset) resends
    the whole ring rather than silently returning nothing."""
    with _lock:
        total = _appended[0]
        evs = list(_buffer)
    if since is None or since > total:
        return evs, total, 0
    since = max(0, int(since))
    first = total - len(evs)
    missed = max(0, first - since)
    return evs[max(0, since - first):], total, missed


def buffer_capacity() -> int:
    with _lock:
        return _buffer.maxlen


def set_buffer_capacity(capacity: int):
    """Resize the bounded span ring. The newest events are kept;
    evictions the shrink forces are counted on
    ``trace_events_dropped_total`` like any other ring overflow."""
    global _buffer
    capacity = int(capacity)
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    dropped = 0
    with _lock:
        dropped = max(0, len(_buffer) - capacity)
        _buffer = deque(_buffer, maxlen=capacity)
    if dropped:
        _note_dropped(dropped)


def clear():
    with _lock:
        _buffer.clear()


def events() -> list:
    """Snapshot of the buffered span events (oldest first)."""
    with _lock:
        return list(_buffer)


@contextlib.contextmanager
def collect():
    """Scoped collection: yields a list that receives every span event
    emitted inside the block (independent of the ring buffer, so tests
    and exporters see exactly their own window)."""
    sink: list = []
    add_sink(sink)
    try:
        yield sink
    finally:
        remove_sink(sink)


def export_chrome_trace(path, events_list=None, clear_buffer=False) -> str:
    """Write buffered (or explicitly passed) span events as a
    chrome://tracing / Perfetto JSON file; returns the path."""
    evs = list(events_list) if events_list is not None else events()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    if clear_buffer and events_list is None:
        clear()
    return path


__all__ = ["Span", "span", "instant", "request_scope", "current_request_id",
           "async_begin", "async_instant", "async_instant_evt",
           "async_end", "collect",
           "events", "events_since", "cursor", "clock_anchor",
           "TraceContext",
           "clear", "export_chrome_trace", "emit_event",
           "emit_events", "add_sink", "remove_sink", "sinks_active",
           "buffer_enabled", "set_buffer_enabled", "active",
           "buffer_capacity", "set_buffer_capacity",
           "DEFAULT_BUFFER_CAPACITY"]
