"""Crash flight recorder: a black box for engine and train-loop deaths.

Counterpart: ``paddle_tpu/observability/flight_recorder.py``, copied (it
imports nothing of JAX). The `FlightRecorder` keeps a bounded ring of
recent span and async events (it registers as a `tracing` sink, so it
sees what a chrome-trace export would) plus periodic registry snapshots,
and on a real death (a step that raised, a train loop out of its
anomaly budget) dumps one self-contained postmortem JSON artifact:

    {"schema": "paddle_tpu.flight_recorder/v1", "reason": "...",
     "error": "...", "engine_id": "...", "wall_time": ...,
     "heartbeat_busy_since_monotonic": ..., "heartbeat_stale_s": ...,
     "last_dispatch_done_age_s": ...,
     "in_flight_request_ids": [...], "queued_request_ids": [...],
     "in_flight_timelines": [...], "queued_timelines": [...],
     "kv_cache_bytes": ..., "pool": {...}, "events": [...],
     "registry": {...}, "recent_registry_snapshots": [...]}

The schema keeps the reference's name, so a tool written for one reads
the other. A clean ``Engine.close()`` writes nothing: the box records
crashes, not shutdowns. Dumping never raises into the death path (its
own failures count on ``flight_recorder_dump_failures_total``).

``Engine(flight_recorder=True)`` builds a default instance (artifacts in
``$TMPDIR/paddle_tpu_torch_flight``); pass a recorder to choose
``dump_dir``. Written paths are kept on ``.dumps``.
"""
from __future__ import annotations

import json
import numbers
import os
import tempfile
import threading
import time
from collections import deque

from . import tracing
from .registry import get_registry

SCHEMA = "paddle_tpu.flight_recorder/v1"


def _jsonable(obj):
    """json.dump default: numpy scalars in span args become plain
    numbers (integral vs real branched by type — casting int() first
    would floor a fractional float32), anything else its repr — a
    postmortem must never fail to serialize."""
    if isinstance(obj, numbers.Integral):
        return int(obj)
    if isinstance(obj, numbers.Real):
        return float(obj)
    return repr(obj)


class FlightRecorder:
    """Bounded event ring + snapshot history + postmortem dumper.

    ``capacity`` bounds the span-event ring (oldest events fall off);
    ``snapshot_interval_s``/``keep_snapshots`` pace the periodic
    registry snapshots the engines feed via `maybe_snapshot` (called at
    the top of every engine step, rate-limited here so the hot path
    pays one monotonic read)."""

    def __init__(self, capacity=4096, dump_dir=None,
                 snapshot_interval_s=1.0, keep_snapshots=4,
                 registry=None):
        self._registry = registry or get_registry()
        #: the tracing sink: a bounded deque IS the ring (append/extend
        #: drop from the left at capacity — ring semantics by
        #: construction, no bookkeeping on the emit hot path)
        self._ring: deque = deque(maxlen=int(capacity))
        self._snapshots: deque = deque(maxlen=int(keep_snapshots))
        self._interval = float(snapshot_interval_s)
        self._last_snap = 0.0
        self._lock = threading.Lock()
        self._seq = 0
        self._attached = False
        self.dump_dir = dump_dir or os.path.join(
            tempfile.gettempdir(), "paddle_tpu_torch_flight")
        #: artifact paths written by this recorder, in order
        self.dumps: list = []

    # -- wiring ----------------------------------------------------------
    def attach(self):
        """Register the ring as a tracing sink (idempotent; every
        engine sharing the recorder calls this)."""
        with self._lock:
            if not self._attached:
                tracing.add_sink(self._ring)
                self._attached = True
        return self

    def detach(self):
        with self._lock:
            if self._attached:
                tracing.remove_sink(self._ring)
                self._attached = False
        return self

    def events(self) -> list:
        """Snapshot of the ring (oldest first). The tracing lock guards
        writers; a concurrent append can still invalidate iteration, so
        copy with a bounded retry instead of crashing the dump path."""
        for _ in range(5):
            try:
                return list(self._ring)
            except RuntimeError:  # deque mutated during iteration
                continue
        return []

    def maybe_snapshot(self):
        """Rate-limited registry snapshot (the per-engine periodic
        history): cheap no-op inside the interval."""
        now = time.monotonic()
        if now - self._last_snap < self._interval:
            return
        with self._lock:
            if now - self._last_snap < self._interval:
                return
            self._last_snap = now
        snap = {"wall_time": time.time(),
                "registry": self._registry.snapshot()}
        with self._lock:
            self._snapshots.append(snap)

    # -- the postmortem --------------------------------------------------
    def dump_engine_death(self, engine, error) -> str | None:
        """Write one postmortem artifact for ``engine`` dying with
        ``error``. NEVER raises — the black box must not mask the death
        it is recording; its own failures are counted on the registry."""
        try:
            return self._dump(engine, error)
        except Exception:  # noqa: BLE001 - see docstring: count, don't mask
            self._registry.counter(
                "flight_recorder_dump_failures_total",
                "postmortem dumps that themselves failed").inc()
            return None

    def dump_train_death(self, loop, error) -> str | None:
        """The training-plane postmortem (r16): the black box fires for
        a dying `ResilientTrainLoop` — crash injection, anomaly-budget
        exhaustion, a real step error — with the loop's position and
        checkpoint accounting at the moment of impact. Same contract as
        `dump_engine_death`: best-effort, never raises."""
        try:
            mgr = getattr(loop, "_manager", None)
            step = getattr(loop, "step", None)
            ring = getattr(step, "telemetry_ring", None)
            artifact = {
                "schema": SCHEMA,
                "kind": "train_death",
                "reason": type(error).__name__,
                "error": repr(error),
                "loop_id": loop.loop_id,
                "wall_time": time.time(),
                "step": loop._step_idx,
                "data_cursor": loop._data_cursor,
                "skipped_data_indices": sorted(loop._skipped),
                "rollbacks": loop._rollbacks,
                "resumed_from": loop.resumed_from,
                "last_committed_step": loop.last_committed_step,
                "checkpoint_dir": getattr(mgr, "directory", None),
                "checkpoint_commit_errors": list(
                    getattr(mgr, "commit_errors", ())),
                # r19 introspection: the anomaly trail with per-layer
                # attribution (which layer blew up, and why the
                # attributor thinks so) + the last-K per-step telemetry
                # rows — the postmortem names the layer, not just the
                # step
                "anomaly_history": [dict(r) for r in
                                    getattr(loop, "anomaly_history", ())],
                "anomaly_attribution": (
                    dict(loop.last_anomaly)
                    if getattr(loop, "last_anomaly", None) else None),
                "telemetry_ring": (ring.rows() if ring is not None
                                   else []),
                "data_stall_fraction": getattr(
                    loop, "data_stall_fraction", None),
                "events": self.events(),
                "registry": self._registry.snapshot(),
                "recent_registry_snapshots": list(self._snapshots),
            }
            return self._write(loop.loop_id, artifact)
        except Exception:  # noqa: BLE001 - count, don't mask the death
            self._registry.counter(
                "flight_recorder_dump_failures_total",
                "postmortem dumps that themselves failed").inc()
            return None

    def _dump(self, engine, error) -> str:
        now = time.monotonic()
        hb = engine.heartbeat()
        last_done = getattr(engine, "_hb_last_done", None)
        pool = {}
        if getattr(engine, "kv_mode", None) == "paged":
            pool = {"page_size": engine.kv.page_size,
                    "pages_total": engine.kv.pages_total,
                    "pages_in_use": engine.kv.pages_in_use,
                    "pages_free": engine.kv.pages_free}
        # the victims' phase timelines, captured BEFORE the shutdown
        # sweep closes them: each is still OPEN (no terminal mark), so
        # its LAST phase is literally where the request was stuck at
        # the moment of death — the "why was it slow" record the ids
        # alone never gave (r18)
        in_flight = [r for r in engine._slot_req if r is not None]
        adm = getattr(engine, "_admitting", None)
        if adm is not None and all(r is not adm for r in in_flight):
            in_flight.append(adm)
        queued = list(engine.scheduler._queue)
        artifact = {
            "schema": SCHEMA,
            "reason": type(error).__name__,
            "error": repr(error),
            "engine_id": engine.engine_id,
            "wall_time": time.time(),
            # the heartbeat pair: busy-since (the wedged dispatch's
            # start, when one is in flight) and the age of the last
            # dispatch that RETURNED — the "last good heartbeat"
            "heartbeat_busy_since_monotonic": hb,
            "heartbeat_stale_s": (round(now - hb, 6)
                                  if hb is not None else None),
            "last_dispatch_done_age_s": (round(now - last_done, 6)
                                         if last_done is not None
                                         else None),
            "in_flight_request_ids": [r.rid for r in in_flight],
            "queued_request_ids": [r.rid for r in queued],
            "in_flight_timelines": [r.timeline.as_dict(r)
                                    for r in in_flight],
            "queued_timelines": [r.timeline.as_dict(r) for r in queued],
            "kv_cache_bytes": engine.kv.memory_bytes(),
            "pool": pool,
            "events": self.events(),
            "registry": self._registry.snapshot(),
            "recent_registry_snapshots": list(self._snapshots),
        }
        return self._write(engine.engine_id, artifact)

    def _write(self, ident, artifact) -> str:
        """Atomically write one artifact for source ``ident`` (an
        engine id or a train-loop id) and account for it."""
        os.makedirs(self.dump_dir, exist_ok=True)
        with self._lock:
            seq = self._seq
            self._seq += 1
        path = os.path.join(
            self.dump_dir, f"flight-{ident}-{os.getpid()}-{seq}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(artifact, f, default=_jsonable)
        os.replace(tmp, path)  # an artifact is whole or absent, never torn
        self._registry.counter(
            "flight_recorder_dumps_total",
            "postmortem artifacts written on engine/train-loop deaths",
            labelnames=("engine",)).inc(engine=ident)
        with self._lock:
            self.dumps.append(path)
        return path


__all__ = ["FlightRecorder", "SCHEMA"]
