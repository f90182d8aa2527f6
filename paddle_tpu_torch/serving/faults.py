"""Deterministic fault injection for the serving resilience layer.

Counterpart: ``paddle_tpu/serving/faults.py``, ported whole (host-only
Python). It injects the faults the engine defends against at exact
step or request indices, so every failure path runs in tests instead of
by luck:

- ``step_error``: raise inside a step's dispatch (the engine dies
  through `_die`: every handle fails typed, every page returns);
- ``step_hang``: a bounded ``sleep_s`` stall inside the dispatch while
  the engine lock is held (what a wedged step looks like; the watchdog
  that turns it into `HungStepError` is the cluster's, ROADMAP A10);
- ``reserve_fail``: a paged admission's reservation reports
  exhaustion, driving the requeue / backoff / `PoolExhaustedError` path
  without a tiny pool;
- ``handoff_drop``: a disaggregated handoff vanishes (the cluster's
  hook, A10; no engine of the port calls it);
- ``clock_skew``: the engine's deadline clock runs ``skew_s`` ahead
  (once ``at_step`` decode steps ran), so a deadline expires at a
  chosen token instead of racing wall time.

Usage::

    inj = FaultInjector()
    inj.add("step_error", engine="e0", at_step=1)
    inj.add("clock_skew", skew_s=1e6, at_step=2)
    eng = Engine(model, ..., engine_id="e0", fault_injector=inj)

Specs are one-shot by default (``times=1``) and match on ``(kind,
engine, at_step, at_request)``, ``None`` matching anything;
``clock_skew`` stays applied once its ``at_step`` has passed. Every
firing is recorded on ``injector.fired``. An engine without an injector
pays one ``is None`` check a hook.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class InjectedFault(RuntimeError):
    """The exception ``step_error`` raises inside the dispatch — a
    stand-in for any real step failure (XLA OOM, a kernel bug)."""


@dataclass
class FaultSpec:
    kind: str
    engine: str | None = None      # engine_id, None = any engine
    at_step: int | None = None     # 0-based dispatch index, None = any
    at_request: int | None = None  # request id, None = any
    times: int = 1                 # firings left (clock_skew ignores it)
    kw: dict = field(default_factory=dict)


class FaultInjector:
    """Deterministic, thread-safe fault schedule shared by the engines
    and cluster it is passed to (``fault_injector=``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: list[FaultSpec] = []
        #: (kind, engine_id, detail) per firing, in order — what tests
        #: assert against
        self.fired: list = []

    def add(self, kind, engine=None, at_step=None, at_request=None,
            times=1, **kw) -> "FaultInjector":
        """Schedule one fault; chainable. ``kw`` carries the
        kind-specific payload (``sleep_s`` for step_hang, ``skew_s``
        for clock_skew, ``phase`` = 'decode'|'prefill' for the step
        faults, default 'decode')."""
        known = ("step_error", "step_hang", "reserve_fail",
                 "handoff_drop", "clock_skew")
        if kind not in known:
            raise ValueError(f"unknown fault kind {kind!r} — one of {known}")
        with self._lock:
            self._specs.append(FaultSpec(kind, engine, int(at_step)
                                         if at_step is not None else None,
                                         at_request, int(times), kw))
        return self

    # -- matching --------------------------------------------------------
    def _take(self, kind, engine_id=None, step=None, rid=None, phase=None):
        """Pop (decrement) the first matching armed spec, or None."""
        with self._lock:
            for spec in self._specs:
                if spec.kind != kind or spec.times <= 0:
                    continue
                if spec.engine is not None and spec.engine != engine_id:
                    continue
                if spec.at_step is not None and spec.at_step != step:
                    continue
                if spec.at_request is not None and spec.at_request != rid:
                    continue
                if phase is not None and spec.kw.get("phase",
                                                     "decode") != phase:
                    continue
                spec.times -= 1
                return spec
        return None

    def _note(self, kind, engine_id, **detail):
        with self._lock:
            self.fired.append((kind, engine_id, detail))

    # -- hooks the engine/cluster call -----------------------------------
    def on_dispatch(self, engine, phase: str, index: int):
        """Called with the engine lock held, immediately before a
        compiled prefill/decode dispatch (heartbeat already stamped
        busy). ``index`` is the 0-based count of prior ``phase``
        dispatches on this engine. May stall (step_hang) and/or raise
        (step_error) — raising takes the engine's normal death path."""
        eid = engine.engine_id
        spec = self._take("step_hang", eid, step=index, phase=phase)
        if spec is not None:
            sleep_s = float(spec.kw.get("sleep_s", 0.5))
            self._note("step_hang", eid, phase=phase, step=index,
                       sleep_s=sleep_s)
            time.sleep(sleep_s)      # bounded: the injected wedge always ends
        spec = self._take("step_error", eid, step=index, phase=phase)
        if spec is not None:
            self._note("step_error", eid, phase=phase, step=index)
            raise InjectedFault(
                f"injected {phase} failure on {eid} at step {index}")

    def fail_reserve(self, engine, req) -> bool:
        """True = this admission's page reservation must report
        exhaustion (the engine requeues the request exactly as if the
        pool were full)."""
        spec = self._take("reserve_fail", engine.engine_id, rid=req.rid)
        if spec is None:
            return False
        self._note("reserve_fail", engine.engine_id, rid=req.rid)
        return True

    def drop_handoff(self, cluster, req) -> bool:
        """True = this prefill→decode handoff is lost in transit (the
        cluster releases its pages and must NOT queue it; the handle
        stays open — the orphan the deadline sweep has to catch)."""
        spec = self._take("handoff_drop", None, rid=req.rid)
        if spec is None:
            return False
        self._note("handoff_drop", cluster.cluster_id, rid=req.rid)
        return True

    def skew(self, engine) -> float:
        """Seconds added to ``engine``'s deadline clock: the sum of
        every active clock_skew spec (active = engine matches and its
        decode-step count reached the spec's ``at_step``)."""
        total = 0.0
        with self._lock:
            specs = list(self._specs)
        for spec in specs:
            if spec.kind != "clock_skew":
                continue
            if spec.engine is not None and spec.engine != engine.engine_id:
                continue
            if (spec.at_step is not None
                    and engine.metrics.decode_steps < spec.at_step):
                continue
            total += float(spec.kw.get("skew_s", 0.0))
        return total

    def pending(self) -> int:
        """Armed one-shot firings left (clock_skew excluded)."""
        with self._lock:
            return sum(s.times for s in self._specs
                       if s.kind != "clock_skew" and s.times > 0)


__all__ = ["FaultInjector", "FaultSpec", "InjectedFault"]
