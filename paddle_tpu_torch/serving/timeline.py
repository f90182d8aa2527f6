"""Per-request phase timelines: where every request spent its life.

Counterpart: ``paddle_tpu/serving/timeline.py``, ported whole (host-only
Python). Every `Request` carries a `Timeline`; the scheduler and the
engine mark each lifecycle transition into it (submitted -> queued ->
admitted -> prefill -> decode -> terminal), and the per-phase durations
are the differences of consecutive marks: no device work, a handful of
floats a request. ``transit`` is the disaggregated handoff's phase; the
port's engine marks nothing with it until the cluster (ROADMAP A10)
does.

Invariants:

- **monotone**: each mark's time is clamped to the previous one, so a
  skewed clock never gives a negative phase;
- **complete**: every submitted request ends in exactly ONE terminal
  mark with a typed cause (`done` / `deadline` / `shed` / `cancel` /
  `exhausted` / `engine_death`, `cause_of`), written by the first closer
  (`RequestHandle._close` funnels every terminal path through
  `Timeline.close`, first-writer-wins);
- **re-routing-safe**: a requeue re-enters ``queued``; consecutive
  same-phase marks collapse into one with a ``visits`` count.

`TimelineRing` keeps terminated timelines: the most recent ones and the
N worst by end-to-end latency (``engine.timelines``).
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque

from .errors import (
    DeadlineExceededError,
    OverloadedError,
    PoolExhaustedError,
)

#: request.FINISHED — spelled out, not imported: request.py imports
#: this module (every Request carries a Timeline), so importing back
#: would cycle
_FINISHED = "finished"

#: lifecycle phases, in canonical order (a timeline may revisit
#: ``queued``/``transit``/``decode`` but never invents a new name)
PHASE_SUBMITTED = "submitted"
PHASE_QUEUED = "queued"
PHASE_ADMITTED = "admitted"
PHASE_PREFILL = "prefill"
PHASE_TRANSIT = "transit"
PHASE_DECODE = "decode"
PHASE_TERMINAL = "terminal"
PHASES = (PHASE_SUBMITTED, PHASE_QUEUED, PHASE_ADMITTED, PHASE_PREFILL,
          PHASE_TRANSIT, PHASE_DECODE, PHASE_TERMINAL)

#: typed terminal causes — the "why did it end" axis of the timeline
CAUSE_DONE = "done"
CAUSE_DEADLINE = "deadline"
CAUSE_SHED = "shed"
CAUSE_CANCEL = "cancel"
CAUSE_EXHAUSTED = "exhausted"
CAUSE_ENGINE_DEATH = "engine_death"
TERMINAL_CAUSES = (CAUSE_DONE, CAUSE_DEADLINE, CAUSE_SHED, CAUSE_CANCEL,
                   CAUSE_EXHAUSTED, CAUSE_ENGINE_DEATH)


def cause_of(state, error) -> str:
    """Map a request's terminal (state, error) pair to its typed cause.
    The close funnel's ONE copy of the classification: `DeadlineExceededError`
    -> deadline, `OverloadedError` -> shed, `PoolExhaustedError` ->
    exhausted, no error -> done/cancel by state, anything else (step
    failure, watchdog `HungStepError`, `EngineClosedError`, a lost
    decode replica) -> engine_death."""
    if error is None:
        return CAUSE_DONE if state == _FINISHED else CAUSE_CANCEL
    if isinstance(error, DeadlineExceededError):
        return CAUSE_DEADLINE
    if isinstance(error, OverloadedError):
        return CAUSE_SHED
    if isinstance(error, PoolExhaustedError):
        return CAUSE_EXHAUSTED
    return CAUSE_ENGINE_DEATH


class Timeline:
    """Monotone log of phase transitions for one request.

    ``mark(phase, **detail)`` appends a transition stamped with a
    clamped `time.perf_counter` (never before the previous mark);
    ``close(cause, error)`` writes the single terminal mark —
    first-writer-wins, every later mark/close is a no-op, so a raced
    double-close (orphan sweep vs late adoption) cannot double-record.
    Reads (`as_dict`, `durations`) are safe at any time, including on
    a still-open timeline (the flight recorder snapshots in-flight
    timelines mid-death)."""

    __slots__ = ("_marks", "_lock", "terminal_cause", "terminal_error")

    def __init__(self, t0=None):
        self._lock = threading.Lock()
        #: list of (phase, t_abs, detail-or-None) in mark order
        self._marks = [(PHASE_SUBMITTED,
                        float(t0) if t0 is not None else time.perf_counter(),
                        None)]
        self.terminal_cause = None
        self.terminal_error = None

    # -- writers ---------------------------------------------------------
    def mark(self, phase, t=None, **detail):
        """Append one transition (no-op once closed). ``t`` defaults to
        perf_counter and is clamped to the previous mark — monotone by
        construction, whatever the caller's clock did.

        CONSECUTIVE same-phase marks collapse into the existing mark
        (first-entry timestamp kept, ``visits`` counted in its detail):
        a pool-exhausted request bouncing queue->pop->requeue every
        engine step re-marks ``queued`` tens of times per second, and
        an unbounded mark list would bloat every /requests payload and
        postmortem that retains it. Non-consecutive revisits (requeue
        after admission, handoff hops) still append — the log of
        DISTINCT phase transitions stays complete."""
        if phase not in PHASES:
            raise ValueError(f"unknown timeline phase {phase!r} — one of "
                             f"{PHASES}")
        now = float(t) if t is not None else time.perf_counter()
        with self._lock:
            if self.terminal_cause is not None:
                return
            last_phase, last_t, last_d = self._marks[-1]
            if phase == last_phase:
                d = dict(last_d) if last_d else {}
                d["visits"] = d.get("visits", 1) + 1
                if detail:
                    d.update(detail)
                self._marks[-1] = (last_phase, last_t, d)
                return
            self._marks.append((phase, max(now, last_t),
                                detail or None))

    def close(self, cause, error=None, t=None) -> bool:
        """Write the terminal mark. True only for the FIRST closer —
        callers gate their once-per-request bookkeeping (SLO
        observation, exemplar-ring record) on it."""
        if cause not in TERMINAL_CAUSES:
            raise ValueError(f"unknown terminal cause {cause!r} — one of "
                             f"{TERMINAL_CAUSES}")
        now = float(t) if t is not None else time.perf_counter()
        with self._lock:
            if self.terminal_cause is not None:
                return False
            self.terminal_cause = cause
            self.terminal_error = error
            self._marks.append((PHASE_TERMINAL, max(now, self._marks[-1][1]),
                                {"cause": cause}))
            return True

    # -- readers ---------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self.terminal_cause is not None

    def marks(self) -> list:
        """Snapshot of (phase, t_abs, detail) tuples, oldest first."""
        with self._lock:
            return list(self._marks)

    def phases(self) -> list:
        return [p for p, _, _ in self.marks()]

    @property
    def submit_t(self) -> float:
        return self._marks[0][1]

    @property
    def last_t(self) -> float:
        with self._lock:
            return self._marks[-1][1]

    def total_s(self) -> float:
        """Submit -> last mark (end-to-end latency once closed)."""
        marks = self.marks()
        return marks[-1][1] - marks[0][1]

    def durations(self) -> dict:
        """Seconds spent in each phase, summed over repeated visits
        (requeues, handoffs). Phase i's duration runs to mark i+1; the
        last mark of an OPEN timeline accrues nothing yet (the flight
        recorder's "where was it stuck" reads the last phase name
        instead). All values are >= 0 by the monotone clamp."""
        marks = self.marks()
        out = {}
        for (phase, t, _), (_, t_next, _) in zip(marks, marks[1:]):
            out[phase] = out.get(phase, 0.0) + (t_next - t)
        return out

    def as_dict(self, req=None) -> dict:
        """JSON-able view (the ``/requests`` payload row and the
        flight-recorder capture). Timestamps are offsets from submit.
        ``req`` adds request identity/progress fields."""
        marks = self.marks()
        t0 = marks[0][1]
        out = {
            "phases": [
                {"phase": p, "t_s": round(t - t0, 6),
                 **({"detail": d} if d else {})}
                for p, t, d in marks],
            "durations_s": {k: round(v, 6)
                            for k, v in self.durations().items()},
            "total_s": round(marks[-1][1] - t0, 6),
            "terminal": self.terminal_cause,
            "error": (repr(self.terminal_error)
                      if self.terminal_error is not None else None),
        }
        if req is not None:
            dl = req.deadline_s
            if dl is not None and not math.isfinite(dl):
                # submit(deadline_s=inf) opts out of a default; bare
                # Infinity is not strict JSON — report as "none"
                dl = None
            out.update(request_id=req.rid, prompt_len=req.prompt_len,
                       max_new_tokens=req.max_new_tokens,
                       tokens_emitted=len(req.emitted),
                       deadline_s=dl)
            trace = getattr(req, "trace", None)
            if trace is not None:
                # the federated /requests join key: local rids collide
                # across processes, trace ids don't — and the hop list
                # names every engine that owned the request, in order
                out["trace_id"] = trace.trace_id
                out["trace_hops"] = [h["engine"] for h in trace.hops]
        return out


class TimelineRing:
    """Bounded retention of terminated timelines for ``/requests``:
    the ``recent`` most recent plus the ``worst`` highest end-to-end
    latency exemplars (kept sorted, evicting the mildest — the N-worst
    set a "why are we slow" investigation starts from)."""

    def __init__(self, recent=64, worst=16):
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=int(recent))
        self._worst_cap = int(worst)
        self._worst: list = []          # (total_s, seq, row) sorted desc
        self._seq = 0
        self.recorded = 0

    def record(self, req, row=None):
        """Retain one terminated request's timeline (called from the
        close funnel, first-closer only). ``row`` lets the funnel
        serialize once and share the dict across the engine + cluster
        rings (the row is read-only downstream)."""
        if row is None:
            row = req.timeline.as_dict(req)
        total = row["total_s"]
        with self._lock:
            self.recorded += 1
            seq = self._seq
            self._seq += 1
            self._recent.append(row)
            w = self._worst
            if len(w) < self._worst_cap or total > w[-1][0]:
                w.append((total, seq, row))
                w.sort(key=lambda t: (-t[0], t[1]))
                del w[self._worst_cap:]

    def snapshot(self) -> dict:
        with self._lock:
            return {"recorded": self.recorded,
                    "recent": list(self._recent),
                    "worst": [row for _, _, row in self._worst]}


__all__ = ["Timeline", "TimelineRing", "cause_of", "PHASES",
           "TERMINAL_CAUSES",
           "PHASE_SUBMITTED", "PHASE_QUEUED", "PHASE_ADMITTED",
           "PHASE_PREFILL", "PHASE_TRANSIT", "PHASE_DECODE",
           "PHASE_TERMINAL",
           "CAUSE_DONE", "CAUSE_DEADLINE", "CAUSE_SHED", "CAUSE_CANCEL",
           "CAUSE_EXHAUSTED", "CAUSE_ENGINE_DEATH"]
