"""Declarative serving SLOs: goodput, attainment, error-budget burn.

Counterpart: ``paddle_tpu/observability/slo.py``, copied (it imports
nothing of JAX). An `SLO` declares the objectives
(``Engine(slo=SLO(ttft_p99_s=0.5, itl_p99_s=0.1))``); an `SLOTracker`
evaluates every terminated request against them, once, from the request
handle's close path:

- a completed request attains when its TTFT, its own inter-token p99
  and its end-to-end latency each meet the objective set (an unset one
  holds vacuously);
- a request that never completed is violated under its typed terminal
  cause (``deadline``, ``shed``, ``exhausted``, ``engine_death``);
- a client ``cancel`` counts as neither.

Published per source (``engine=`` label): ``serving_slo_attained_total``
and ``serving_slo_violated_total{engine, objective}``, and over each
rolling window (``window="life"`` since construction or reset)
``serving_slo_attainment_ratio``, ``serving_slo_goodput_per_second`` and
``serving_slo_burn_rate`` (the violated fraction over the error budget,
``1 - availability``). ``goodput_per_s`` is a field of the engine's
`stats()`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, fields

from .registry import get_registry

#: window label for the since-construction (non-rolling) aggregates
LIFETIME_WINDOW = "life"


@dataclass(frozen=True)
class SLO:
    """Declarative latency/availability objectives for a serving
    source. All objectives optional; unset ones are not evaluated.

    ``ttft_p99_s``: submit -> first token bound. ``itl_p99_s``: bound
    on the request's own p99 inter-token gap (TPOT shaped — vacuous
    for single-token requests). ``e2e_p99_s``: submit -> final token
    bound (the deadline-shaped objective the overload bench uses).
    The ``_p99`` suffix names the TARGET RANK: ``availability`` is the
    fraction of requests that must attain (0.99 -> a 1% error budget),
    and the burn-rate gauges measure spend against that budget.
    ``windows`` are the rolling evaluation horizons in seconds,
    shortest first (the burn-rate alerting windows)."""

    ttft_p99_s: float | None = None
    itl_p99_s: float | None = None
    e2e_p99_s: float | None = None
    availability: float = 0.99
    windows: tuple = (60.0, 300.0)

    def __post_init__(self):
        if not 0.0 < self.availability < 1.0:
            raise ValueError(
                f"availability must be in (0, 1), got {self.availability}")
        if not self.windows or any(w <= 0 for w in self.windows):
            raise ValueError(
                f"windows must be positive seconds, got {self.windows!r}")
        for f in ("ttft_p99_s", "itl_p99_s", "e2e_p99_s"):
            v = getattr(self, f)
            if v is not None and v <= 0:
                raise ValueError(f"{f} must be > 0, got {v}")

    def objectives(self) -> dict:
        """The set objectives as a name -> bound dict (JSON-able)."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if f.name.endswith("_s") and getattr(self, f.name)
                is not None}


def _req_itl_p99(token_times) -> float | None:
    """The request's own p99 inter-token gap (None with < 2 tokens).
    Exact order statistic over the handful of host stamps — cheap, and
    per-request (the aggregate p99 lives in the histograms)."""
    n = len(token_times)
    if n < 2:
        return None
    gaps = sorted(b - a for a, b in zip(token_times, token_times[1:]))
    return gaps[min(len(gaps) - 1, int(0.99 * len(gaps)))]


class SLOTracker:
    """Rolling SLO evaluation for one serving source.

    ``observe(req)`` is called from the request close funnel exactly
    once per terminated request (the timeline's first-closer gate);
    everything else is read-side. Thread-safe; the rolling state is
    one bounded deque of (t, attained) pairs pruned to the longest
    window."""

    def __init__(self, slo: SLO, source_id: str, registry=None):
        if not isinstance(slo, SLO):
            raise ValueError(
                f"slo must be an observability.SLO, got {type(slo).__name__}")
        self.slo = slo
        self.source_id = str(source_id)
        self._registry = registry or get_registry()
        self._labels = {"engine": self.source_id}
        self._lock = threading.Lock()
        self._events: deque = deque()      # (t_monotonic, attained: bool)
        self._max_window = max(slo.windows)
        self._attained = 0
        self._violated = 0
        self._violated_by: dict = {}
        self._start_t = time.monotonic()
        #: (computed_at_monotonic, value) — see burn_rate()
        self._burn_cache = None
        reg = self._registry
        self._c_attained = reg.counter(
            "serving_slo_attained_total",
            "terminated requests that met every configured SLO objective",
            labelnames=("engine",))
        self._c_violated = reg.counter(
            "serving_slo_violated_total",
            "terminated requests that missed an SLO objective or failed "
            "typed (labelled by the first objective/cause violated)",
            labelnames=("engine", "objective"))
        self._g_attain = reg.gauge(
            "serving_slo_attainment_ratio",
            "fraction of terminated requests attaining all SLO "
            "objectives over the rolling window ('life' = since start)",
            labelnames=("engine", "window"))
        self._g_goodput = reg.gauge(
            "serving_slo_goodput_per_second",
            "requests per second meeting every SLO objective over the "
            "rolling window — DistServe's goodput, measured in-engine",
            labelnames=("engine", "window"))
        self._g_burn = reg.gauge(
            "serving_slo_burn_rate",
            "error-budget burn rate over the rolling window: violation "
            "fraction / (1 - availability); 1.0 spends the budget "
            "exactly at the allowed rate", labelnames=("engine", "window"))

    # -- write side ------------------------------------------------------
    def reset(self):
        """Drop the rolling/lifetime state (bench warmup boundary: the
        compile-time requests must not pollute the measured window).
        The registry counters rewind too — scrapers read it as a
        process reset."""
        with self._lock:
            self._events.clear()
            self._attained = 0
            self._violated = 0
            self._violated_by = {}
            self._start_t = time.monotonic()
            self._burn_cache = None
        self._c_attained.reset(0, **self._labels)
        for labels, _ in self._c_violated.collect():
            if labels.get("engine") == self.source_id:
                self._c_violated.reset(0, **labels)
        # the per-window gauges drop too: a scrape between reset and
        # the next snapshot() must not read warmup-era attainment/burn
        # against counters that say zero traffic
        for g in (self._g_attain, self._g_goodput, self._g_burn):
            for labels, _ in g.collect():
                if labels.get("engine") == self.source_id:
                    g.remove(**labels)

    def violations_of(self, req, cause) -> list:
        """The objectives ``req`` missed (empty = attained). ``cause``
        is the timeline's typed terminal cause; non-completion causes
        are themselves the violation."""
        if cause == "done":
            out = []
            s = self.slo
            if s.ttft_p99_s is not None:
                ttft = (req.first_token_time - req.submit_time
                        if req.first_token_time is not None else None)
                if ttft is None or ttft > s.ttft_p99_s:
                    out.append("ttft")
            if s.itl_p99_s is not None:
                itl = _req_itl_p99(req.token_times)
                if itl is not None and itl > s.itl_p99_s:
                    out.append("itl")
            if s.e2e_p99_s is not None and req.finish_time is not None:
                if req.finish_time - req.submit_time > s.e2e_p99_s:
                    out.append("e2e")
            return out
        return [cause]

    def observe(self, req, cause):
        """Record one terminated request (close-funnel, once per
        request). ``cancel`` outcomes are skipped entirely."""
        if cause == "cancel":
            return
        violated = self.violations_of(req, cause)
        now = time.monotonic()
        with self._lock:
            self._events.append((now, not violated))
            self._prune(now)
            if violated:
                self._violated += 1
                self._violated_by[violated[0]] = (
                    self._violated_by.get(violated[0], 0) + 1)
            else:
                self._attained += 1
            self._burn_cache = None   # new evidence: recompute on read
        if violated:
            self._c_violated.inc(engine=self.source_id,
                                 objective=violated[0])
        else:
            self._c_attained.inc(**self._labels)

    def _prune(self, now):
        horizon = now - self._max_window
        ev = self._events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    # -- read side -------------------------------------------------------
    def window_counts(self, window_s: float):
        """(attained, total) over the trailing ``window_s`` seconds."""
        now = time.monotonic()
        horizon = now - float(window_s)
        with self._lock:
            self._prune(now)
            total = att = 0
            for t, a in self._events:
                if t >= horizon:
                    total += 1
                    att += a
        return att, total

    def _window_stats(self, window_s: float, now=None):
        att, total = self.window_counts(window_s)
        now = now if now is not None else time.monotonic()
        elapsed = max(1e-9, min(float(window_s), now - self._start_t))
        budget = 1.0 - self.slo.availability
        burn = ((total - att) / total / budget) if total else 0.0
        return {"total": total, "attained": att,
                "attainment": (att / total) if total else None,
                "goodput_per_s": att / elapsed,
                "burn_rate": burn}

    @property
    def attained_total(self) -> int:
        with self._lock:
            return self._attained

    @property
    def violated_total(self) -> int:
        with self._lock:
            return self._violated

    def attainment(self) -> float | None:
        with self._lock:
            total = self._attained + self._violated
            return (self._attained / total) if total else None

    def goodput_per_s(self) -> float:
        """Attained requests/s over the SHORTEST window (the live
        number; the snapshot carries every window)."""
        return self._window_stats(min(self.slo.windows))["goodput_per_s"]

    def burn_rate(self, window_s: float | None = None) -> float:
        """Max burn rate across the windows — the routing/alerting
        scalar (the fastest-burning window dominates). Cached for a
        short TTL: the router reads this per replica per submit, and a
        full deque scan per window per routing decision would make
        routing cost grow with traffic history — 5 recomputes/s bounds
        it while staying fresh against window aging.

        ``window_s=`` reads ONE specific window fresh (no cache) — the
        r21 control plane steers on a chosen reaction horizon rather
        than whichever window happens to burn fastest."""
        if window_s is not None:
            return self._window_stats(float(window_s))["burn_rate"]
        now = time.monotonic()
        with self._lock:
            cached = self._burn_cache
            if cached is not None and now - cached[0] < 0.2:
                return cached[1]
        burn = max(self._window_stats(w)["burn_rate"]
                   for w in self.slo.windows)
        with self._lock:
            self._burn_cache = (now, burn)
        return burn

    def snapshot(self) -> dict:
        """JSON-able state for ``/slo``, ``stats()`` and bench rows;
        refreshes the attainment/goodput/burn gauges as it reads."""
        now = time.monotonic()
        with self._lock:
            attained, violated = self._attained, self._violated
            by_obj = dict(self._violated_by)
            elapsed = max(1e-9, now - self._start_t)
        total = attained + violated
        life = {"total": total, "attained": attained,
                "attainment": (attained / total) if total else None,
                "goodput_per_s": attained / elapsed,
                "burn_rate": ((violated / total
                               / (1.0 - self.slo.availability))
                              if total else 0.0)}
        windows = {LIFETIME_WINDOW: life}
        for w in self.slo.windows:
            windows[str(w)] = self._window_stats(w, now)
        for name, row in windows.items():
            labels = dict(self._labels, window=name)
            if row["attainment"] is not None:
                self._g_attain.set(row["attainment"], **labels)
            self._g_goodput.set(row["goodput_per_s"], **labels)
            self._g_burn.set(row["burn_rate"], **labels)
        return {"configured": True, "source": self.source_id,
                "objectives": self.slo.objectives(),
                "availability": self.slo.availability,
                "attained_total": attained, "violated_total": violated,
                "violated_by_objective": by_obj,
                "attainment": life["attainment"],
                # the headline goodput is the SHORTEST rolling window's
                # (the live rate the docs promise — an engine idle for
                # an hour reads 0, not its lifetime average, which
                # stays available under windows["life"])
                "goodput_per_s": windows[str(min(self.slo.windows))]
                ["goodput_per_s"],
                # the alerting scalar maxes over the ROLLING windows
                # only: lifetime violations never age out, and a burn
                # rate that can never recover alerts forever
                "burn_rate": max(windows[str(w)]["burn_rate"]
                                 for w in self.slo.windows),
                "windows": windows}


__all__ = ["SLO", "SLOTracker", "LIFETIME_WINDOW"]
