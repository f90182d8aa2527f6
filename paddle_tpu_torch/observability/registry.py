"""The port's metrics registry, reduced to what the recompile sentinel
writes.

Counterpart: ``paddle_tpu/observability/registry.py``. There one
thread-safe registry holds labeled counters, gauges and histograms with
a JSON snapshot and Prometheus exposition. Here only its get-or-create
table and the labeled `Counter` are ported, for the family the sentinel
bumps, ``xla_traces_total{executable=}``
(``paddle_tpu/observability/sentinel.py:74-79``, one count per graph
capture of a named step), and the train step's ``train_steps_total``
and ``train_tokens_total`` (``paddle_tpu/distributed/spmd.py:406-414``).
The families keep the reference's names so that ROADMAP A9 can port the
rest of the registry without renaming them.
"""
from __future__ import annotations

import threading


class Counter:
    """A monotone counter with one child per label-value tuple
    (``registry.py:94-122``)."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def _key(self, labels) -> tuple:
        extra = set(labels) - set(self.labelnames)
        if extra:
            raise ValueError(f"unknown label(s) {sorted(extra)}; declared: "
                             f"{self.labelnames}")
        return tuple(str(labels.get(n, "")) for n in self.labelnames)

    def inc(self, amount=1, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        """The child's count (0 before its first ``inc``)."""
        key = self._key(labels)
        with self._lock:
            return self._children.get(key, 0.0)

    def collect(self) -> list:
        """``[(labels dict, value)]`` of every child."""
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, k)), v) for k, v in items]


class MetricsRegistry:
    """Thread-safe name -> metric table with get-or-create constructors
    (``registry.py:258-300``); counters only."""

    def __init__(self):
        self._metrics: dict[str, Counter] = {}
        self._lock = threading.Lock()

    def counter(self, name, help="", labelnames=()) -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help, labelnames)
            elif m.labelnames != tuple(labelnames):
                raise ValueError(f"metric {name!r} already registered with "
                                 f"labels {m.labelnames}")
            return m

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)


#: the process-wide default registry
_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


__all__ = ["Counter", "MetricsRegistry", "get_registry"]
