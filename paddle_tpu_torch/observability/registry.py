"""The port's metrics registry, reduced to what the recompile sentinel,
the train step and the serving engine write.

Counterpart: ``paddle_tpu/observability/registry.py``. There one
thread-safe registry holds labeled counters, gauges and histograms with
a JSON snapshot and Prometheus exposition. Here only its get-or-create
table and the labeled `Counter` are ported, for the family the sentinel
bumps, ``xla_traces_total{executable=}``
(``paddle_tpu/observability/sentinel.py:74-79``, one count per graph
capture of a named step), and the train step's ``train_steps_total``
and ``train_tokens_total`` (``paddle_tpu/distributed/spmd.py:406-414``),
and the serving engine's prefix-cache and chunked-prefill families
(``serving_prefix_hits_total``, ``serving_prefix_tokens_saved_total``,
``serving_prefill_chunk_steps_total`` and the gauge
``serving_prefill_chunk_active``, ``paddle_tpu/serving/metrics.py:
174-193, 414-420``), each labeled by engine. The families keep the
reference's names so that ROADMAP A9 can port the rest of the registry
without renaming them. The fixed-bucket `Histogram` and its
`bucket_quantile` (``registry.py:153-257``) carry the serving engine's
latency and size distributions (prefill, decode step, queue wait, TTFT,
accepted drafts, chunk tokens and piggyback share,
``paddle_tpu/serving/metrics.py:245-310``).
"""
from __future__ import annotations

import threading

#: default latency bucket edges (seconds), the reference's: sub-ms decode
#: steps on small models through multi-second prefills
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


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


class Gauge(Counter):
    """A value that is set, one child per label-value tuple
    (``registry.py:125-160``)."""

    kind = "gauge"

    def set(self, value, **labels):
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)


def bucket_quantile(edges, cum_buckets, q):
    """The ``q``-quantile (``q`` in [0, 1]) estimated from cumulative
    bucket counts (``registry.py:162-191``): ``cum_buckets`` has
    ``len(edges) + 1`` entries, the +Inf bucket last. Linear
    interpolation inside the bucket that holds the rank, the first bucket
    from 0; a rank in the +Inf bucket clamps to the top finite edge.
    None when the histogram is empty."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    total = cum_buckets[-1]
    if total == 0:
        return None
    rank = q * total
    i = next(i for i, c in enumerate(cum_buckets) if c >= rank)
    if i == len(edges):
        return float(edges[-1])
    lo = float(edges[i - 1]) if i > 0 else 0.0
    hi = float(edges[i])
    prev = cum_buckets[i - 1] if i > 0 else 0
    in_bucket = cum_buckets[i] - prev
    if in_bucket == 0:
        return hi
    return lo + (hi - lo) * (rank - prev) / in_bucket


class Histogram:
    """A fixed-bucket histogram in Prometheus's cumulative form, one
    child per label-value tuple (``registry.py:194-257``): an
    observation is an add to the first bucket whose edge holds it (or
    the +Inf bucket), to the sum and to the count; `quantile` estimates
    from the buckets through `bucket_quantile`, to within a bucket's
    width."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        edges = tuple(float(e) for e in (buckets or DEFAULT_LATENCY_BUCKETS))
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(f"bucket edges must be strictly sorted: {edges}")
        self.edges = edges
        self._children: dict[tuple, list] = {}
        self._lock = threading.Lock()

    _key = Counter._key

    def observe(self, value, **labels):
        value = float(value)
        key = self._key(labels)
        i = next((i for i, e in enumerate(self.edges) if value <= e),
                 len(self.edges))
        with self._lock:
            c = self._children.get(key)
            if c is None:
                # bucket counts, then the sum and the count
                c = self._children[key] = [0] * (len(self.edges) + 1) + [
                    0.0, 0]
            c[i] += 1
            c[-2] += value
            c[-1] += 1

    def child(self, **labels):
        """``(cumulative bucket counts, sum, count)`` of one child."""
        key = self._key(labels)
        with self._lock:
            c = self._children.get(key)
            if c is None:
                return [0] * (len(self.edges) + 1), 0.0, 0
            cum, acc = [], 0
            for n in c[:-2]:
                acc += n
                cum.append(acc)
            return cum, c[-2], c[-1]

    def quantile(self, q, **labels):
        """The bucket-estimated ``q``-quantile of one child; None while
        it is empty."""
        cum, _, _ = self.child(**labels)
        return bucket_quantile(self.edges, cum, q)

    def collect(self) -> list:
        """``[(labels dict, {"buckets", "sum", "count"})]`` of every
        child."""
        with self._lock:
            keys = list(self._children)
        out = []
        for k in keys:
            labels = dict(zip(self.labelnames, k))
            cum, total, count = self.child(**labels)
            out.append((labels, {"buckets": cum, "sum": total,
                                 "count": count}))
        return out


class MetricsRegistry:
    """Thread-safe name -> metric table with get-or-create constructors
    (``registry.py:258-300``); counters, gauges and histograms."""

    def __init__(self):
        self._metrics: dict[str, Counter] = {}
        self._lock = threading.Lock()

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        m = self._get_or_create(Histogram, name, help, labelnames,
                                buckets=buckets)
        if buckets is not None and tuple(float(e)
                                         for e in buckets) != m.edges:
            raise ValueError(
                f"metric {name!r} already registered with bucket edges "
                f"{m.edges}, conflicting with requested {tuple(buckets)}")
        return m

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, **kw)
            elif type(m) is not cls or m.labelnames != tuple(labelnames):
                raise ValueError(f"metric {name!r} already registered as a "
                                 f"{m.kind} with labels {m.labelnames}")
            return m

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def collect(self, name) -> list:
        """``get(name).collect()``, a metric not registered yet reading
        as the empty list (``registry.py:297-306``)."""
        m = self.get(name)
        return m.collect() if m is not None else []


#: the process-wide default registry
_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS", "bucket_quantile", "get_registry"]
