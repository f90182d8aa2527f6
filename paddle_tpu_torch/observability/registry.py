"""The port's metrics registry: labeled counters, gauges and histograms
in one thread-safe table, with its JSON view and Prometheus text.

Counterpart: ``paddle_tpu/observability/registry.py``. One registry
holds every family the port writes: the recompile sentinel's
``xla_traces_total{executable=}`` (one count per graph capture of a
named step), the train step's and the serving engine's families, the
SLO tracker's, the flight recorder's and the process sampler's, each
under the reference's name, so a dashboard built for one package reads
the other. `MetricsRegistry.snapshot` is the JSON-able view
(``registry.py:316``) and `MetricsRegistry.to_prometheus` the text
exposition format 0.0.4 (``registry.py:340``) the ``/metrics`` endpoint
serves. The fixed-bucket `Histogram` and its `bucket_quantile`
(``registry.py:153-257``) carry the latency and size distributions.
Dependency-free: importing it touches no device.
"""
from __future__ import annotations

import json
import math
import threading
import weakref

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

    def reset(self, value=0, **labels):
        """Rewind one child to ``value`` (``registry.py:109-117``): an
        explicit reset, which scrape tooling reads as a process reset."""
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def clear(self):
        """Drop every child."""
        with self._lock:
            self._children.clear()

    def remove(self, **labels):
        """Drop one labeled child: the series leaves the exposition until
        something sets it again (``registry.py:75-83``)."""
        key = self._key(labels)
        with self._lock:
            self._children.pop(key, None)

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

    def inc(self, amount=1, **labels):
        """Add ``amount`` (either sign) to the child."""
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def dec(self, amount=1, **labels):
        self.inc(-amount, **labels)


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
    clear = Counter.clear
    remove = Counter.remove

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
        #: weak references to the bound methods `add_collector` took
        self._collectors: list = []

    def add_collector(self, method):
        """Call the bound ``method`` before every read (`collect`,
        `snapshot`, `to_prometheus`), so an owner that keeps its counts
        in plain fields publishes them when they are read rather than
        as they move. Held weakly: a collected owner drops out."""
        with self._lock:
            self._collectors.append(weakref.WeakMethod(method))

    def _run_collectors(self):
        with self._lock:
            refs = list(self._collectors)
        dead = False
        for ref in refs:
            fn = ref()
            if fn is None:
                dead = True
            else:
                fn()
        if dead:
            with self._lock:
                self._collectors = [r for r in self._collectors
                                    if r() is not None]

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
        self._run_collectors()
        m = self.get(name)
        return m.collect() if m is not None else []

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def reset(self):
        """Drop every metric and collector (test isolation only)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()

    def snapshot(self) -> dict:
        """Every metric as one JSON-able dict (``registry.py:316-338``):
        ``{name: {"type", "help", "labelnames", "values": [{"labels",
        "value"} or {"labels", "buckets", "sum", "count"}]}}``, with a
        histogram's ``edges``."""
        self._run_collectors()
        with self._lock:
            metrics = list(self._metrics.values())
        out = {}
        for m in metrics:
            entry = {"type": m.kind, "help": m.help,
                     "labelnames": list(m.labelnames), "values": []}
            if isinstance(m, Histogram):
                entry["edges"] = list(m.edges)
                for labels, agg in m.collect():
                    entry["values"].append({"labels": labels, **agg})
            else:
                for labels, v in m.collect():
                    entry["values"].append({"labels": labels, "value": v})
            out[m.name] = entry
        return out

    def to_json(self, **dump_kw) -> str:
        return json.dumps(self.snapshot(), **dump_kw)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4 of the whole registry
        (``registry.py:340-365``): a counter under its ``_total`` name as
        written, a histogram as ``_bucket{le=}``, ``_sum`` and
        ``_count`` series."""
        lines = []
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for labels, agg in m.collect():
                    for le, n in zip(list(m.edges) + [math.inf],
                                     agg["buckets"]):
                        lines.append(_series(
                            f"{m.name}_bucket",
                            {**labels, "le": _fmt_value(le)}, n))
                    lines.append(_series(f"{m.name}_sum", labels,
                                         agg["sum"]))
                    lines.append(_series(f"{m.name}_count", labels,
                                         agg["count"]))
            else:
                for labels, v in m.collect():
                    lines.append(_series(m.name, labels, v))
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_value(v):
    if v != v:
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _escape(v):
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _series(name, labels, value):
    if labels:
        body = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
        return f"{name}{{{body}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


#: the process-wide default registry
_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS", "bucket_quantile", "get_registry"]
