"""The port's fixed-bucket `Histogram` and `bucket_quantile` against
paddle_tpu's (``paddle_tpu/observability/registry.py:153-300``), and
the serving engine's histograms.

On the same observations both packages' histograms hold the same
cumulative buckets, sum and count, and estimate the same quantiles;
`bucket_quantile` gives the reference's value on any cumulative counts.
The engine observes its TTFTs, queue waits, prefill and decode steps and
accepted drafts into the registry under the reference's names, one
child an engine: counts match its traffic, and the TTFT p50 the buckets
give lies within one bucket of the host's own median.
"""
import numpy as np
import pytest

from paddle_tpu.observability import registry as jreg
from paddle_tpu_torch.observability import (Histogram, MetricsRegistry,
                                            bucket_quantile, get_registry)
from paddle_tpu_torch.observability.registry import DEFAULT_LATENCY_BUCKETS
from paddle_tpu_torch.serving import Engine

import _torch_serving as ts

QS = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0)


def _observations(seed, n):
    rng = np.random.default_rng(seed)
    edges = np.asarray(DEFAULT_LATENCY_BUCKETS)
    return np.concatenate([rng.lognormal(-5, 2, n), edges[::3], [0.0, 1e3]])


@pytest.mark.parametrize("buckets", [None, (0, 1, 2, 3, 4, 6, 8, 12, 16),
                                     (0.0, 0.125, 0.5, 1.0)],
                         ids=["latency", "accept", "ratio"])
def test_histogram_matches_reference(buckets):
    mine = Histogram("h", labelnames=("engine",), buckets=buckets)
    ref = jreg.Histogram("h", labelnames=("engine",), buckets=buckets)
    assert mine.edges == ref.edges
    xs = _observations(3, 200)
    if buckets is not None:
        xs = np.random.default_rng(4).integers(0, 20, 300) * (
            buckets[-1] / 16)
    for i, x in enumerate(xs):
        for h in (mine, ref):
            h.observe(x, engine=f"e{i % 2}")
    for e in ("e0", "e1"):
        cum, total, count = mine.child(engine=e)
        rcum, rtotal, rcount = ref.child(engine=e)
        assert cum == rcum and count == rcount
        assert total == pytest.approx(rtotal, rel=1e-12)
        for q in QS:
            assert mine.quantile(q, engine=e) == ref.quantile(q, engine=e)
    assert mine.quantile(0.5, engine="nobody") is None
    got = sorted(mine.collect(), key=lambda r: r[0]["engine"])
    want = sorted(ref.collect(), key=lambda r: r[0]["engine"])
    assert [(lab, v["buckets"], v["count"]) for lab, v in got] == [
        (lab, v["buckets"], v["count"]) for lab, v in want]


def test_bucket_quantile_matches_reference():
    rng = np.random.default_rng(7)
    edges = (0.001, 0.01, 0.1, 1.0)
    for _ in range(50):
        counts = rng.integers(0, 5, len(edges) + 1)
        cum = list(np.cumsum(counts))
        for q in QS:
            assert bucket_quantile(edges, cum, q) == \
                jreg.bucket_quantile(edges, cum, q)
    assert bucket_quantile(edges, [0] * 5, 0.5) is None
    with pytest.raises(ValueError):
        bucket_quantile(edges, [1] * 5, 1.5)


def test_registry_histograms_are_get_or_create_with_fixed_edges():
    reg = MetricsRegistry()
    h = reg.histogram("x_seconds", "x", labelnames=("engine",))
    assert reg.histogram("x_seconds", "x", labelnames=("engine",)) is h
    assert h.edges == jreg.DEFAULT_LATENCY_BUCKETS
    with pytest.raises(ValueError, match="bucket edges"):
        reg.histogram("x_seconds", "x", labelnames=("engine",),
                      buckets=(1, 2))
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("x_seconds", "x", labelnames=("engine",))
    with pytest.raises(ValueError, match="strictly sorted"):
        Histogram("y", buckets=(2, 1))


_, MODEL = ts.both_models(seed=61)
ROWS = ts.rows(67, (6, 4, 2, 8, 5, 7))


def test_engine_histograms_count_its_traffic():
    """Six requests on a speculative engine: one TTFT and one queue wait
    a request, one prefill an admission, one decode observation a step
    and one accept observation a drafting window, on the engine's own
    children; the bucketed TTFT p50 lies within one bucket of the host's
    median."""
    eng = Engine(MODEL, device="cpu", slots=2, max_len=24,
                 prefill_buckets=(8,), spec_k=2)
    hs = [eng.submit(r, max_new_tokens=6) for r in ROWS]
    for h in hs:
        h.result()
    m, s = eng.metrics, eng.stats()
    reg = get_registry()

    def count(name):
        return reg.get(name).child(engine=eng.engine_id)[2]

    assert count("serving_ttft_seconds") == len(ROWS)
    assert count("serving_queue_wait_seconds") == len(ROWS)
    assert count("serving_prefill_seconds") == s.prefill_steps == len(ROWS)
    assert count("serving_decode_step_seconds") == s.decode_steps
    windows = reg.get("serving_spec_accept_tokens").child(
        engine=eng.engine_id)
    assert windows[1] == s.spec_accepted_tokens
    h = reg.get("serving_ttft_seconds")
    p50 = h.quantile(0.5, engine=eng.engine_id)
    assert p50 == s.ttft_hist_p50
    host = float(np.median(m.ttft_s))
    edges = (0.0,) + h.edges
    i = next(i for i, e in enumerate(h.edges) if host <= e)
    assert edges[max(0, i - 1)] <= p50 <= edges[min(len(edges) - 1, i + 1)]
    assert s.ttft_p99 >= p50
