"""The port's background serving mode (``paddle_tpu/serving/engine.py:
1009-1160``, ``request.py:263-345``).

`Engine.start` (or ``with Engine(...) as eng:``) steps the engine on a
daemon thread; a handle whose engine runs waits on its own stream
instead of stepping it. Requests submitted from the main thread and
from several client threads while the loop runs give the cooperative
engine's greedy tokens (which equal paddle_tpu's engine's on the same
numpy-seeded weights), `stop` joins the thread and leaves the engine
usable cooperatively, and `close` fails every queued and in-flight
request with `EngineClosedError` as the cause and returns every page.
"""
import sys
import threading

import numpy as np
import pytest

from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch.observability import get_sentinel
from paddle_tpu_torch.serving import Engine, EngineClosedError

import _torch_serving as ts

JAX_MODEL, MODEL = ts.both_models(seed=53)
ROWS = ts.rows(59, (6, 4, 2, 8, 5, 3, 7, 1))
MAX_NEW = 5
KW = dict(slots=3, max_len=16, prefill_buckets=(8,), kv_mode="paged",
          page_size=4)


def _cooperative():
    eng = JaxEngine(JAX_MODEL, **KW)
    handles = [eng.submit(r, max_new_tokens=MAX_NEW) for r in ROWS]
    return [list(h.result()) for h in handles]


WANT = _cooperative()


def test_background_loop_streams_the_cooperative_tokens():
    eng = Engine(MODEL, device="cpu", **KW)
    with get_sentinel().armed():
        with eng:
            assert eng.running
            handles = [eng.submit(r, max_new_tokens=MAX_NEW) for r in ROWS]
            streamed = [list(h.tokens(timeout=30.0)) for h in handles]
        assert not eng.running and eng._thread is None
    assert streamed == WANT
    assert [h.result() for h in handles] == WANT
    s = eng.stats()
    assert s.decode_traces == 1 and s.completed == len(ROWS)
    ts.assert_pool_whole(eng)
    # stopped, the engine serves cooperatively again
    assert eng.submit(ROWS[0], max_new_tokens=MAX_NEW).result() == WANT[0]


def test_client_threads_submit_and_wait_while_the_loop_runs():
    """Sixteen client threads (more than the cores) submit, wait and
    read stats while the loop steps, with the interpreter switching
    threads every 10 us: every request gets its tokens, none is lost
    or counted twice, and every page returns."""
    eng = Engine(MODEL, device="cpu", **KW).start()
    n = 2 * len(ROWS)
    out = [None] * n
    interval = sys.getswitchinterval()

    def client(i):
        h = eng.submit(ROWS[i % len(ROWS)], max_new_tokens=MAX_NEW)
        eng.stats()
        out[i] = h.result(timeout=60.0)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n)]
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    eng.stop()
    assert out == WANT * 2
    s = eng.stats()
    assert s.submitted == s.completed == n
    ts.assert_pool_whole(eng)


def test_close_fails_queued_and_in_flight_requests_typed():
    eng = Engine(MODEL, device="cpu", **KW)
    handles = [eng.submit(r, max_new_tokens=MAX_NEW) for r in ROWS]
    eng.step()                       # three in flight, the rest queued
    assert eng.stats().active_slots == 3
    eng.close()
    for h in handles:
        with pytest.raises(RuntimeError, match="failed while request"):
            h.result(timeout=10.0)
        assert isinstance(h._error, EngineClosedError)
        assert h.timeline.terminal_cause == "engine_death"
    assert eng.kv.pages_in_use == 0 and eng.kv.pages_free == \
        eng.kv.pages_total
    eng.close()                      # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(ROWS[0], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="closed"):
        eng.start()


def test_close_stops_a_running_loop():
    eng = Engine(MODEL, device="cpu", **KW).start()
    h = eng.submit(ROWS[0], max_new_tokens=MAX_NEW)
    assert h.result(timeout=30.0) == WANT[0]
    eng.close()
    assert not eng.running and eng._thread is None and not eng.alive
    ts.assert_pool_whole(eng)
