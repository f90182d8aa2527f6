"""The port's serving resilience, after the Engine-level cases of
``tests/test_resilience.py:73-410`` (the cluster's watchdog, handoff and
failover cases wait for ROADMAP A10).

The contract: every submitted request ends in bounded time, with its
tokens, a typed error or a deadline expiry, under any single fault that
`FaultInjector` fires at an exact step or request (a step error, a step
hang, a reservation that finds the pool exhausted, a skewed deadline
clock), and after each the page pool is empty again. The engine serves
``gpt-test`` in float32 on numpy-seeded weights shared with paddle_tpu's
model, and the requests that finish give the reference's greedy tokens
(one-shot generate); deadlines, bounded admission and an idle injector
configured but never triggered change no token and build nothing more
(``decode_traces == 1`` under the armed sentinel). The cases that hang a
step or crash one mid-traffic run the engine's background loop
(`Engine.start`, ``with eng:``).
"""
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu_torch.observability import get_registry, get_sentinel
from paddle_tpu_torch.serving import (DeadlineExceededError, Engine,
                                      FaultInjector, InjectedFault,
                                      OverloadedError, PoolExhaustedError)

import _torch_serving as ts

JAX_MODEL, MODEL = ts.both_models(seed=81)
MAX_NEW = 4


def _ref_row(row, mn=MAX_NEW):
    return np.asarray(JAX_MODEL.generate(paddle.to_tensor(row[None, :]),
                                         max_new_tokens=mn)._value)[0]


ROWS = ts.rows(93, (6, 4, 2, 8))
REFS = [_ref_row(r) for r in ROWS]


def _engine(**kw):
    return Engine(MODEL, device="cpu", **kw)


def _counter_value(name, **labels):
    metric = get_registry().get(name)
    return 0 if metric is None else metric.value(**labels)


# ---------------- deadlines ------------------------------------------------

def test_deadline_expired_in_queue_fails_before_reserving_pages():
    """A request whose deadline passes while it waits for a slot fails
    typed at the next step: no page was reserved for it, the slot holder
    is untouched and the pool drains."""
    eng = _engine(slots=1, max_len=12, prefill_buckets=(8,),
                  kv_mode="paged", page_size=4)
    h1 = eng.submit(ROWS[0], max_new_tokens=MAX_NEW)
    h2 = eng.submit(ROWS[1], max_new_tokens=MAX_NEW, deadline_s=1e-4)
    time.sleep(0.002)
    with pytest.raises(DeadlineExceededError, match="while queued"):
        h2.result(timeout=10.0)
    assert h2.partial == []
    np.testing.assert_array_equal(np.asarray(h1.result(timeout=10.0)),
                                  REFS[0])
    s = eng.stats()
    assert s.deadline_exceeded == 1 and s.completed == 1
    ts.assert_pool_whole(eng)
    assert _counter_value("serving_deadline_exceeded_total",
                          engine=eng.engine_id) == 1
    assert h2.timeline.phases() == ["submitted", "queued", "terminal"]


def test_deadline_mid_decode_keeps_partial_tokens_and_frees_pages():
    """A clock skew from decode step 2 expires a far deadline
    mid-decode: the handle fails typed after streaming the tokens so far
    (on ``.partial``), the slot is freed and every page returns."""
    inj = FaultInjector().add("clock_skew", skew_s=1e6, at_step=2)
    eng = _engine(slots=1, max_len=32, prefill_buckets=(8,),
                  kv_mode="paged", page_size=4, fault_injector=inj)
    h = eng.submit(ROWS[0], max_new_tokens=8, deadline_s=120.0)
    got = []
    with pytest.raises(DeadlineExceededError, match="mid-decode"):
        for tok in h.tokens(timeout=10.0):
            got.append(tok)
    assert got == h.partial and 1 <= len(got) < 8
    np.testing.assert_array_equal(got, _ref_row(ROWS[0], 8)[:len(got)])
    eng.run_until_idle()
    ts.assert_pool_whole(eng)
    assert eng.stats().deadline_exceeded == 1


# ---------------- bounded admission / shedding -----------------------------

def test_max_queue_refuse_raises_overloaded_at_submit():
    eng = _engine(slots=1, max_len=12, prefill_buckets=(8,), max_queue=1)
    a = eng.submit(ROWS[0], max_new_tokens=MAX_NEW)
    eng.step()                       # a takes the slot; the queue empties
    b = eng.submit(ROWS[1], max_new_tokens=MAX_NEW)   # fills the queue
    with pytest.raises(OverloadedError, match="refuse"):
        eng.submit(ROWS[2], max_new_tokens=MAX_NEW)
    assert eng.saturated
    np.testing.assert_array_equal(np.asarray(a.result(timeout=10.0)),
                                  REFS[0])
    np.testing.assert_array_equal(np.asarray(b.result(timeout=10.0)),
                                  REFS[1])
    s = eng.stats()
    assert s.shed == 1 and s.completed == 2 and not eng.saturated
    assert _counter_value("serving_shed_total", engine=eng.engine_id,
                          policy="refuse") == 1


def test_shed_policies_select_documented_victims():
    """shed_newest fails the arriving request; shed_closest_deadline
    fails whichever of the queued and incoming requests is nearest its
    deadline."""
    eng = _engine(slots=1, max_len=12, prefill_buckets=(8,), max_queue=1,
                  shed_policy="shed_newest")
    a = eng.submit(ROWS[0], max_new_tokens=MAX_NEW)
    eng.step()
    eng.submit(ROWS[1], max_new_tokens=MAX_NEW)
    c = eng.submit(ROWS[2], max_new_tokens=MAX_NEW)   # the newest: shed
    with pytest.raises(OverloadedError, match="shed_newest"):
        c.result(timeout=10.0)
    np.testing.assert_array_equal(np.asarray(a.result(timeout=10.0)),
                                  REFS[0])
    assert eng.stats().shed == 1
    assert _counter_value("serving_shed_total", engine=eng.engine_id,
                          policy="shed_newest") == 1
    assert c.timeline.terminal_cause == "shed"

    eng2 = _engine(slots=1, max_len=12, prefill_buckets=(8,), max_queue=1,
                   shed_policy="shed_closest_deadline")
    eng2.submit(ROWS[0], max_new_tokens=MAX_NEW, deadline_s=60.0)
    eng2.step()
    v = eng2.submit(ROWS[1], max_new_tokens=MAX_NEW, deadline_s=0.5)
    w = eng2.submit(ROWS[2], max_new_tokens=MAX_NEW, deadline_s=60.0)
    with pytest.raises(OverloadedError, match="shed_closest_deadline"):
        v.result(timeout=10.0)
    np.testing.assert_array_equal(np.asarray(w.result(timeout=10.0)),
                                  REFS[2])
    assert eng2.stats().shed == 1 and eng2.stats().deadline_exceeded == 0


def test_infeasible_policy_refuses_doomed_deadlines_once_priced():
    """``shed_policy="infeasible"`` prices service from the phase
    histograms: a no-op while they hold fewer than 8 observations, then
    a deadline far below the priced prefill plus decode is refused at
    submit, typed, and a generous one admits."""
    from paddle_tpu_torch.serving import InfeasibleDeadlineError

    eng = _engine(slots=1, max_len=12, prefill_buckets=(8,),
                  shed_policy="infeasible")
    h = eng.submit(ROWS[0], max_new_tokens=MAX_NEW, deadline_s=1e-9)
    assert eng.scheduler.queue_depth == 1       # no evidence: admitted
    h.cancel()
    for r in ROWS * 2:
        eng.submit(r, max_new_tokens=MAX_NEW).result()
    with pytest.raises(InfeasibleDeadlineError, match="cannot meet"):
        eng.submit(ROWS[1], max_new_tokens=MAX_NEW, deadline_s=1e-9)
    ok = eng.submit(ROWS[1], max_new_tokens=MAX_NEW, deadline_s=600.0)
    np.testing.assert_array_equal(np.asarray(ok.result()), REFS[1])
    assert eng.stats().shed == 1
    assert _counter_value("serving_shed_total", engine=eng.engine_id,
                          policy="infeasible") == 1


# ---------------- injected step faults -------------------------------------

def test_injected_step_error_fails_every_handle_and_drains_pool():
    """A step crash on the background thread fails the in-flight handle
    with the cause and the queued one too: nobody hangs, every page
    returns."""
    inj = FaultInjector()
    eng = _engine(slots=1, max_len=12, prefill_buckets=(8,),
                  kv_mode="paged", page_size=4, fault_injector=inj)
    w = eng.submit(ROWS[0], max_new_tokens=2)
    eng.run_until_idle()
    w.result()                        # built before the fault arms
    inj.add("step_error")             # the next decode dispatch raises
    h1 = eng.submit(ROWS[0], max_new_tokens=MAX_NEW)
    h2 = eng.submit(ROWS[1], max_new_tokens=MAX_NEW)
    with eng:
        with pytest.raises(RuntimeError, match="failed while request"):
            h1.result(timeout=10.0)
        with pytest.raises(RuntimeError, match="failed while request"):
            h2.result(timeout=10.0)
    assert isinstance(h1._error, InjectedFault)
    assert not eng.alive and not eng.running
    assert eng.kv.pages_in_use == 0 and eng.kv.pages_free == \
        eng.kv.pages_total
    assert inj.pending() == 0
    assert h1.timeline.terminal_cause == "engine_death"


def test_exhaustion_retry_budget_fails_typed_not_livelocked():
    """A request that keeps finding the pool exhausted fails with a
    typed `PoolExhaustedError` naming the pages it needs once its retry
    budget is spent; the engine serves on."""
    inj = FaultInjector().add("reserve_fail", times=3)
    eng = _engine(slots=1, max_len=32, prefill_buckets=(8,),
                  kv_mode="paged", page_size=4, fault_injector=inj,
                  admission_retries=3)
    h = eng.submit(ROWS[0], max_new_tokens=3)
    with pytest.raises(PoolExhaustedError, match=r"needed 3 KV pages"):
        h.result(timeout=20.0)
    assert eng.alive
    assert eng.kv.pages_in_use == 0
    assert eng.stats().kv_pages_exhausted == 3
    assert h.timeline.terminal_cause == "exhausted"
    h2 = eng.submit(ROWS[1], max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(np.asarray(h2.result(timeout=10.0)),
                                  REFS[1])


def test_exhaustion_requeue_recovers_within_budget():
    """Two forced failures still recover inside the default budget."""
    inj = FaultInjector().add("reserve_fail", times=2)
    eng = _engine(slots=1, max_len=32, prefill_buckets=(8,),
                  kv_mode="paged", page_size=4, fault_injector=inj)
    h = eng.submit(ROWS[0], max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(np.asarray(h.result(timeout=20.0)),
                                  REFS[0])
    assert eng.stats().kv_pages_exhausted == 2
    ts.assert_pool_whole(eng)
    # the bounces show as one queued phase visited again
    phases = h.timeline.phases()
    assert phases[:2] == ["submitted", "queued"] and phases[-1] == "terminal"


# ---------------- client-side bounded waits --------------------------------

def test_handle_waits_are_bounded_on_a_wedged_engine():
    """``result(timeout=)`` raises TimeoutError while a background engine
    is wedged in a step (an injected 1.5 s hang) without failing its
    handles; the stream resumes once the hang ends."""
    inj = FaultInjector()
    eng = _engine(slots=1, max_len=12, prefill_buckets=(8,),
                  fault_injector=inj)
    w = eng.submit(ROWS[0], max_new_tokens=2)
    eng.run_until_idle()
    w.result()
    inj.add("step_hang", sleep_s=1.5)
    with eng:
        h = eng.submit(ROWS[0], max_new_tokens=MAX_NEW)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="no token"):
            h.result(timeout=0.2)
        assert time.monotonic() - t0 < 1.0
        np.testing.assert_array_equal(
            np.asarray(h.result(timeout=20.0)), REFS[0])
    assert eng.alive and not eng.running


# ---------------- fault-free parity ----------------------------------------

def test_fault_free_runs_untouched_with_resilience_configured():
    """Deadlines, bounded admission and an idle injector configured but
    never triggered change no token and build nothing more."""
    inj = FaultInjector()
    eng = _engine(slots=2, max_len=12, prefill_buckets=(8,),
                  kv_mode="paged", page_size=4, default_deadline_s=300.0,
                  max_queue=64, shed_policy="shed_closest_deadline",
                  fault_injector=inj, engine_id="resilient")
    with get_sentinel().armed():
        for order in ([0, 1, 2, 3], [3, 2, 1, 0]):
            handles = [(i, eng.submit(ROWS[i], max_new_tokens=MAX_NEW))
                       for i in order]
            for i, h in handles:
                np.testing.assert_array_equal(
                    np.asarray(h.result(timeout=20.0)), REFS[i],
                    err_msg=f"order {order}, request {i}")
    s = eng.stats()
    assert s.decode_traces == 1 and s.completed == 8
    assert s.deadline_exceeded == 0 and s.shed == 0
    assert s.est_queue_delay_s == 0.0
    assert s.engine_id == eng.engine_id == "resilient"
    ts.assert_pool_whole(eng)
