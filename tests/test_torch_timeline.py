"""The port's request timelines, after ``tests/test_slo_timeline.py:
93-275`` (the flight recorder's and the SLO tracker's cases wait for
ROADMAP A9, the disaggregated transit for A10).

`Timeline`, `TimelineRing` and `cause_of` are host-only Python in both
packages: the same marks, clock readings and closes give the same
records. In the engine every request's timeline is monotone and closed
exactly once with its typed cause (done, cancel, shed, exhausted,
deadline), and the engine's ring keeps the recent and the worst; the
skewed deadline clock never enters a timeline. The engine serves
``gpt-test`` in float32 on numpy-seeded weights shared with paddle_tpu's
model.
"""
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

from paddle_tpu.serving import errors as jerrors
from paddle_tpu.serving import timeline as jtl
from paddle_tpu_torch.observability import get_sentinel
from paddle_tpu_torch.serving import (DeadlineExceededError, Engine,
                                      FaultInjector, OverloadedError,
                                      PoolExhaustedError)
from paddle_tpu_torch.serving import timeline as tl_mod
from paddle_tpu_torch.serving.timeline import (PHASES, TERMINAL_CAUSES,
                                               Timeline, TimelineRing,
                                               cause_of)

import _torch_serving as ts

_, MODEL = ts.both_models(seed=81)
MAX_NEW = 4
ROWS = ts.rows(93, (6, 4, 2, 8))


def _assert_complete(handle, cause, last_phase=None):
    """Closed with ``cause``, from submitted to one terminal mark, every
    offset monotone, every phase named, every duration >= 0."""
    tl = handle.timeline
    assert tl.closed and tl.terminal_cause == cause, (tl.terminal_cause,
                                                      cause)
    d = tl.as_dict(handle._req)
    names = [p["phase"] for p in d["phases"]]
    assert names[0] == "submitted" and names[-1] == "terminal"
    assert names.count("terminal") == 1
    assert all(n in PHASES for n in names)
    offs = [p["t_s"] for p in d["phases"]]
    assert offs == sorted(offs) and offs[0] == 0.0
    assert all(v >= 0 for v in d["durations_s"].values())
    assert d["terminal"] == cause
    if last_phase is not None:
        assert names[-2] == last_phase, names
    return d


# ---------------- host-only units ------------------------------------------

def _drive(mod):
    """The scripted marks of ``tests/test_slo_timeline.py:93-135``
    through one package's Timeline: a backwards clock clamped, a first
    close that wins, a mark after close ignored, same-phase re-entries
    collapsed."""
    tl = mod.Timeline(t0=100.0)
    tl.mark("queued", t=100.5)
    tl.mark("admitted", t=99.0)
    tl.mark("prefill", t=101.0)
    first = tl.close("done", t=100.2)
    second = tl.close("cancel")
    tl.mark("decode")
    tl2 = mod.Timeline(t0=0.0)
    tl2.mark("queued", t=1.0)
    tl2.mark("queued", t=2.0, requeue=True)
    tl2.mark("queued", t=3.0)
    tl2.mark("admitted", t=4.0)
    tl2.mark("queued", t=5.0)
    return (first, second, tl.marks(), tl.durations(), tl.terminal_cause,
            tl2.marks(), tl2.durations())


def test_timeline_monotone_clamp_close_once_and_cause_map():
    got, want = _drive(tl_mod), _drive(jtl)
    assert got == want
    first, second, marks, dur, cause, marks2, dur2 = got
    assert first and not second and cause == "done"
    assert dur["queued"] == 0.0 and all(v >= 0 for v in dur.values())
    assert [p for p, _, _ in marks] == ["submitted", "queued", "admitted",
                                        "prefill", "terminal"]
    assert [p for p, _, _ in marks2] == ["submitted", "queued", "admitted",
                                         "queued"]
    assert marks2[1][2]["visits"] == 3 and marks2[1][2]["requeue"] is True
    with pytest.raises(ValueError):
        Timeline().mark("not_a_phase")
    with pytest.raises(ValueError):
        Timeline().close("not_a_cause")
    assert PHASES == jtl.PHASES and TERMINAL_CAUSES == jtl.TERMINAL_CAUSES
    for state, err, ref_err in (
            ("finished", None, None), ("cancelled", None, None),
            ("cancelled", DeadlineExceededError("x"),
             jerrors.DeadlineExceededError("x")),
            ("cancelled", OverloadedError("x"), jerrors.OverloadedError("x")),
            ("cancelled", PoolExhaustedError("x"),
             jerrors.PoolExhaustedError("x")),
            ("cancelled", RuntimeError("x"), RuntimeError("x"))):
        assert cause_of(state, err) == jtl.cause_of(state, ref_err)
    assert cause_of("cancelled", DeadlineExceededError("x")) == "deadline"
    assert cause_of("cancelled", RuntimeError("x")) == "engine_death"


def test_timeline_ring_keeps_recent_and_worst_exemplars():
    snaps = []
    for mod in (tl_mod, jtl):
        ring = mod.TimelineRing(recent=3, worst=2)
        for i, total in enumerate([0.1, 5.0, 0.2, 3.0, 0.05]):
            tl = mod.Timeline(t0=0.0)
            tl.mark("queued", t=0.0)
            tl.close("done", t=total)
            ring.record(SimpleNamespace(timeline=tl, rid=i, prompt_len=4,
                                        max_new_tokens=2, emitted=[1, 2],
                                        deadline_s=None))
        snaps.append(ring.snapshot())
    snap = snaps[0]
    assert snap == snaps[1]
    assert snap["recorded"] == 5
    assert [r["request_id"] for r in snap["recent"]] == [2, 3, 4]
    assert [r["request_id"] for r in snap["worst"]] == [1, 3]
    assert [r["total_s"] for r in snap["worst"]] == [5.0, 3.0]
    assert json.dumps(snap)
    assert isinstance(TimelineRing(), TimelineRing)


# ---------------- terminal causes on one engine ----------------------------

def test_timeline_done_cancel_shed_exhausted_armed_pool_drains():
    """One paged engine under the armed sentinel: completed, cancelled,
    shed and pool-exhausted requests each end with a complete monotone
    timeline of their typed cause, the ring keeps them, decode builds
    once and the pool drains."""
    inj = FaultInjector()
    eng = Engine(MODEL, slots=1, max_len=32, prefill_buckets=(8,),
                 kv_mode="paged", page_size=4, max_queue=2,
                 shed_policy="shed_newest", admission_retries=1,
                 fault_injector=inj, device="cpu")
    w = eng.submit(ROWS[0], max_new_tokens=2)
    eng.run_until_idle()
    w.result()
    with get_sentinel().armed():
        h = eng.submit(ROWS[0], max_new_tokens=MAX_NEW)
        assert len(h.result(timeout=20.0)) == MAX_NEW
        d = _assert_complete(h, "done", last_phase="decode")
        assert [p["phase"] for p in d["phases"]] == [
            "submitted", "queued", "admitted", "prefill", "decode",
            "terminal"]
        assert d["tokens_emitted"] == MAX_NEW
        assert h.done() and h.state == "finished" and h.ttft > 0

        hc = eng.submit(ROWS[1], max_new_tokens=MAX_NEW)
        hc.cancel()
        _assert_complete(hc, "cancel", last_phase="queued")

        a = eng.submit(ROWS[0], max_new_tokens=MAX_NEW)
        eng.step()                               # a takes the slot
        b = eng.submit(ROWS[1], max_new_tokens=MAX_NEW)
        c = eng.submit(ROWS[2], max_new_tokens=MAX_NEW)   # queue full
        v = eng.submit(ROWS[3], max_new_tokens=MAX_NEW)   # shed
        with pytest.raises(OverloadedError):
            v.result(timeout=20.0)
        _assert_complete(v, "shed")
        for hh in (a, b, c):
            hh.result(timeout=20.0)
            _assert_complete(hh, "done", last_phase="decode")

        inj.add("reserve_fail")
        he = eng.submit(ROWS[0], max_new_tokens=MAX_NEW)
        with pytest.raises(PoolExhaustedError):
            he.result(timeout=20.0)
        _assert_complete(he, "exhausted", last_phase="queued")
    assert eng.stats().decode_traces == 1
    ts.assert_pool_whole(eng)
    ring = eng.timelines.snapshot()
    assert ring["recorded"] == 8                 # the warm-up + 7
    assert {r["terminal"] for r in ring["recent"]} >= {
        "done", "cancel", "shed", "exhausted"}
    assert ring["worst"][0]["total_s"] == max(r["total_s"]
                                              for r in ring["worst"])
    eng.close()


def test_timeline_deadline_queued_and_mid_decode_under_clock_skew():
    """Deadline terminals: expired in the queue it ends from ``queued``,
    forced mid-decode by a clock skew from ``decode``; the skewed clock
    does not reach the timeline (every phase stays >= 0 and the whole
    record short)."""
    inj = FaultInjector().add("clock_skew", skew_s=1e6, at_step=2)
    eng = Engine(MODEL, slots=1, max_len=32, prefill_buckets=(8,),
                 kv_mode="paged", page_size=4, fault_injector=inj,
                 device="cpu")
    hq = eng.submit(ROWS[0], max_new_tokens=8, deadline_s=120.0)
    hd = eng.submit(ROWS[1], max_new_tokens=MAX_NEW, deadline_s=1e-4)
    time.sleep(0.002)
    with pytest.raises(DeadlineExceededError, match="while queued"):
        hd.result(timeout=20.0)
    _assert_complete(hd, "deadline", last_phase="queued")
    with pytest.raises(DeadlineExceededError, match="mid-decode"):
        hq.result(timeout=20.0)
    d = _assert_complete(hq, "deadline", last_phase="decode")
    assert d["total_s"] < 60.0
    eng.run_until_idle()
    ts.assert_pool_whole(eng)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(ROWS[0], max_new_tokens=2)


def test_timeline_phase_durations_sum_to_the_whole():
    """The per-phase durations of a finished request add up to its
    end-to-end time, and its TTFT lies inside it."""
    eng = Engine(MODEL, slots=2, max_len=16, prefill_buckets=(8,),
                 device="cpu")
    hs = [eng.submit(r, max_new_tokens=MAX_NEW) for r in ROWS[:3]]
    for h in hs:
        h.result()
        d = _assert_complete(h, "done", last_phase="decode")
        assert abs(sum(d["durations_s"].values()) - d["total_s"]) < 1e-5
        assert 0 < h.ttft <= h.timeline.total_s() + 1e-9
    assert np.isclose(sorted(x.ttft for x in hs)[1],
                      np.median(eng.metrics.ttft_s))
