"""Adaptive spec_k and draft-model speculation in the port's Engine, after
``tests/test_adaptive_spec.py:65-300``.

The controller (`AdaptiveSpecK`) and its ladder (`spec_k_ladder`) are
pure Python: on the same scripted observations the port's give the
reference's histories exactly. In the engine, ``Engine(spec_k=k0,
spec_adaptive=..., spec_k_max=m)`` moves k only between steps, across
verify steps all built at the first speculative decode, so a grow or a
shrink rebuilds nothing (``decode_traces == 1`` under the armed
sentinel); every slot budgets the ceiling ``spec_k_max``. Both engines
serve ``gpt-test`` in float32 on the same numpy-seeded weights with the
same drafters (an oracle from the reference's greedy stream, an
anti-oracle that is always wrong), and the port's greedy streams, k
histories and accept counts equal the reference engine's. Deadlines and
an injected step error compose with the ladder as with a fixed k: the
pool drains, and building the rungs consumes no scheduled fault.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.serving import AdaptiveSpecK as JaxAdaptiveSpecK
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import spec_k_ladder as jax_spec_k_ladder
from paddle_tpu_torch.observability import get_sentinel
from paddle_tpu_torch.serving import (AdaptiveSpecK, DeadlineExceededError,
                                      Engine, FaultInjector, spec_k_ladder)

import _torch_serving as ts

JAX_MODEL, MODEL = ts.both_models(seed=113)
PS = 4


def _ref_row(row, mn):
    """The reference's greedy continuation of ``row`` (one-shot
    generate)."""
    return np.asarray(JAX_MODEL.generate(paddle.to_tensor(row[None, :]),
                                         max_new_tokens=mn)._value)[0]


def _oracle(ref, prompt_len):
    def fn(ctx, k):
        done = len(ctx) - prompt_len
        return ref[done:done + k]
    return fn


def _anti_oracle(ref, prompt_len):
    def fn(ctx, k):
        done = len(ctx) - prompt_len
        nxt = int(ref[done]) if done < len(ref) else 0
        return [(nxt % 254) + 1] * k
    return fn


def _both(**kw):
    """(reference engine, port engine) built alike; a controller given
    as ``spec_adaptive`` is built once for each package from its
    arguments."""
    ctrl = kw.pop("ctrl", None)
    jkw, tkw = dict(kw), dict(kw)
    if ctrl is not None:
        jkw["spec_adaptive"] = JaxAdaptiveSpecK(ctrl[0], **ctrl[1])
        tkw["spec_adaptive"] = AdaptiveSpecK(ctrl[0], **ctrl[1])
    return JaxEngine(JAX_MODEL, **jkw), Engine(MODEL, device="cpu", **tkw)


# ---------------- controller units -----------------------------------------

@pytest.mark.parametrize("k0,k_max", [(2, 8), (3, 8), (4, 4), (1, 1),
                                      (5, 4), (0, 4)])
def test_spec_k_ladder_matches_reference(k0, k_max):
    try:
        want = jax_spec_k_ladder(k0, k_max)
    except ValueError:
        with pytest.raises(ValueError, match="k0"):
            spec_k_ladder(k0, k_max)
        return
    assert spec_k_ladder(k0, k_max) == want


def _script(c, obs):
    """Feed ``obs`` (``(drafted, accepted)`` or ``"decide"``) to a
    controller; returns every decision."""
    out = []
    for o in obs:
        if o == "decide":
            out.append(c.decide())
        else:
            c.observe(*o)
    return out


_SCRIPT = ([(2, 2), "decide", (2, 2), "decide", (4, 4), "decide", (4, 4),
            "decide"] + [(4, 0)] * 2 + ["decide"] + [(4, 0)] * 2
           + ["decide", (2, 0), (2, 0), "decide", (1, 0), (1, 0), "decide"]
           + [(2, 1), "decide"] * 8)


@pytest.mark.parametrize("cfg", [
    dict(rungs=(1, 2, 4), k0=2, window=4, min_obs=2, grow_frac=0.8,
         shrink_frac=0.25),
    dict(rungs=(1, 2), k0=1, window=2, min_obs=2, grow_frac=1.0,
         shrink_frac=0.0),
    dict(rungs=(1, 2, 4, 8), k0=2)], ids=["ladder3", "window2", "default"])
def test_adaptive_controller_history_matches_reference(cfg):
    """The scripted history of ``tests/test_adaptive_spec.py:76-130``
    (grow on a pressed k, shrink on collapse, clamping, a sliding window)
    through both packages' controllers: the same decisions and the same
    transition log."""
    rungs = cfg.pop("rungs")
    mine, ref = AdaptiveSpecK(rungs, **cfg), JaxAdaptiveSpecK(rungs, **cfg)
    assert _script(mine, _SCRIPT) == _script(ref, _SCRIPT)
    assert mine.history == ref.history and mine.k == ref.k
    for bad in (dict(rungs=()), dict(rungs=(2, 4), k0=3),
                dict(rungs=(2,), window=2, min_obs=3)):
        with pytest.raises(ValueError) as e_ref:
            JaxAdaptiveSpecK(**bad)
        with pytest.raises(ValueError) as e_mine:
            AdaptiveSpecK(**bad)
        assert str(e_mine.value) == str(e_ref.value)


def test_engine_adaptive_constructor_validation():
    for kw, match in ((dict(spec_k=4, spec_k_max=2), "spec_k_max"),
                      (dict(spec_k_max=4), "spec_k"),
                      (dict(spec_adaptive=True), "spec_adaptive")):
        with pytest.raises(ValueError, match=match):
            Engine(MODEL, slots=1, max_len=16, prefill_buckets=(8,),
                   device="cpu", **kw)
    with pytest.raises(ValueError, match="rungs"):
        Engine(MODEL, slots=1, max_len=24, prefill_buckets=(8,), spec_k=3,
               spec_adaptive=AdaptiveSpecK((2, 4), k0=2), device="cpu")


# ---------------- in-engine transitions under the armed sentinel -----------

@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_adaptive_grows_on_pressed_k_stays_armed_and_exact(mode):
    """An all-accepting oracle presses k: 2 -> 4 mid-request, the stream
    equals generate()'s, and the run holds ``decode_traces == 1`` under
    the armed sentinel (the k=4 rung was built up front); the k history
    and accept counts equal the reference engine's."""
    rng = np.random.default_rng(71)
    row = rng.integers(1, 255, (5,)).astype("int64")
    mn = 12
    ref = _ref_row(row, mn)
    kw = dict(kv_mode=mode) if mode == "slots" else dict(kv_mode=mode,
                                                         page_size=PS)
    jeng, eng = _both(slots=1, max_len=8 + mn + 4, prefill_buckets=(8,),
                      spec_k=2, spec_k_max=4,
                      ctrl=((2, 4), dict(k0=2, window=4, min_obs=2)),
                      draft_model=_oracle(ref, len(row)), **kw)
    want = jeng.submit(row, max_new_tokens=mn).result()
    with get_sentinel().armed():
        got = eng.submit(row, max_new_tokens=mn).result()
    np.testing.assert_array_equal(np.asarray(got), ref)
    assert got == list(want)
    s, js = eng.stats(), jeng.stats()
    assert s.decode_traces == 1
    assert s.spec_k == 4 and eng._spec_k == 4
    assert eng._spec_ctrl.history == jeng._spec_ctrl.history
    assert s.spec_k_history == tuple(eng._spec_k_history) \
        == js.spec_k_history
    assert s.spec_accept_rate == 1.0
    assert (s.spec_draft_tokens, s.decode_steps) == (js.spec_draft_tokens,
                                                     js.decode_steps)
    if mode == "paged":
        ts.assert_pool_whole(eng)


def test_adaptive_shrinks_on_collapse_down_the_ladder():
    """An always-wrong drafter walks k 4 -> 2 -> 1; every rollback stays
    exact and nothing is rebuilt."""
    rng = np.random.default_rng(73)
    row = rng.integers(1, 255, (5,)).astype("int64")
    mn = 12
    ref = _ref_row(row, mn)
    jeng, eng = _both(slots=1, max_len=8 + mn + 4, prefill_buckets=(8,),
                      kv_mode="paged", page_size=PS, spec_k=4,
                      ctrl=((1, 2, 4), dict(k0=4, window=4, min_obs=2)),
                      draft_model=_anti_oracle(ref, len(row)))
    want = jeng.submit(row, max_new_tokens=mn).result()
    with get_sentinel().armed():
        got = eng.submit(row, max_new_tokens=mn).result()
    np.testing.assert_array_equal(np.asarray(got), ref)
    assert got == list(want)
    s = eng.stats()
    assert s.decode_traces == 1 and eng._spec_k == 1
    assert [k for _, k in eng._spec_ctrl.history] == [2, 1]
    assert eng._spec_ctrl.history == jeng._spec_ctrl.history
    assert s.spec_accepted_greedy == 0 and s.spec_drafted_greedy > 0
    ts.assert_pool_whole(eng)


def test_adaptive_k_transition_spans_waiting_requests():
    """k moves between steps while another slot is mid-flight: two
    staggered requests ride a grow and both stay exact; the rungs built
    mid-traffic leave the live rows' outputs unchanged."""
    rng = np.random.default_rng(79)
    rows = [rng.integers(1, 255, (n,)).astype("int64") for n in (5, 3)]
    mn = 10
    refs = [_ref_row(r, mn) for r in rows]

    def oracle(ctx, k):
        for r, ref in zip(rows, refs):
            if len(ctx) >= len(r) and np.array_equal(ctx[:len(r)], r):
                done = len(ctx) - len(r)
                return ref[done:done + k]
        return []

    outs = []
    for eng in _both(slots=2, max_len=8 + mn + 4, prefill_buckets=(8,),
                     kv_mode="paged", page_size=PS, spec_k=2, spec_k_max=4,
                     ctrl=((2, 4), dict(k0=2, window=4, min_obs=2)),
                     draft_model=oracle):
        with get_sentinel().armed():
            h0 = eng.submit(rows[0], max_new_tokens=mn)
            eng.step()
            eng.step()
            h1 = eng.submit(rows[1], max_new_tokens=mn)
            outs.append([list(h0.result()), list(h1.result())])
    for o, ref in zip(outs[1], refs):
        np.testing.assert_array_equal(np.asarray(o), ref)
    assert outs[0] == outs[1]
    s = eng.stats()
    assert s.decode_traces == 1 and s.completed == 2
    assert eng._spec_k == 4
    ts.assert_pool_whole(eng)


def test_a_ladder_built_mid_traffic_leaves_live_rows_unchanged():
    """The rungs are built at the first speculative decode, on parked
    windows beside a slot already prefilled: on a card each build's
    warm-up runs the rung once, and its K/V writes land at or above every
    cursor. Here each rung is run so (`run_eager` on the parked window)
    beside the live slot; that request and one admitted after give the
    reference's streams."""
    rng = np.random.default_rng(81)
    rows = [rng.integers(1, 255, (n,)).astype("int64") for n in (6, 4)]
    mn = 9
    refs = [_ref_row(r, mn) for r in rows]
    eng = Engine(MODEL, device="cpu", slots=2, max_len=8 + mn + 8,
                 prefill_buckets=(8,), kv_mode="paged", page_size=PS,
                 spec_k=2, spec_adaptive=True, spec_k_max=8)
    h0 = eng.submit(rows[0], max_new_tokens=mn)
    eng.step()                     # admits and builds every rung
    assert sorted(eng._verify_fns) == [1, 2, 4, 8]
    for k, fn in eng._verify_fns.items():
        toks = np.zeros((eng.slots, k + 1), np.int64)
        toks[:, 0] = eng._tokens
        with torch.inference_mode():
            fn.run_eager(**eng._step_operands(toks))
    h1 = eng.submit(rows[1], max_new_tokens=mn)
    for h, ref in ((h0, refs[0]), (h1, refs[1])):
        np.testing.assert_array_equal(np.asarray(h.result()), ref)
    assert eng.stats().decode_traces == 1
    ts.assert_pool_whole(eng)


# ---------------- budget ceiling -------------------------------------------

def test_adaptive_admission_budget_pinned_at_spec_k_max():
    """Every slot reserves for the ceiling, not the current k: the dense
    fit, the paged whole-pool refusal and its message use spec_k_max."""
    rng = np.random.default_rng(83)
    row = rng.integers(1, 255, (5,)).astype("int64")
    eng = Engine(MODEL, slots=1, max_len=14, prefill_buckets=(8,),
                 spec_k=2, spec_k_max=4, device="cpu")
    assert eng._spec_k == 2 and eng._spec_k_max == 4
    eng.submit(row, max_new_tokens=2)                # 8 + 2 + 4 fits
    with pytest.raises(ValueError, match="speculative verify lanes"):
        eng.submit(row, max_new_tokens=3)
    eng2 = Engine(MODEL, slots=1, max_len=16, prefill_buckets=(8,),
                  spec_k=2, spec_k_max=4, kv_mode="paged", page_size=PS,
                  kv_pages=3, device="cpu")
    with pytest.raises(ValueError, match="speculative verify lanes"):
        eng2.submit(row, max_new_tokens=4)
    eng3 = Engine(MODEL, slots=1, max_len=8 + 4 + 4, prefill_buckets=(8,),
                  spec_k=4, spec_adaptive=True, device="cpu")
    ref3 = JaxEngine(JAX_MODEL, slots=1, max_len=8 + 4 + 4,
                     prefill_buckets=(8,), spec_k=4, spec_adaptive=True)
    assert eng3._spec_k_max == ref3._spec_k_max == 4
    assert eng3._spec_ctrl.rungs == ref3._spec_ctrl.rungs == (1, 2, 4)


# ---------------- resilience composition -----------------------------------

def test_adaptive_deadline_expiry_mid_verify_drains_pool():
    rng = np.random.default_rng(89)
    row = rng.integers(1, 255, (5,)).astype("int64")
    inj = FaultInjector().add("clock_skew", skew_s=1e6, at_step=2)
    eng = Engine(MODEL, slots=1, max_len=8 + 8 + 4, prefill_buckets=(8,),
                 kv_mode="paged", page_size=PS, spec_k=2,
                 spec_adaptive=True, spec_k_max=4, fault_injector=inj,
                 device="cpu")
    h = eng.submit(row, max_new_tokens=8, deadline_s=30.0)
    with pytest.raises(DeadlineExceededError):
        h.result()
    assert len(h.partial) >= 1
    assert eng.kv.pages_in_use == 0
    assert eng.stats().deadline_exceeded == 1
    assert h.timeline.terminal_cause == "deadline"


def test_adaptive_step_error_mid_verify_drains_pool_and_fails_typed():
    """Building the rungs runs every verify step once BEFORE the first
    real step without consuming the injected step_error: the fault
    fires on the real verify, the handles fail, the pool drains."""
    rng = np.random.default_rng(97)
    rows = [rng.integers(1, 255, (4,)).astype("int64") for _ in range(2)]
    inj = FaultInjector().add("step_error", at_step=1, phase="decode")
    eng = Engine(MODEL, slots=2, max_len=8 + 4 + 4, prefill_buckets=(8,),
                 kv_mode="paged", page_size=PS, spec_k=2,
                 spec_adaptive=True, spec_k_max=4, fault_injector=inj,
                 device="cpu")
    handles = [eng.submit(r, max_new_tokens=4) for r in rows]
    for h in handles:
        with pytest.raises(RuntimeError):
            h.result()
    assert eng.kv.pages_in_use == 0
    assert inj.fired and inj.fired[0][0] == "step_error"
    assert inj.fired[0][2]["step"] == 1
    with pytest.raises(RuntimeError, match="died"):
        eng.submit(rows[0], max_new_tokens=2)
