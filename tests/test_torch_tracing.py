"""The port's trace spans (`observability.tracing`, the reference's own
host code) against paddle_tpu's: the same calls give events with the
same fields and values (timestamps, pids and thread ids apart), the
request and trace ids ride the ambient scope, the ring buffer drops and
counts as the reference's does, and the training loop emits its
``train.*`` spans with the reference's ``stage=`` vocabulary.
"""
import json

import pytest

from paddle_tpu.observability import tracing as jtr
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.observability import tracing as tr
from paddle_tpu_torch.observability import train_introspection as intro

VOLATILE = ("ts", "dur", "pid", "tid")


def _drive(mod):
    """The same calls through one package's tracing; its events."""
    with mod.collect() as sink:
        with mod.span("train.step", stage="dispatch", executable="s0"):
            pass
        mod.instant("train.rollback", stage="rollback", kind="non_finite")
        with mod.request_scope(7, trace_id="e0/7#abc"):
            with mod.span("serving.prefill", slot=3):
                pass
            mod.async_begin("request", 7, prompt_len=5)
            mod.async_instant("decode", 7, step=1)
            mod.async_end("request", 7, finish="eos")
        mod.emit_events([mod.async_instant_evt("tok", 8, i=i)
                         for i in range(2)])
        s = mod.Span("explicit", {"a": 1}).begin()
        s.set_args(b=2)
        s.end()
    return sink


def _stable(evt):
    return {k: v for k, v in evt.items() if k not in VOLATILE}


def test_events_have_the_reference_fields_and_values():
    got, want = _drive(tr), _drive(jtr)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert _stable(g) == _stable(w)
        assert isinstance(g["ts"], float) and g["ts"] > 0
    assert got[0]["ph"] == "X" and got[0]["dur"] >= 0
    assert got[2]["args"] == {"slot": 3, "request_id": 7,
                              "trace_id": "e0/7#abc"}


def test_ring_buffer_drops_and_counts_like_the_reference():
    out = {}
    for name, mod, reg in (("port", tr, get_registry), ("ref", jtr, None)):
        cap = mod.buffer_capacity()
        try:
            mod.clear()
            mod.set_buffer_capacity(4)
            c0 = mod.cursor()
            for i in range(6):
                mod.instant("e", i=i)
            evs, cur, missed = mod.events_since(c0)
            tail, cur2, missed2 = mod.events_since(cur - 1)
            out[name] = ([e["args"]["i"] for e in evs], cur - c0, missed,
                         [e["args"]["i"] for e in tail], missed2,
                         [e["args"]["i"] for e in mod.events()])
            with pytest.raises(ValueError):
                mod.set_buffer_capacity(0)
        finally:
            mod.set_buffer_capacity(cap)
            mod.clear()
    assert out["port"] == out["ref"] == ([2, 3, 4, 5], 6, 2, [5], 0,
                                         [2, 3, 4, 5])
    assert get_registry().get("trace_events_dropped_total").value() >= 2


def test_buffer_switch_and_export(tmp_path):
    tr.clear()
    tr.set_buffer_enabled(False)
    try:
        assert not tr.active()
        tr.instant("off")
        assert tr.events() == []
    finally:
        tr.set_buffer_enabled(True)
    tr.instant("on", x=1)
    path = tr.export_chrome_trace(str(tmp_path / "t" / "trace.json"),
                                  clear_buffer=True)
    with open(path) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    assert [e["name"] for e in doc["traceEvents"]] == ["on"]
    assert tr.events() == []


def test_trace_context_roundtrips_like_the_reference():
    ctx = tr.TraceContext.new("e0", 5)
    ctx.stamp("e1")
    back = tr.TraceContext.from_dict(json.loads(json.dumps(ctx.as_dict())))
    assert back.trace_id == ctx.trace_id and back.hop == 1
    assert [h["engine"] for h in back.hops] == ["e0", "e1"]
    jctx = jtr.TraceContext.from_dict(ctx.as_dict())
    assert jctx.as_dict() == ctx.as_dict()
    assert set(tr.clock_anchor()) == set(jtr.clock_anchor())


def test_the_training_loop_emits_its_spans(tmp_path):
    """data_wait and snapshot spans from the loop, the step's dispatch
    span, a rollback instant: every ``stage=`` in TRAIN_PHASES."""
    from test_torch_train_resilience import _data as data
    from test_torch_train_resilience import make_step
    from paddle_tpu_torch.framework import (ResilientTrainLoop,
                                            TrainFaultInjector)

    inj = TrainFaultInjector().add("nan_loss_at_step", at_step=2)
    loop = ResilientTrainLoop(make_step(), data, directory=str(tmp_path),
                              loop_id="t-trace", checkpoint_interval=2,
                              fault_injector=inj)
    with tr.collect() as sink:
        loop.run(4)
    names = [e["name"] for e in sink]
    for n in ("train.data_wait", "train.step", "train.snapshot",
              "train.rollback"):
        assert n in names, names
    stages = {e["args"]["stage"] for e in sink if "stage" in e.get("args",
                                                                   {})}
    assert stages == set(intro.TRAIN_PHASES)
    assert all(e["args"]["loop"] == "t-trace" for e in sink
               if e["name"] != "train.step")
