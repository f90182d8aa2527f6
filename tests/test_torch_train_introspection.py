"""The port's training introspection against paddle_tpu's.

`grad_telemetry` over torch tensors gives the reference's rows (float32
sums, rtol 1e-6) on the same numpy params and grads, a non-finite grad
and an integer leaf included; `fold_telemetry`, `LayerGradStats`,
`attribute_anomaly` and the pipeline-accounting functions are the
reference's host code and give equal outputs. `SpmdTrainStep(
introspect=True)` keeps the loss bit for bit the ``introspect=False``
loss and one build a batch signature under the armed sentinel; its rows
track the reference step's on the same weights and batches (rtol 1e-4:
the updates part at f32 rounding). Through the loop, a NaN planted in
``fc2.weight`` is named as the suspect layer in both packages.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework import train_loop as jloop_mod
from paddle_tpu.framework.train_faults import \
    TrainFaultInjector as JInjector
from paddle_tpu.observability import train_introspection as jintro
from paddle_tpu_torch.framework import (ResilientTrainLoop,
                                        TrainAnomalyError,
                                        TrainFaultInjector)
from paddle_tpu_torch.observability import get_registry, get_sentinel
from paddle_tpu_torch.observability import train_introspection as intro

from test_torch_train_resilience import (_data, _jdata, _jmake_step,
                                         make_step)

NAMES = ["gpt.embeddings.word_embeddings.weight", "gpt.h.0.attn.qkv.weight",
         "gpt.h.0.ln_1.bias", "gpt.h.12.mlp.fc_in.bias", "gpt.ln_f.weight",
         "fc1.weight", "fc1.bias", "emb", "steps_int"]


def _tensors(seed):
    rng = np.random.default_rng(seed)
    shapes = {n: (3, 4) if n.endswith("weight") else (5,) for n in NAMES}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
    new = {n: (p - 0.01 * grads[n]).astype(np.float32)
           for n, p in params.items()}
    for d in (params, grads, new):
        d["steps_int"] = np.arange(5, dtype=np.int32)
    grads["gpt.h.0.ln_1.bias"][2] = np.nan
    grads["fc1.bias"][0] = np.inf
    return params, grads, new


def test_layer_keys_and_groups_match():
    for n in NAMES:
        assert intro.layer_key(n) == jintro.layer_key(n)
    assert intro.group_layers(NAMES) == jintro.group_layers(NAMES)


def _host(tree):
    return {"layers": {k: {q: np.asarray(v) for q, v in t.items()}
                       for k, t in tree["layers"].items()},
            "grad_sq_global": np.asarray(tree["grad_sq_global"])}


def test_grad_telemetry_rows_match_the_reference():
    params, grads, new = _tensors(0)
    groups = intro.group_layers(NAMES)
    want = jintro.grad_telemetry(
        groups, *({k: jnp.asarray(v) for k, v in d.items()}
                  for d in (params, grads, new)))
    got = intro.grad_telemetry(
        groups, *({k: torch.from_numpy(v) for k, v in d.items()}
                  for d in (params, grads, new)))
    w, g = _host(want), _host(got)
    assert set(w["layers"]) == set(g["layers"])
    for layer in w["layers"]:
        for q in ("grad_sq", "param_sq", "update_sq"):
            np.testing.assert_allclose(g["layers"][layer][q],
                                       w["layers"][layer][q], rtol=1e-6)
        assert int(g["layers"][layer]["nonfinite"]) == \
            int(w["layers"][layer]["nonfinite"])
    assert g["layers"]["gpt.h.0"]["nonfinite"] == 1
    np.testing.assert_allclose(g["grad_sq_global"], w["grad_sq_global"],
                               rtol=1e-6)
    rw, rg = jintro.fold_telemetry(w, 4), intro.fold_telemetry(g, 4)
    assert rw["step"] == rg["step"] == 4
    for layer, t in rw["layers"].items():
        for q, v in t.items():
            if isinstance(v, float) and math.isfinite(v):
                assert rg["layers"][layer][q] == pytest.approx(v, rel=1e-6)
            else:
                assert repr(rg["layers"][layer][q]) == repr(v)


def test_fold_stats_and_attribution_are_the_references():
    """The same host rows through both packages' fold, z-score stats and
    attribution give equal results, the ordering of signals included."""
    rng = np.random.default_rng(3)
    stats, jstats = intro.LayerGradStats(warmup=3), jintro.LayerGradStats(
        warmup=3)
    for i in range(6):
        host = {"layers": {l: {"grad_sq": float(rng.uniform(0.5, 1.5)),
                               "param_sq": 4.0, "update_sq": 1e-4,
                               "nonfinite": 0} for l in ("a", "b", "c")},
                "grad_sq_global": 3.0}
        row, jrow = intro.fold_telemetry(host, i), jintro.fold_telemetry(
            host, i)
        assert row["layers"] == jrow["layers"]
        stats.update(row)
        jstats.update(jrow)
    for layer in ("a", "b", "c"):
        assert stats.z(layer, 5.0) == jstats.z(layer, 5.0)
    spike = {"layers": {
        "a": {"grad_norm": 1.0, "param_norm": 2.0, "nonfinite": 0},
        "b": {"grad_norm": 50.0, "param_norm": 2.0, "nonfinite": 0},
        "c": {"grad_norm": 1.0, "param_norm": 2.0, "nonfinite": 0}}}
    nan_param = {"layers": {
        "a": {"grad_norm": float("nan"), "param_norm": 2.0, "nonfinite": 3},
        "b": {"grad_norm": float("nan"), "param_norm": float("nan"),
              "nonfinite": 3},
        "c": {"grad_norm": 1.0, "param_norm": 2.0, "nonfinite": 0}}}
    for row in (spike, nan_param, None):
        got = intro.attribute_anomaly(row, stats)
        want = jintro.attribute_anomaly(row, jstats)
        assert got == want
    assert intro.attribute_anomaly(spike, stats)["layer"] == "b"
    assert intro.attribute_anomaly(nan_param)["reason"] == "param_nonfinite"
    ring = intro.TelemetryRing(2)
    for i in range(3):
        ring.add({"step": i})
    assert [r["step"] for r in ring.rows()] == [1, 2] and len(ring) == 2
    assert ring.last == {"step": 2}


@pytest.mark.parametrize("schedule,pp,v,m", [
    ("gpipe_wave", 2, 1, 4), ("gpipe_wave", 3, 1, 5), ("1f1b", 2, 1, 4),
    ("interleaved_1f1b", 2, 2, 4), ("interleaved_1f1b", 3, 2, 6)])
def test_pipeline_accounting_matches_the_reference(schedule, pp, v, m):
    rng = np.random.default_rng(pp * 10 + m)
    fwd = rng.uniform(0.5, 2.0, (pp * v, m)).tolist()
    bwd = (None if schedule == "gpipe_wave"
           else rng.uniform(1.0, 3.0, (pp * v, m)).tolist())
    got = intro.pipeline_accounting(fwd, bwd, schedule=schedule, n_virtual=v)
    want = jintro.pipeline_accounting(fwd, bwd, schedule=schedule,
                                      n_virtual=v)
    assert got == want
    assert intro.schedule_ticks(schedule, pp, v, m) == \
        jintro.schedule_ticks(schedule, pp, v, m)
    for t in range(intro.schedule_ticks(schedule, pp, v, m)):
        for d in range(pp):
            assert intro.fwd_unit_index(t, d, pp, v, m) == \
                jintro.fwd_unit_index(t, d, pp, v, m)
            assert intro.bwd_unit_index(t, d, pp, v, m) == \
                jintro.bwd_unit_index(t, d, pp, v, m)
    if schedule == "gpipe_wave":
        assert intro.gpipe_wave_accounting(fwd) == \
            jintro.gpipe_wave_accounting(fwd)
    intro.record_pipeline_bubble(got, fwd)
    g = get_registry().get("train_pipeline_bubble_fraction")
    assert g.value(stage="all", schedule=schedule) == got["bubble_fraction"]
    with pytest.raises(ValueError):
        intro.pipeline_accounting([[1.0, 2.0], [1.0]])


def test_phase_vocabulary_is_the_references():
    assert intro.TRAIN_PHASES == jintro.TRAIN_PHASES
    assert (intro.PHASE_DATA_WAIT, intro.PHASE_DISPATCH,
            intro.PHASE_SNAPSHOT, intro.PHASE_ROLLBACK) == (
        jintro.PHASE_DATA_WAIT, jintro.PHASE_DISPATCH,
        jintro.PHASE_SNAPSHOT, jintro.PHASE_ROLLBACK)


def _run(step, n):
    params, opt = step.init()
    losses = []
    for i in range(n):
        loss, params, opt = step(params, opt, _data(i), 100 + i)
        losses.append(loss.item())
    return losses


@pytest.mark.parametrize("scaler", [False, True], ids=["plain", "scaler"])
def test_introspect_keeps_the_loss_and_one_build(scaler):
    """The reductions read the step, they never feed back: the losses are
    bit for bit the introspect-off ones, one build each under the armed
    sentinel; the rows are finite and the gauges mirror the last one."""
    from paddle_tpu_torch.amp import GradScaler

    kw = lambda: ({"scaler": GradScaler(init_loss_scaling=2.0 ** 8)}  # noqa
                  if scaler else {})
    with get_sentinel().armed():
        base = _run(make_step(**kw()), 5)
        step = make_step(introspect=True, **kw())
        got = _run(step, 5)
    assert got == base
    assert get_sentinel().trace_count(step.exec_name) == 1
    assert len(step.telemetry_ring) == 5
    row = step.last_telemetry_row
    assert set(row["layers"]) == {"fc1", "fc2"} and row["step"] == 4
    for t in row["layers"].values():
        assert math.isfinite(t["grad_norm"]) and t["nonfinite"] == 0
        assert 0.0 < t["update_ratio"] < 1.0
    g = get_registry().get("train_layer_grad_norm")
    assert g.value(executable=step.exec_name, layer="fc2") == \
        row["layers"]["fc2"]["grad_norm"]
    snap = step.metrics_snapshot()
    assert snap["introspection"]["ring_len"] == 5


def test_introspect_rows_track_the_reference_step():
    """The port's and the reference's introspecting steps on the same
    weights and batches: every row within rtol 1e-4."""
    import jax

    jstep = _jmake_step(introspect=True)
    jparams, jopt = jstep.init()
    step = make_step(introspect=True)
    params, opt = step.init()
    for i in range(4):
        jloss, jparams, jopt = jstep(jparams, jopt, _jdata(i),
                                     jax.random.PRNGKey(i))
        loss, params, opt = step(params, opt, _data(i), i)
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        want, got = jstep.last_telemetry_row, step.last_telemetry_row
        assert got["global_grad_norm"] == pytest.approx(
            want["global_grad_norm"], rel=1e-4)
        for layer, t in want["layers"].items():
            for q in ("grad_norm", "param_norm", "update_ratio"):
                assert got["layers"][layer][q] == pytest.approx(
                    t[q], rel=1e-4), (i, layer, q)
            assert got["layers"][layer]["nonfinite"] == t["nonfinite"]


def test_gpt_introspect_groups_blocks_and_keeps_the_loss():
    """gpt-test: one row entry a block (``gpt.h.<i>``) plus the embedding
    and final-norm groups, the loss bit for bit the introspect-off one."""
    from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
    from paddle_tpu_torch.models import GPTForPretraining
    from paddle_tpu_torch.models.gpt import gpt_config
    from paddle_tpu_torch.optimizer import AdamW

    ids = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 17)))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    losses = {}
    for flag in (False, True):
        model = GPTForPretraining("gpt-test", device="cpu", seed=4)
        model.train()
        step = SpmdTrainStep(model, gpt_loss_fn, AdamW(learning_rate=1e-3),
                             introspect=flag)
        params, opt = step.init()
        out = []
        for i in range(2):
            loss, params, opt = step(params, opt, batch, 9 + i)
            out.append(loss.item())
        losses[flag] = out
    assert losses[True] == losses[False]
    layers = list(step.last_telemetry_row["layers"])
    n = gpt_config("gpt-test").num_hidden_layers
    assert [f"gpt.h.{i}" for i in range(n)] == [
        k for k in layers if k.startswith("gpt.h.")]
    assert "gpt.embeddings" in layers


def test_nan_param_rollback_names_the_poisoned_layer_like_the_reference(
        tmp_path):
    """``nan_param_at_step`` on fc2.weight at step 3: the loss goes
    non-finite on the device, the loop rolls back, and both packages'
    anomaly records name fc2 from its param-norm telemetry."""
    recs = {}
    for pkg, cls, make, data, inj_cls in (
            ("port", ResilientTrainLoop, make_step, _data,
             TrainFaultInjector),
            ("ref", jloop_mod.ResilientTrainLoop, _jmake_step, _jdata,
             JInjector)):
        inj = inj_cls().add("nan_param_at_step", at_step=3,
                            param="fc2.weight")
        loop = cls(make(introspect=True), data,
                   directory=str(tmp_path / pkg), loop_id=f"{pkg}-roll",
                   checkpoint_interval=2, fault_injector=inj)
        res = loop.run(6)
        assert res.anomalies == 1 and res.rollbacks == 1
        assert sorted(res.losses_by_step) == list(range(6))
        assert all(math.isfinite(v) for v in res.losses)
        rec = loop.anomaly_history[0]
        recs[pkg] = (rec["kind"], rec["layer"],
                     rec["attribution"]["reason"], rec["action"],
                     sorted(loop._skipped))
        assert loop.last_anomaly is rec
    assert recs["port"] == recs["ref"] == (
        "non_finite", "fc2", "param_nonfinite", "rollback", [3])


def test_nan_param_fatal_error_names_the_layer(tmp_path):
    inj = TrainFaultInjector().add("nan_param_at_step", at_step=2,
                                   param="fc2.weight")
    step = make_step(introspect=True)
    loop = ResilientTrainLoop(step, _data, directory=str(tmp_path),
                              loop_id="t-fatal", checkpoint_interval=2,
                              fault_injector=inj, max_rollbacks=0)
    with pytest.raises(TrainAnomalyError) as ei:
        loop.run(6)
    assert "fc2" in str(ei.value) and "param_nonfinite" in str(ei.value)
    assert loop.last_anomaly["action"] == "fatal"
    ring = step.telemetry_ring.rows()
    assert [r["step"] for r in ring] == [0, 1, 2]
    assert not math.isfinite(ring[-1]["layers"]["fc2"]["param_norm"])
    snap = loop.train_snapshot()
    assert snap["introspection"]["enabled"]
    assert len(snap["introspection"]["ring"]) == 3
    assert snap["anomaly_history"][0]["layer"] == "fc2"
