"""The port's `ResilientTrainLoop` against paddle_tpu's.

Both packages train the reference's own case (``tests/
test_train_resilience.py``: an 8 -> 16 -> 1 MLP, AdamW lr 1e-2, MSE on a
step-indexed numpy batch source, checkpoint interval 2) from the same
weights, drawn by the reference and carried across. Under the same
injected faults both loops report the same ``resumed_from``, skipped
windows, rollbacks and anomalies, and their per-step losses agree within
float32 rtol 1e-5 (two implementations of the same f32 arithmetic, op
order apart). The port's own crash and resume is bit for bit its
uninterrupted run (on the CPU the step is deterministic). The MLP case
(`make_step`, `_data` and their reference twins) is shared with
``test_torch_train_introspection.py`` and ``test_torch_tracing.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import HybridMesh, HybridParallelConfig
from paddle_tpu.distributed import SpmdTrainStep as JStep
from paddle_tpu.framework import train_loop as jloop_mod
from paddle_tpu.framework.train_faults import \
    TrainFaultInjector as JInjector
from paddle_tpu.jit.api import functional_call as jfunctional_call
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.distributed import SpmdTrainStep
from paddle_tpu_torch.framework import (CheckpointManager, InjectedCrash,
                                        ResilientTrainLoop,
                                        TrainAnomalyError,
                                        TrainFaultInjector,
                                        register_train_metrics)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import AdamW

RTOL = 1e-5
INTERVAL = 2


# the reference's MLP case, in both packages; the other training-plane
# test files import it from here
class _JMLP(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = paddle.nn.Linear(8, 16)
        self.fc2 = paddle.nn.Linear(16, 1)

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = Linear(8, 16, device="cpu")
        self.fc2 = Linear(16, 1, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _jloss(model, state, batch):
    pred = jfunctional_call(model, state, JTensor(batch["x"]))
    return JF.mse_loss(pred, JTensor(batch["y"]))


def _loss(model, state, batch):
    pred = torch.func.functional_call(model, state, (batch["x"],))
    return ((pred - batch["y"]) ** 2).mean()


def _np_batch(i):
    rng = np.random.default_rng(1000 + i)
    x = rng.normal(size=(8, 8)).astype("float32")
    y = (x.sum(axis=1, keepdims=True) * 0.1).astype("float32")
    return x, y


def _jdata(i):
    x, y = _np_batch(i)
    return {"x": jnp.asarray(x), "y": jnp.asarray(y)}


def _data(i):
    x, y = _np_batch(i)
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _jmake_step(**kw):
    paddle.seed(0)
    model = _JMLP()
    model.train()
    mesh = HybridMesh(HybridParallelConfig(dp_degree=1),
                      devices=jax.devices()[:1])
    return JStep(model, _jloss, JAdamW(learning_rate=1e-2), mesh, **kw)


WEIGHTS = {k: np.asarray(v._value)
           for k, v in _jmake_step().model.state_dict().items()}


def make_step(**kw):
    """The port's step on the reference's initial weights."""
    model = _MLP()
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.array(WEIGHTS[k])))
    model.train()
    return SpmdTrainStep(model, _loss, AdamW(learning_rate=1e-2), **kw)


def _loop(directory, loop_id, **kw):
    kw.setdefault("checkpoint_interval", INTERVAL)
    return ResilientTrainLoop(make_step(), _data, directory=str(directory),
                              loop_id=loop_id, **kw)


def _jloop(directory, loop_id, **kw):
    kw.setdefault("checkpoint_interval", INTERVAL)
    return jloop_mod.ResilientTrainLoop(
        _jmake_step(), _jdata, directory=str(directory), loop_id=loop_id,
        **kw)


def _close(got, want):
    assert sorted(got.losses_by_step) == sorted(want.losses_by_step)
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    """Uninterrupted 8-step runs of both loops: the trajectories every
    faulted run is held to."""
    port = _loop(tmp_path_factory.mktemp("base"), "t-base").run(8)
    ref = _jloop(tmp_path_factory.mktemp("jbase"), "j-base").run(8)
    assert port.steps_run == ref.steps_run == 8
    assert port.last_committed_step == ref.last_committed_step == 8
    assert all(math.isfinite(v) for v in port.losses)
    _close(port, ref)
    return port, ref


@pytest.mark.parametrize("crash_at", [1, 5])
def test_crash_resume_is_bit_for_bit_and_resumes_where_the_reference_does(
        tmp_path, baselines, crash_at):
    base, _ = baselines
    resumed_from = {}
    for pkg, make, inj_cls in (("port", _loop, TrainFaultInjector),
                               ("ref", _jloop, JInjector)):
        d = tmp_path / pkg
        inj = inj_cls().add("crash_at_step", at_step=crash_at)
        crashed = make(d, f"{pkg}-crash{crash_at}", fault_injector=inj)
        with pytest.raises(Exception) as ei:
            crashed.run(8)
        assert type(ei.value).__name__ == "InjectedCrash"
        crashed._manager.wait()
        resumed = make(d, f"{pkg}-resume{crash_at}")
        resumed_from[pkg] = resumed.resumed_from
        res = resumed.run(8)
        assert res.steps_run == 8 - resumed.resumed_from
        assert res.last_committed_step == 8
        if pkg == "port":
            for s, v in res.losses_by_step.items():
                assert v == base.losses_by_step[s], (s, v)
    assert resumed_from["port"] == resumed_from["ref"] <= crash_at


def test_resume_in_process_adds_no_build(tmp_path):
    """A fresh loop over the same step and tensors copies the checkpoint
    into them: the step is not built again."""
    from paddle_tpu_torch.observability import get_sentinel

    step = make_step()
    params, opt_state = step.init()
    inj = TrainFaultInjector().add("crash_at_step", at_step=3)
    loop = ResilientTrainLoop(step, _data, params, opt_state,
                              directory=str(tmp_path), fault_injector=inj,
                              checkpoint_interval=INTERVAL)
    with pytest.raises(InjectedCrash):
        loop.run(6)
    loop._manager.wait()
    builds = get_sentinel().trace_count(step.exec_name)
    with torch.no_grad():
        for t in step.state_items(params, opt_state):
            t[1].zero_()
    with get_sentinel().armed():
        again = ResilientTrainLoop(step, _data, params, opt_state,
                                   directory=str(tmp_path),
                                   checkpoint_interval=INTERVAL)
        assert again.resumed_from == 2
        res = again.run(6)
    assert get_sentinel().trace_count(step.exec_name) == builds
    assert res.steps_run == 4 and res.last_committed_step == 6


def test_corrupt_latest_falls_back_like_the_reference(tmp_path, baselines):
    base, jbase = baselines
    m = register_train_metrics()
    jm = jloop_mod.register_train_metrics()
    out = {}
    for pkg, make, inj_cls, metrics in (
            ("port", _loop, TrainFaultInjector, m),
            ("ref", _jloop, JInjector, jm)):
        d = tmp_path / pkg
        inj = inj_cls().add("corrupt_shard", at_step=6)
        make(d, f"{pkg}-corr", fault_injector=inj).run(6)
        before = metrics["discarded"].value(loop=f"{pkg}-corr-resume")
        resumed = make(d, f"{pkg}-corr-resume")
        out[pkg] = (resumed.resumed_from,
                    metrics["discarded"].value(loop=f"{pkg}-corr-resume")
                    - before)
        res = resumed.run(8)
        if pkg == "port":
            for s, v in res.losses_by_step.items():
                assert v == base.losses_by_step[s], (s, v)
    assert out["port"] == out["ref"] == (4, 1)


def test_torn_write_never_commits_like_the_reference(tmp_path):
    steps = {}
    for pkg, make, inj_cls in (("port", _loop, TrainFaultInjector),
                               ("ref", _jloop, JInjector)):
        inj = inj_cls().add("torn_checkpoint_write", at_step=2)
        loop = make(tmp_path / pkg, f"{pkg}-torn", fault_injector=inj)
        res = loop.run(4)
        steps[pkg] = (loop._manager.steps(), res.last_committed_step,
                      make(tmp_path / pkg, f"{pkg}-torn-r").resumed_from)
    assert steps["port"] == steps["ref"] == ([0, 4], 4, 4)


@pytest.mark.parametrize("kind", ["nan_loss_at_step", "loss_spike"])
def test_anomaly_rolls_back_and_skips_the_window_like_the_reference(
        tmp_path, kind):
    """A NaN loss (and a finite spike, forced through the spike factor)
    at step 3: one anomaly, one rollback to step 2's checkpoint, data
    index 3 skipped; the same in both packages, losses within rtol."""
    runs = {}
    for pkg, make, inj_cls in (("port", _loop, TrainFaultInjector),
                               ("ref", _jloop, JInjector)):
        inj = inj_cls()
        kw = {}
        if kind == "nan_loss_at_step":
            inj.add("nan_loss_at_step", at_step=3)
        else:
            kw = dict(spike_factor=0.0, spike_warmup=3, max_rollbacks=1,
                      checkpoint_interval=3)
        loop = make(tmp_path / pkg, f"{pkg}-{kind}", fault_injector=inj,
                    **kw)
        res = loop.run(6) if kind == "nan_loss_at_step" else None
        if res is None:
            with pytest.raises(Exception) as ei:
                loop.run(6)
            assert type(ei.value).__name__ == "TrainAnomalyError"
            runs[pkg] = (loop._rollbacks, sorted(loop._skipped),
                         loop._step_idx)
            continue
        assert all(math.isfinite(v) for v in res.losses)
        runs[pkg] = (res.anomalies, res.rollbacks, sorted(loop._skipped),
                     res)
    if kind == "nan_loss_at_step":
        assert runs["port"][:3] == runs["ref"][:3] == (1, 1, [3])
        _close(runs["port"][3], runs["ref"][3])
        m = register_train_metrics()
        assert m["anomaly"].value(loop=f"port-{kind}",
                                  kind="non_finite") == 1
        assert m["rollbacks"].value(loop=f"port-{kind}") == 1
    else:
        assert runs["port"] == runs["ref"] == (1, [3], 3)


def test_budget_exhaustion_is_typed(tmp_path):
    """An exhausted anomaly budget raises typed; with a flight recorder
    (ROADMAP A9) the death leaves exactly one train-death
    postmortem naming the loop and its fatal anomaly, and the loop's
    ``observability_port=`` endpoint serves it on ``/train``."""
    import json
    import urllib.request

    from paddle_tpu_torch.observability import FlightRecorder

    inj = TrainFaultInjector().add("nan_loss_at_step", times=10)
    rec = FlightRecorder(dump_dir=str(tmp_path / "flight"))
    loop = _loop(tmp_path / "ck", "t-budget", fault_injector=inj,
                 max_rollbacks=2, flight_recorder=rec, observability_port=0)
    try:
        with pytest.raises(TrainAnomalyError, match="budget"):
            loop.run(6)
        assert loop.last_anomaly["action"] == "fatal"
        assert len(rec.dumps) == 1
        with open(rec.dumps[0]) as f:
            art = json.load(f)
        assert art["kind"] == "train_death" and art["loop_id"] == "t-budget"
        assert art["reason"] == "TrainAnomalyError"
        assert art["anomaly_attribution"]["action"] == "fatal"
        with urllib.request.urlopen(loop.observability.url + "/train",
                                    timeout=10) as r:
            rows = json.load(r)["sources"]
        assert [r["id"] for r in rows] == ["t-budget"]
    finally:
        loop.observability.stop()
        rec.detach()


def test_loss_spike_detector(tmp_path):
    loop = _loop(tmp_path, "t-spike", spike_factor=4.0, spike_warmup=3)
    loop._ewma, loop._ewma_n = 1.0, 5
    assert loop._classify(2.0) is None
    assert loop._classify(float("nan")) == "non_finite"
    assert loop._classify(float("inf")) == "non_finite"
    assert loop._classify(5.0) == "loss_spike"
    loop._ewma_n = 1  # inside warmup: spikes tolerated
    assert loop._classify(100.0) is None


def test_preemption_commits_an_emergency_snapshot_like_the_reference(
        tmp_path):
    out = {}
    for pkg, cls, step_fn, data in (
            ("port", ResilientTrainLoop, make_step, _data),
            ("ref", jloop_mod.ResilientTrainLoop, _jmake_step, _jdata)):
        holder = {}

        def data_with_notice(i, data=data, holder=holder):
            if i == 3:
                holder["loop"].request_preemption()
            return data(i)

        loop = cls(step_fn(), data_with_notice,
                   directory=str(tmp_path / pkg), loop_id=f"{pkg}-pre",
                   checkpoint_interval=100)
        holder["loop"] = loop
        res = loop.run(8)
        resumed = cls(step_fn(), data, directory=str(tmp_path / pkg),
                      loop_id=f"{pkg}-pre-r", checkpoint_interval=100)
        res2 = resumed.run(6)
        res3 = loop.run(6)
        out[pkg] = (res.preempted, res.steps_run, res.last_committed_step,
                    resumed.resumed_from, res2.preempted, res2.steps_run,
                    res3.preempted, res3.steps_run)
    assert out["port"] == out["ref"] == (True, 4, 4, 4, False, 2, False, 2)


def test_slow_io_does_not_stall_the_async_loop(tmp_path):
    inj = TrainFaultInjector().add("slow_io", at_step=2, sleep_s=0.3)
    res = _loop(tmp_path, "t-slow", fault_injector=inj).run(4)
    assert res.steps_run == 4 and res.last_committed_step == 4
    assert inj.fired and inj.fired[0][0] == "slow_io"


def test_scaler_state_is_checkpointed_bit_for_bit(tmp_path):
    """The GradScaler's device state rides inside opt_state: a resumed
    run's scale and counters are the crashed run's, and the loop state
    records the scale."""
    from paddle_tpu_torch.amp import GradScaler

    def scaled_loop(d, loop_id, **kw):
        step = make_step(scaler=GradScaler(init_loss_scaling=2.0 ** 8,
                                           incr_every_n_steps=2))
        return ResilientTrainLoop(step, _data, directory=str(d),
                                  loop_id=loop_id,
                                  checkpoint_interval=INTERVAL, **kw)

    base = scaled_loop(tmp_path / "a", "t-sc-a")
    bres = base.run(6)
    inj = TrainFaultInjector().add("crash_at_step", at_step=5)
    crashed = scaled_loop(tmp_path / "b", "t-sc-b", fault_injector=inj)
    with pytest.raises(InjectedCrash):
        crashed.run(6)
    crashed._manager.wait()
    resumed = scaled_loop(tmp_path / "b", "t-sc-r")
    assert resumed.resumed_from == 4
    res = resumed.run(6)
    for s, v in res.losses_by_step.items():
        assert v == bres.losses_by_step[s]
    for k in ("scale", "good", "bad", "skipped"):
        assert torch.equal(resumed.opt_state["scaler"][k],
                           base.opt_state["scaler"][k])
    _, _, ls = CheckpointManager(str(tmp_path / "b")).restore_latest()
    assert ls["loss_scale"] == float(base.opt_state["scaler"]["scale"])


def test_train_metric_families_match_the_reference():
    """Names, kinds and labels of the train_* family and of the
    introspection family, as registered by both packages."""
    from paddle_tpu.observability import get_registry as jreg
    from paddle_tpu.observability import train_introspection as jintro
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.observability import train_introspection as intro

    def family(metrics, reg):
        out = {}
        for m in metrics.values():
            m2 = reg().get(m.name)
            assert m2 is m
            out[m.name] = (m.kind, tuple(m.labelnames))
        return out

    assert family(register_train_metrics(), get_registry) == family(
        jloop_mod.register_train_metrics(), jreg)
    assert family(intro.register_introspection_metrics(),
                  get_registry) == family(
        jintro.register_introspection_metrics(), jreg)


def test_train_snapshot_reports_the_loop(tmp_path):
    loop = _loop(tmp_path, "t-snap")
    loop.run(3)
    snap = loop.train_snapshot()
    assert snap["step"] == 3 and snap["data_cursor"] == 3
    assert snap["last_committed_step"] == 3
    assert snap["train_step"]["steps"] == 3
    assert snap["introspection"]["enabled"] is False
    assert 0.0 <= snap["data_stall_fraction"] <= 1.0
    # a step with no schedule reads the whole-pipeline bubble recorded
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.observability import train_introspection as intro

    report = intro.gpipe_wave_accounting([[1.0, 2.0], [1.0, 1.0]])
    intro.record_pipeline_bubble(report, [[1.0, 2.0], [1.0, 1.0]])
    alls = {v for labels, v in get_registry().collect(
        "train_pipeline_bubble_fraction") if labels["stage"] == "all"}
    assert loop.train_snapshot()["pipeline_bubble_fraction"] in alls
    assert report["bubble_fraction"] in alls
