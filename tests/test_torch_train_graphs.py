"""`SpmdTrainStep` as one captured step per batch signature, on the
CPU path of `jit.CapturedStep` (the same body, run eagerly on the same
static buffers, one build counted a signature).

Checked: the step equals the eager path it replaced (``loss_and_grads``
then ``apply_gradients``), bit for bit, dropout on; a new batch
signature is a second build reported to the sentinel, which raises when
armed; new params / opt_state tensors build again; a kept loss and kept
aux values are copies; the key decides the dropout masks; the learning
rate is read on every call, so a scheduler moves the step (the
reference's jitted step reads it once: ROADMAP C.3); the metrics
snapshot. gpt-test throughout, with its own dropout of 0.1.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
from paddle_tpu_torch.jit import CapturedStep
from paddle_tpu_torch.models import GPTForPretraining
from paddle_tpu_torch.observability import RecompileError, get_sentinel
from paddle_tpu_torch.optimizer import AdamW, lr as tlr

LR = 1e-3


def _batch(seed, b=2, s=32):
    ids = np.random.default_rng(seed).integers(0, 256, (b, s + 1))
    return {"input_ids": torch.from_numpy(ids[:, :-1]),
            "labels": torch.from_numpy(ids[:, 1:])}


def _step(seed=1, loss_fn=gpt_loss_fn, **kw):
    model = GPTForPretraining("gpt-test", device="cpu", seed=seed)
    model.train()
    opt = AdamW(learning_rate=kw.pop("learning_rate", LR), weight_decay=0.01)
    step = SpmdTrainStep(model, loss_fn, opt, **kw)
    return step, *step.init()


def _snapshot(params, state):
    return ({n: p.clone() for n, p in params.items()},
            [t.clone() for t in _flat(state)])


def _restore(params, state, snap):
    for n, p in params.items():
        p.copy_(snap[0][n])
    for t, v in zip(_flat(state), snap[1]):
        t.copy_(v)


def _flat(state):
    out = [state["step"]]
    for n in sorted(state["slots"]):
        out += [state["slots"][n][k] for k in sorted(state["slots"][n])]
    return out


def test_captured_step_equals_the_eager_path():
    """Three calls of the step against ``loss_and_grads`` +
    ``apply_gradients`` on a twin model, same keys: losses, params and
    slots bit for bit."""
    step, params, state = _step()
    twin, tparams, tstate = _step()
    for i in range(3):
        batch = _batch(i)
        loss, params, state = step(params, state, batch, 40 + i)
        tloss, grads = twin.loss_and_grads(tparams, batch, 40 + i)
        twin.optimizer.apply_gradients(tparams, grads, tstate)
        assert torch.equal(loss, tloss)
    assert all(torch.equal(params[n], tparams[n]) for n in params)
    assert all(torch.equal(a, b) for a, b in zip(_flat(state),
                                                  _flat(tstate)))
    assert int(state["step"]) == 3
    assert step.metrics_snapshot()["xla_traces"] == 1
    assert step.captured(_batch(0)).captures == 1


def test_a_new_batch_signature_builds_again_and_an_armed_sentinel_raises():
    step, params, state = _step()
    step(params, state, _batch(0), 0)
    step(params, state, _batch(1), 1)             # the same signature
    assert get_sentinel().trace_count(step.exec_name) == 1
    step(params, state, _batch(2, s=16), 2)       # a new one
    assert get_sentinel().trace_count(step.exec_name) == 2
    sigs = get_sentinel().signatures(step.exec_name)
    assert "16" in sigs[1] and sigs[0] != sigs[1]
    step(params, state, _batch(3), 3)             # both kept
    assert step.metrics_snapshot()["xla_traces"] == 2
    with get_sentinel().armed(), pytest.raises(RecompileError):
        step(params, state, _batch(4, s=8), 4)


def test_new_state_tensors_build_again():
    """A new ``init()`` hands back new slot tensors: the step builds
    anew (and never runs on the old ones); restoring values into the
    same tensors does not."""
    step, params, state = _step()
    step(params, state, _batch(0), 0)
    snap = _snapshot(params, state)
    step(params, state, _batch(1), 1)
    _restore(params, state, snap)
    step(params, state, _batch(1), 1)
    assert step.metrics_snapshot()["xla_traces"] == 1
    params2, state2 = step.init()
    step(params2, state2, _batch(2), 2)
    assert step.metrics_snapshot()["xla_traces"] == 2
    assert int(state2["step"]) == 1 and int(state["step"]) == 2
    with get_sentinel().armed(), pytest.raises(RecompileError):
        step(*step.init(), _batch(3), 3)


def test_a_kept_loss_and_aux_are_copies():
    def loss_fn(model, state, batch):
        loss = gpt_loss_fn(model, state, batch)
        return loss, {"twice": 2 * loss}

    step, params, state = _step(loss_fn=loss_fn)
    first, _, _ = step(params, state, _batch(0), 0)
    kept, aux = first.clone(), step.last_aux
    second, _, _ = step(params, state, _batch(1), 1)
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert torch.equal(aux["twice"], 2 * first)
    assert torch.equal(step.last_aux["twice"], 2 * second)


def test_the_key_decides_the_dropout_masks():
    step, params, state = _step()
    snap = _snapshot(params, state)
    losses = []
    for key in (5, 6, 5):
        _restore(params, state, snap)
        losses.append(step(params, state, _batch(0), key)[0])
        after = {n: p.clone() for n, p in params.items()}
    assert torch.equal(losses[0], losses[2])
    assert not torch.equal(losses[0], losses[1])
    _restore(params, state, snap)
    eager, _, _ = step.run_eager(params, state, _batch(0), 5)
    assert torch.equal(eager, losses[0])
    assert all(torch.equal(after[n], p) for n, p in params.items())


def test_a_scheduler_moves_the_captured_step():
    """The lr is ``get_lr()`` staged on every call: after
    ``scheduler.step()`` the next call updates with the new rate (the
    reference's jitted step keeps the rate it was traced with)."""
    sched = tlr.StepDecay(1e-2, 1, gamma=0.1)
    step, params, state = _step(learning_rate=sched)
    twin, tparams, tstate = _step(learning_rate=0.0)
    for i, rate in enumerate((1e-2, 1e-3, 1e-4)):
        assert step.optimizer.get_lr() == pytest.approx(rate)
        step(params, state, _batch(i), i)
        _, grads = twin.loss_and_grads(tparams, _batch(i), i)
        twin.optimizer.apply_gradients(tparams, grads, tstate, lr=rate)
        sched.step()
    assert all(torch.equal(params[n], tparams[n]) for n in params)


def test_metrics_snapshot():
    step, params, state = _step()
    for i in range(3):
        step(params, state, _batch(i, b=2, s=32), i)
    snap = step.metrics_snapshot()
    assert snap["executable"] == step.exec_name
    assert snap["executable"].startswith("spmd.step[s")
    assert (snap["xla_traces"], snap["steps"], snap["tokens"]) == \
        (1, 3, 3 * 2 * 32)
    assert snap["step_seconds_sum"] > 0
    assert snap["memory"] is snap["cost"] is snap["mfu"] is None
    assert "found_inf_skips" not in step.metrics_snapshot(state)


def test_captured_step_warm_is_call_runs_the_body_once_a_call():
    """On the CPU a `CapturedStep` that updates state in place runs its
    body once a call, returns copies of a tuple of outputs, and reports
    one build."""
    acc = torch.zeros(3)
    builds = []

    def body(x):
        acc.add_(x)
        return acc * 1, acc.sum()

    cs = CapturedStep("test.acc", body, "cpu", pool=None,
                      on_trace=lambda: builds.append(1),
                      inputs={"x": ((3,), torch.float32)}, fixed=[acc],
                      warm_is_call=True)
    a, s = cs(x=torch.ones(3))
    b, _ = cs(x=torch.ones(3))
    assert torch.equal(acc, torch.full((3,), 2.0)) and builds == [1]
    assert torch.equal(a, torch.ones(3)) and float(s) == 3.0
    assert torch.equal(b, torch.full((3,), 2.0))
    cs.run_eager(x=torch.ones(3))
    assert torch.equal(acc, torch.full((3,), 3.0)) and cs.captures == 1
