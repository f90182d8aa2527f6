"""Dynamic loss scaling: the port's `amp.GradScaler` (eager) and
`SpmdTrainStep(scaler=...)` (the device-side gate of
``make_scaler_step``) against paddle_tpu's.

The train step runs gpt-test (dropout 0) for five steps from the same
weights and numpy batches in both packages; the loss function multiplies
the LM loss by the mean of a ``poison`` batch entry, 1 except at step 2
where it is inf, so that step's grads are non-finite. Checked each step:
the skip (params, slots and the step count unchanged, bit for bit), the
scale's shrink at the bad step and its growth after
``incr_every_n_steps`` good ones, the good / bad / skipped counters
exactly, finite losses within rtol 1e-5, and params within the train
test's bound (2 x lr, float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.amp import GradScaler as JGradScaler
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import HybridMesh, HybridParallelConfig
from paddle_tpu.distributed import SpmdTrainStep as JStep
from paddle_tpu.distributed import gpt_loss_fn as jgpt_loss_fn
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import GPTModel as JGPTModel
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
from paddle_tpu_torch.models import GPTForPretraining, \
    load_paddle_tpu_state_dict
from paddle_tpu_torch.models.gpt import GPTConfig, gpt_config
from paddle_tpu_torch.optimizer import SGD, AdamW, Momentum

LR = 1e-3
CFG = dict(vars(gpt_config("gpt-test")), hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
POISON = [1.0, float("inf"), 1.0, 1.0, 1.0]
SCALER = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)


def _jloss(model, state, batch):
    return jgpt_loss_fn(model, state, batch) * jnp.mean(batch["poison"])


def _tloss(model, state, batch):
    return gpt_loss_fn(model, state, batch) * batch["poison"].mean()


def _batches():
    rng = np.random.default_rng(23)
    out = []
    for poison in POISON:
        ids = rng.integers(0, CFG["vocab_size"], (2, 33))
        out.append((ids, np.full((2,), poison, np.float32)))
    return out


def _counters(state):
    return {k: float(v) for k, v in state["scaler"].items()}


@pytest.mark.parametrize("opt", ["AdamW", "Momentum"])
def test_scaler_step_matches_make_scaler_step(opt):
    """AdamW (the Adam kernel's path: its found-inf flag) and Momentum
    (the torch rule's ``where`` gate) under the scaler, five steps with
    an inf at step 2."""
    paddle_tpu.seed(7)
    jmodel = JGPT(JGPTModel(JConfig(**CFG)))
    jmodel.train()
    mesh = HybridMesh(HybridParallelConfig(), devices=jax.devices()[:1])
    jopt = {"AdamW": lambda: JAdamW(learning_rate=LR, weight_decay=0.01),
            "Momentum": lambda: JMomentum(learning_rate=LR)}[opt]()
    jstep = JStep(jmodel, _jloss, jopt, mesh, donate=False,
                  scaler=JGradScaler(**SCALER))
    jparams, jstate = jstep.init()
    model = GPTForPretraining(GPTConfig(**CFG), device="cpu")
    arrays = {k: np.asarray(v) for k, v in jparams.items()}
    arrays.update({f"gpt.h.{i}.attn.qkv_layout": np.asarray(1, np.int32)
                   for i in range(CFG["num_hidden_layers"])})
    load_paddle_tpu_state_dict(model, arrays)
    model.train()
    topt = {"AdamW": lambda: AdamW(learning_rate=LR, weight_decay=0.01),
            "Momentum": lambda: Momentum(learning_rate=LR)}[opt]()
    step = SpmdTrainStep(model, _tloss, topt, scaler=GradScaler(**SCALER))
    params, state = step.init()
    want_scale = [1024.0, 512.0, 512.0, 1024.0, 1024.0]
    for i, (ids, poison) in enumerate(_batches()):
        before = {n: p.clone() for n, p in params.items()}
        slots = [s.clone() for n in sorted(state["slots"])
                 for s in state["slots"][n].values()]
        jl, jparams, jstate = jstep(
            jparams, jstate,
            {"input_ids": jnp.asarray(ids[:, :-1], jnp.int32),
             "labels": jnp.asarray(ids[:, 1:], jnp.int32),
             "poison": jnp.asarray(poison)}, jax.random.PRNGKey(i))
        loss, params, state = step(
            params, state, {"input_ids": torch.from_numpy(ids[:, :-1]),
                            "labels": torch.from_numpy(ids[:, 1:]),
                            "poison": torch.from_numpy(poison)}, i)
        jc = {k: float(np.asarray(v)) for k, v in jstate["scaler"].items()}
        assert _counters(state) == jc, i
        assert _counters(state)["scale"] == want_scale[i]
        assert int(state["step"]) == int(np.asarray(jstate["step"]))
        if np.isfinite(poison[0]):
            np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        else:
            assert not np.isfinite(float(loss)) and not np.isfinite(
                float(jl))
            assert all(torch.equal(before[n], p) for n, p in params.items())
            assert all(torch.equal(a, b) for a, b in zip(slots, [
                s for n in sorted(state["slots"])
                for s in state["slots"][n].values()]))
        diffs = [np.abs(np.asarray(jparams[k]) - params[k].numpy()).max()
                 for k in params]
        assert max(diffs) <= 2 * LR
    snap = step.metrics_snapshot(state)
    assert snap["found_inf_skips"] == 1 and snap["loss_scale"] == 1024.0
    assert int(state["step"]) == len(POISON) - 1


def _pairs(seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in {"w": (5, 7), "b": (7,)}.items()}
    gs = [{k: rng.standard_normal(v.shape).astype(np.float32) * 512
           for k, v in p.items()} for _ in range(4)]
    gs[1]["b"][3] = np.inf
    return p, gs


def test_eager_grad_scaler_matches_reference():
    """The eager scaler around ``SGD.step()``: scaled grads unscaled in
    float32, the step with an inf skipped, the scale halved there and
    doubled after two good steps; params equal to the reference's."""
    p, gs = _pairs(4)
    jps = [JParameter(jnp.asarray(v), name=k) for k, v in p.items()]
    tps = [torch.nn.Parameter(torch.tensor(v)) for v in p.values()]
    jo, to = JSGD(learning_rate=0.1, parameters=jps), \
        SGD(learning_rate=0.1, parameters=tps)
    kw = dict(init_loss_scaling=512.0, incr_every_n_steps=2)
    js, ts = JGradScaler(**kw), GradScaler(**kw)
    assert ts.is_enable() and ts.is_use_dynamic_loss_scaling()
    scales = []
    for g in gs:
        for jp, tp, k in zip(jps, tps, p):
            jp._grad = JTensor(jnp.asarray(g[k]))
            tp.grad = torch.tensor(g[k])
        js.step(jo)
        ts.step(to)
        scales.append(ts.get_loss_scaling())
        assert ts.get_loss_scaling() == js.get_loss_scaling()
    assert scales == [512.0, 256.0, 256.0, 512.0]
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._value),
                                   rtol=1e-6, atol=1e-6)
    assert float(ts.scale(torch.tensor(2.0))) == 1024.0
    assert ts.state_dict() == js.state_dict()
    twin = GradScaler()
    twin.load_state_dict(ts.state_dict())
    assert twin.get_loss_scaling() == 512.0


def test_scaler_minimize_and_disabled():
    """``minimize`` runs backward, the scaled step and ``clear_grad``; a
    disabled scaler leaves the loss and the step alone."""
    par = torch.nn.Parameter(torch.ones(3))
    opt = SGD(learning_rate=0.5, parameters=[par])
    sc = GradScaler(init_loss_scaling=8.0)
    sc.minimize(opt, sc.scale((par * 2).sum()))
    assert torch.allclose(par.detach(), torch.zeros(3)) and par.grad is None
    off = GradScaler(enable=False)
    loss = (par * 3).sum()
    assert off.scale(loss) is loss
    loss.backward()
    off.step(opt)
    assert torch.allclose(par.detach(), torch.full((3,), -1.5))
