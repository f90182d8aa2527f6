"""The port's GPT training against paddle_tpu's SpmdTrainStep.

The reference's initial weights are exported as numpy arrays and loaded
into the port; both then take three AdamW steps (lr 1e-3, wd 0.01,
global-norm clip 1.0) on the same numpy-seeded batches. The reference
runs ``SpmdTrainStep`` on a one-device CPU ``HybridMesh`` with its flash
kernels in interpret mode (Pallas forced on, as its own tests do); the
port's flash branch runs its plain version on the CPU.

Tolerances (float32): per-step loss rtol 1e-5 and step-1 grads atol 1e-5
(summation order only). Parameters after step 3: Adam moves an element
by about lr per step whatever the gradient's size, so a near-zero
gradient whose sign differs by rounding can cost up to 2*lr = 2e-3 on
that element; the bound used is that, and the mean |diff| must stay
under 1e-6. Under ``amp="bfloat16"`` the forward rounds differently in
the two frameworks: loss rtol 1e-2.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import kernels as jkernels
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.random import rng_guard as jrng_guard
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import HybridMesh, HybridParallelConfig
from paddle_tpu.distributed import SpmdTrainStep as JStep
from paddle_tpu.distributed import gpt_loss_fn as jgpt_loss_fn
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import GPTModel as JGPTModel
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
from paddle_tpu_torch.models import (GPTForPretraining,
                                     GPTPretrainingCriterion,
                                     export_paddle_tpu_state_dict,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.models.gpt import GPTConfig, gpt_config
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam, AdamW

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

LR, WD, CLIP, STEPS = 1e-3, 0.01, 1.0, 3
#: the small flash-eligible config: vocab 256, h 128, 2 layers, 2 heads
#: (d 64), ffn 256, max_pos 128, dropout 0
FLASH_CFG = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=256,
                 max_position_embeddings=128, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
#: gpt-test (composed branch) with its 0.1 dropouts set to 0
TEST_CFG = dict(vars(gpt_config("gpt-test")), hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    monkeypatch.setattr(jkernels, "pallas_available", lambda: True)


def _batches(vocab, b, s, n):
    rng = np.random.default_rng(17)
    return [rng.integers(0, vocab, (b, s + 1)) for _ in range(n)]


def _jax_batch(ids):
    return {"input_ids": jnp.asarray(ids[:, :-1], jnp.int32),
            "labels": jnp.asarray(ids[:, 1:], jnp.int32)}


def _torch_batch(ids):
    return {"input_ids": torch.from_numpy(ids[:, :-1]),
            "labels": torch.from_numpy(ids[:, 1:])}


def _jax_grads(step, params, batch, key):
    """Loss and grads of the reference's step loss (``loss_of`` of
    spmd.py:488-499)."""
    names = [n for n, _ in step.model.named_parameters()]
    amp = jnp.dtype(step.amp) if step.amp else None

    def loss_of(p):
        state = {n: (p[n].astype(amp) if amp is not None else p[n])
                 for n in names}
        with jrng_guard(key), jautograd.no_grad():
            loss = jgpt_loss_fn(step.model, state, batch)
        return loss._value.astype(jnp.float32)

    return jax.value_and_grad(loss_of)(params)


def _train_both(cfg, amp=None, s=128, b=2):
    paddle_tpu.seed(7)
    jmodel = JGPT(JGPTModel(JConfig(**cfg)))
    jmodel.train()
    mesh = HybridMesh(HybridParallelConfig(), devices=jax.devices()[:1])
    jstep = JStep(jmodel, jgpt_loss_fn,
                  JAdamW(learning_rate=LR, weight_decay=WD,
                         grad_clip=JClip(CLIP)), mesh, donate=False, amp=amp)
    jparams, jstate = jstep.init()
    model = GPTForPretraining(GPTConfig(**cfg), device="cpu")
    arrays = {k: np.asarray(v) for k, v in jparams.items()}
    arrays.update({f"gpt.h.{i}.attn.qkv_layout": np.asarray(1, np.int32)
                   for i in range(cfg["num_hidden_layers"])})
    load_paddle_tpu_state_dict(model, arrays)
    model.train()
    step = SpmdTrainStep(model, gpt_loss_fn,
                         AdamW(learning_rate=LR, weight_decay=WD,
                               grad_clip=ClipGradByGlobalNorm(CLIP)),
                         amp=amp)
    params, state = step.init()
    out = {"losses": [], "jlosses": []}
    for i, ids in enumerate(_batches(cfg["vocab_size"], b, s, STEPS)):
        key = jax.random.PRNGKey(i)
        if i == 0:
            out["jgrads"] = _jax_grads(jstep, jparams, _jax_batch(ids),
                                       key)[1]
            out["grads"] = step.loss_and_grads(params, _torch_batch(ids),
                                               i)[1]
        jl, jparams, jstate = jstep(jparams, jstate, _jax_batch(ids), key)
        loss, params, state = step(params, state, _torch_batch(ids), i)
        out["jlosses"].append(float(jl))
        out["losses"].append(float(loss))
    out.update(jparams=jparams, params=params, state=state)
    return out


def _check_params(out):
    diffs = [np.abs(np.asarray(out["jparams"][k]) - out["params"][k].numpy())
             for k in out["jparams"]]
    assert max(d.max() for d in diffs) <= 2 * LR
    assert np.mean([d.mean() for d in diffs]) < 1e-6


@pytest.mark.parametrize("cfg", [FLASH_CFG, TEST_CFG],
                         ids=["flash_branch", "gpt-test_composed"])
def test_three_adamw_steps_match_spmd_train_step(pallas_interpret, cfg):
    if cfg is FLASH_CFG:      # the reference really takes its flash branch
        probe = jnp.zeros((2, 128, 3 * 128), jnp.float32)
        assert jkernels.flash_attention_qkv_enabled(probe, 2, None, 0.0)
    out = _train_both(cfg, s=128 if cfg is FLASH_CFG else 64)
    np.testing.assert_allclose(out["losses"], out["jlosses"], rtol=1e-5)
    assert set(out["grads"]) == set(out["jgrads"])
    for k, g in out["grads"].items():
        np.testing.assert_allclose(g.numpy(), np.asarray(out["jgrads"][k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    _check_params(out)
    assert out["state"]["step"] == STEPS


def test_amp_bfloat16_matches(pallas_interpret):
    out = _train_both(FLASH_CFG, amp="bfloat16")
    np.testing.assert_allclose(out["losses"], out["jlosses"], rtol=1e-2)
    # float32 masters, float32 grads
    assert all(p.dtype == torch.float32 for p in out["params"].values())
    assert all(g.dtype == torch.float32 for g in out["grads"].values())


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_with_ignore_index(reduction, dtype):
    """The fused path (hard labels), ignore_index rows included, loss
    and gradient."""
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 6, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 6))
    labels[0, 2] = labels[1, 5] = -100

    def jloss(x):
        out = JF.cross_entropy(JTensor(x.astype(dtype)), JTensor(
            jnp.asarray(labels)), reduction=reduction)._value
        return jnp.sum(out * jnp.arange(1, out.size + 1).reshape(out.shape))

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    out = F.cross_entropy(x.to(getattr(torch, dtype)),
                          torch.from_numpy(labels), reduction=reduction)
    w = torch.arange(1, out.numel() + 1, dtype=out.dtype).reshape(out.shape)
    (out * w).sum().backward()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float((out * w).sum().detach()), float(jl),
                               rtol=tol)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=tol,
                               rtol=tol)
    if reduction == "none":
        assert out[0, 2] == 0 and out[1, 5] == 0


@pytest.mark.parametrize("kw", [dict(weight=True), dict(label_smoothing=0.1),
                                dict(soft_label=True)],
                         ids=["weight", "label_smoothing", "soft_label"])
def test_cross_entropy_composed_branches(kw):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((8, 20)).astype(np.float32)
    if kw.get("soft_label"):
        labels = rng.dirichlet(np.ones(20), 8).astype(np.float32)
    else:
        labels = rng.integers(0, 20, (8,))
        labels[3] = -100
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("weight"):
        wt = rng.uniform(0.5, 2.0, 20).astype(np.float32)
        jkw["weight"], tkw["weight"] = JTensor(jnp.asarray(wt)), \
            torch.from_numpy(wt)
    want = JF.cross_entropy(JTensor(jnp.asarray(logits)),
                            JTensor(jnp.asarray(labels)), **jkw)
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          **tkw)
    np.testing.assert_allclose(float(got), float(np.asarray(want._value)),
                               rtol=1e-6)


def test_pretraining_criterion_with_loss_mask():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 5, 30)).astype(np.float32)
    labels = rng.integers(0, 30, (2, 5))
    mask = (rng.uniform(size=(2, 5)) > 0.3).astype(np.float32)
    want = JCriterion()(JTensor(jnp.asarray(logits)),
                        JTensor(jnp.asarray(labels)),
                        JTensor(jnp.asarray(mask)))
    got = GPTPretrainingCriterion()(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(np.asarray(want._value)),
                               rtol=1e-6)


def test_bfloat16_slots_store_bf16_and_compute_in_f32():
    """One AdamW update with bfloat16 slot storage: the moments are
    stored in bf16, and the new parameter and moments are the float32
    math of the bf16-stored moments, cast back."""
    rng = np.random.default_rng(8)
    p0 = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    opt = AdamW(learning_rate=0.1, weight_decay=0.01)
    params = {"w": p0.clone()}
    state = opt.init_state(params, slot_dtype=torch.bfloat16)
    assert state["slots"]["w"]["moment1"].dtype == torch.bfloat16
    for step in (1, 2):
        m_in = state["slots"]["w"]["moment1"].float()
        v_in = state["slots"]["w"]["moment2"].float()
        p_in = params["w"].clone()
        opt.apply_gradients(params, {"w": g}, state)
        m = 0.9 * m_in + (1 - 0.9) * g
        v = 0.999 * v_in + (1 - 0.999) * g * g
        upd = (m / (1 - np.float32(0.9) ** np.float32(step))) / (
            torch.sqrt(v / (1 - np.float32(0.999) ** np.float32(step)))
            + 1e-8)
        want = p_in * (1 - 0.1 * 0.01) - 0.1 * upd
        torch.testing.assert_close(params["w"], want, atol=1e-6, rtol=1e-6)
        slots = state["slots"]["w"]
        assert slots["moment1"].dtype == slots["moment2"].dtype \
            == torch.bfloat16
        assert torch.equal(slots["moment1"], m.to(torch.bfloat16))
        assert torch.equal(slots["moment2"], v.to(torch.bfloat16))
    assert state["step"] == 2


def test_adam_l2_decay_and_bf16_params_match_reference():
    """Adam (L2 decay folded into the gradient) on a bfloat16 parameter:
    the grad is cast to the param dtype, the math runs in float32."""
    from paddle_tpu.optimizer import Adam as JAdam

    rng = np.random.default_rng(9)
    p = rng.standard_normal((3, 7)).astype(np.float32)
    g = rng.standard_normal((3, 7)).astype(np.float32)
    jopt = JAdam(learning_rate=0.05, weight_decay=0.1)
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    js = jopt.init_state(jp)
    opt = Adam(learning_rate=0.05, weight_decay=0.1)
    tp = {"w": torch.from_numpy(p).to(torch.bfloat16)}
    ts = opt.init_state(tp)
    for _ in range(2):
        jp, js = jopt.apply_gradients(jp, {"w": jnp.asarray(g)}, js)
        opt.apply_gradients(tp, {"w": torch.from_numpy(g)}, ts)
    np.testing.assert_array_equal(tp["w"].float().numpy(),
                                  np.asarray(jp["w"].astype(jnp.float32)))


def test_export_round_trips_and_dropout_follows_the_key():
    cfg = dict(FLASH_CFG, hidden_dropout_prob=0.1,
               attention_probs_dropout_prob=0.1)
    model = GPTForPretraining(GPTConfig(**cfg), device="cpu", seed=3)
    arrays = export_paddle_tpu_state_dict(model)
    assert arrays["gpt.h.1.attn.qkv_layout"] == 1
    twin = load_paddle_tpu_state_dict(
        GPTForPretraining(GPTConfig(**cfg), device="cpu", seed=4), arrays)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 twin.parameters()))
    model.train()
    step = SpmdTrainStep(model, gpt_loss_fn, AdamW(learning_rate=LR))
    params, _ = step.init()
    assert export_paddle_tpu_state_dict(params).keys() == arrays.keys()
    batch = _torch_batch(_batches(256, 2, 128, 1)[0])
    l1, l2, l3 = (step.loss_and_grads(params, batch, k)[0]
                  for k in (11, 11, 12))
    assert l1 == l2 and l1 != l3
    model.eval()
    e1, e2 = (step.loss_and_grads(params, batch, k)[0] for k in (11, 12))
    assert e1 == e2


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(recompute=True),
                                dict(introspect=True)],
                         ids=lambda kw: next(iter(kw)))
def test_later_slice_arguments_raise(kw):
    model = GPTForPretraining("gpt-test", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        SpmdTrainStep(model, gpt_loss_fn, AdamW(), **kw)


def test_scaler_argument_trains():
    """``scaler=GradScaler()`` is ported: the step carries the scaler's
    device state, trains, and with finite grads neither skips nor
    shrinks the scale."""
    from paddle_tpu_torch.amp import GradScaler

    model = GPTForPretraining(GPTConfig(**TEST_CFG), device="cpu", seed=2)
    model.train()
    step = SpmdTrainStep(model, gpt_loss_fn, AdamW(learning_rate=LR),
                         scaler=GradScaler(init_loss_scaling=1024.0))
    params, state = step.init()
    before = {n: p.clone() for n, p in params.items()}
    losses = [float(step(params, state, _torch_batch(ids), i)[0])
              for i, ids in enumerate(_batches(TEST_CFG["vocab_size"], 2,
                                               32, 2))]
    assert all(np.isfinite(losses))
    assert any(not torch.equal(before[n], p) for n, p in params.items())
    snap = step.metrics_snapshot(state)
    assert snap["found_inf_skips"] == 0 and snap["loss_scale"] == 1024.0
    assert int(state["step"]) == 2 and snap["steps"] == 2


def test_init_hands_back_the_models_own_parameters():
    """``init()`` keeps no second copy of the weights: its dict holds the
    model's own storage, so a step trains the model itself; only a
    ``dtype`` that differs from a parameter's makes a new tensor."""
    model = GPTForPretraining(GPTConfig(**FLASH_CFG), device="cpu", seed=5)
    model.train()
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    step = SpmdTrainStep(model, gpt_loss_fn, AdamW(learning_rate=LR))
    params, state = step.init()
    assert all(params[n].data_ptr() == p.data_ptr()
               for n, p in named.items())
    step(params, state, _torch_batch(_batches(256, 2, 128, 1)[0]), 0)
    assert all(not torch.equal(before[n], p) for n, p in named.items())
    same, _ = step.init(dtype="float32")
    assert all(same[n].data_ptr() == p.data_ptr() for n, p in named.items())
    cast, _ = step.init(dtype="bfloat16")
    assert all(cast[n].dtype == torch.bfloat16
               and torch.equal(cast[n], p.detach().to(torch.bfloat16))
               for n, p in named.items())


def test_gpt_forward_without_flash_gate_runs_composed_on_cpu():
    """A flash config whose shape the qkv gate refuses (S=64) runs the
    composed branch, as the reference does there; a mask at S=128 takes
    the general flash branch (its plain version on the CPU), as the
    reference does. Both agree with the qkv flash branch where it
    applies."""
    model = GPTForPretraining(GPTConfig(**FLASH_CFG), device="cpu", seed=1)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 128)))
    flash = model(ids)
    causal = torch.ones((128, 128), dtype=torch.bool).tril()
    masked = model(ids, attn_mask=causal)
    torch.testing.assert_close(flash, masked, atol=1e-5, rtol=0)
    assert model(ids[:, :64]).shape == (1, 64, 256)
    # the concat-grow cache path (ported with generation) takes the
    # composed branch and agrees as well
    cached, caches = model(ids, caches=model.gen_cache(1))
    torch.testing.assert_close(cached, flash, atol=1e-5, rtol=0)
    assert tuple(caches[0][0].shape) == (1, 128, 2, 64)
