"""The port's fused BERT (``BertModel(fuse=True)``, the incubate fused
layers) and its unmasked unfused BERT against paddle_tpu's.

paddle_tpu's model is built from a seed, its parameters exported as numpy
arrays and loaded into the port's. The reference runs its Pallas kernels
in interpret mode with its gates open, as on a TPU; the port runs its
plain versions on the CPU. Checked:

- forwards of the fused `BertForPretraining`, unmasked (both take the
  pair-major qkv flash branch on the shuffled ``qkv_weight``) and masked
  ([B, 1, 1, S] key padding: the general flash branch): MLM and NSP
  logits within 2e-6 of the tensor's largest |value| (as
  tests/test_torch_bert.py bounds them: float32 summation order at the
  scale of logits of up to about 25);
- three ``SpmdTrainStep`` AdamW steps at dropout 0 (MLM + NSP loss) of
  the fused model, unmasked, and of the unfused one, unmasked (its
  attention in the which-major qkv3 branch), against the reference's on
  a one-device ``HybridMesh``, bounded as tests/test_torch_bert.py bounds
  them: losses at rtol 1e-5, step-1 grads at atol 1e-5, parameters after
  step 3 within 2*lr per element and 1e-6 on average. The key biases
  (the fused ``qkv_bias[1]``) are held as grads at 1e-6 of 0 and left out
  of the parameter bound (their true gradient is 0, so Adam normalises
  round-off into steps of about lr). A post-LN fused layer never reads
  ``pre_ln_scale``/``pre_ln_bias``/``ffn._ln1_*``: both sides give them a
  zero gradient and only AdamW's decay moves them, to the same values;
- the fused state-dict round trip, key for key with the reference's;
- the other fused functionals and layers against the reference's at
  atol 1e-5; the fused layers' init; the serving pieces, refused by
  earlier slices, now served (and nranks > 1 refused by name).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import paddle_tpu
from paddle_tpu import kernels as jkernels
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.random import rng_guard as jrng_guard
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import HybridMesh, HybridParallelConfig
from paddle_tpu.distributed import SpmdTrainStep as JStep
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.jit.api import functional_call as jfunctional_call
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBertPre
from paddle_tpu.models.bert import BertModel as JBertModel
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.distributed import SpmdTrainStep
from paddle_tpu_torch.incubate.nn import (FusedBiasDropoutResidualLayerNorm,
                                          FusedMultiHeadAttention,
                                          FusedMultiTransformer,
                                          FusedTransformerEncoderLayer)
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     BertModel, export_paddle_tpu_state_dict,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import init_weights
from paddle_tpu_torch.optimizer import AdamW

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

ATOL = 1e-5
LOGITS_REL = 2e-6
LR, WD, STEPS = 1e-3, 0.01, 3
B, S = 2, 128
#: h 128, 2 layers, 2 heads (d 64, so the qkv kernels' gate takes it)
CFG = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=256,
           max_position_embeddings=128, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
NEVER_READ = ("fused_attn.pre_ln_scale", "fused_attn.pre_ln_bias",
              "ffn._ln1_scale", "ffn._ln1_bias")


@pytest.fixture
def pallas_interpret(monkeypatch):
    """paddle_tpu's Pallas kernels in interpret mode with their gates
    open; its process-wide fallback counters reset before (the test
    asserts them empty) and after."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    monkeypatch.setattr(jkernels, "pallas_available", lambda: True)
    jkernels.reset_kernel_fallback_counters()
    yield
    jkernels.reset_kernel_fallback_counters()


def _jmodel(fuse, seed=7):
    paddle_tpu.seed(seed)
    return JBertPre(JBertModel(JBertConfig(**CFG), fuse=fuse))


def _port(fuse, arrays):
    return load_paddle_tpu_state_dict(
        BertForPretraining(BertConfig(**CFG), fuse=fuse, device="cpu"),
        arrays)


def _arrays(jmodel):
    return {n: np.asarray(p._value) for n, p in jmodel.named_parameters()}


def _batch(vocab, seed, masked):
    """Numpy: ids, (the [B, 1, 1, S] key-padding mask,) MLM labels on
    ~15% of the real positions (-100 elsewhere), NSP labels."""
    rng = np.random.default_rng(seed)
    lens = np.array([S, 77]) if masked else np.array([S, S])
    real = np.arange(S)[None] < lens[:, None]
    ids = rng.integers(0, vocab, (B, S)) * real
    pick = real & (rng.uniform(size=(B, S)) < 0.15)
    out = {"input_ids": ids, "mlm_labels": np.where(pick, ids, -100),
           "nsp_labels": rng.integers(0, 2, (B,))}
    if masked:
        out["attention_mask"] = real[:, None, None, :]
    return out


def _loss(model, state, batch):
    kw = ({"attention_mask": batch["attention_mask"]}
          if "attention_mask" in batch else {})
    logits, nsp = functional_call(model, state, (batch["input_ids"],), kw)
    return (F.cross_entropy(logits, batch["mlm_labels"])
            + F.cross_entropy(nsp, batch["nsp_labels"]))


def _jloss(model, state, batch):
    kw = ({"attention_mask": JTensor(batch["attention_mask"])}
          if "attention_mask" in batch else {})
    logits, nsp = jfunctional_call(model, state,
                                   JTensor(batch["input_ids"]), **kw)
    return (JF.cross_entropy(logits, JTensor(batch["mlm_labels"]))
            + JF.cross_entropy(nsp, JTensor(batch["nsp_labels"])))


@pytest.mark.parametrize("masked", [False, True])
def test_fused_forward_matches_reference(pallas_interpret, monkeypatch,
                                         masked):
    jmodel = _jmodel(True)
    jmodel.eval()
    model = _port(True, _arrays(jmodel))
    calls = []
    monkeypatch.setattr(
        "paddle_tpu_torch.incubate.nn.functional.flash_attention_qkv",
        lambda *a, **k: calls.append(1) or pfa.flash_attention_qkv(*a, **k))
    batch = _batch(CFG["vocab_size"], 1 + masked, masked)
    jkw, kw = {}, {}
    if masked:
        jkw["attention_mask"] = JTensor(jnp.asarray(batch["attention_mask"]))
        kw["attention_mask"] = torch.from_numpy(batch["attention_mask"])
    with jautograd.no_grad():
        want = jmodel(JTensor(jnp.asarray(batch["input_ids"])), **jkw)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["input_ids"]), **kw)
    assert jkernels.kernel_fallback_counters() == {}
    assert len(calls) == (0 if masked else CFG["num_hidden_layers"])
    for a, w in zip(got, want):
        w = np.asarray(w._value)
        np.testing.assert_allclose(a.numpy(), w,
                                   atol=LOGITS_REL * np.abs(w).max(), rtol=0)


def _jax_grads(step, params, batch, key):
    names = [n for n, _ in step.model.named_parameters()]

    def loss_of(p):
        with jrng_guard(key), jautograd.no_grad():
            return _jloss(step.model, {n: p[n] for n in names},
                          batch)._value.astype(jnp.float32)

    return jax.value_and_grad(loss_of)(params)


def _is_key_bias(name):
    return name.endswith("k_proj.bias")


def _held(name, a):
    """The part of a parameter the step-3 bound holds: all of it, except
    the key biases (the fused qkv_bias[1])."""
    return a[[0, 2]] if name.endswith("qkv_bias") else a


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_three_unmasked_adamw_steps_match_spmd_train_step(pallas_interpret,
                                                          fuse):
    jmodel = _jmodel(fuse)
    jmodel.train()
    mesh = HybridMesh(HybridParallelConfig(), devices=jax.devices()[:1])
    jstep = JStep(jmodel, _jloss, JAdamW(learning_rate=LR, weight_decay=WD),
                  mesh, donate=False)
    jparams, jstate = jstep.init()
    model = _port(fuse, {k: np.asarray(v) for k, v in jparams.items()})
    model.train()
    step = SpmdTrainStep(model, _loss, AdamW(learning_rate=LR,
                                             weight_decay=WD))
    params, state = step.init()
    assert set(params) == set(jparams)
    start = {k: v.clone() for k, v in params.items()}
    losses, jlosses = [], []
    for i in range(STEPS):
        nb = _batch(CFG["vocab_size"], 30 + i, masked=False)
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        tb = {k: torch.from_numpy(v) for k, v in nb.items()}
        key = jax.random.PRNGKey(i)
        if i == 0:
            jgrads = _jax_grads(jstep, jparams, jb, key)[1]
            grads = step.loss_and_grads(params, tb, i)[1]
            for k, g in grads.items():
                want = np.asarray(jgrads[k])
                np.testing.assert_allclose(g.numpy(), want, atol=ATOL,
                                           rtol=0, err_msg=k)
                if _is_key_bias(k) or k.endswith("qkv_bias"):
                    kb = 1 if k.endswith("qkv_bias") else slice(None)
                    assert np.abs(want[kb]).max() < 1e-6
                    assert g[kb].abs().max() < 1e-6
                if k.endswith(NEVER_READ):
                    assert not g.any() and not want.any()
        jl, jparams, jstate = jstep(jparams, jstate, jb, key)
        loss, params, state = step(params, state, tb, i)
        jlosses.append(float(jl))
        losses.append(float(loss))
    assert jkernels.kernel_fallback_counters() == {}
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    diffs = [np.abs(_held(k, np.asarray(jparams[k]))
                    - _held(k, params[k].numpy()))
             for k in jparams if not _is_key_bias(k)]
    assert max(d.max() for d in diffs) <= 2 * LR
    assert np.mean([d.mean() for d in diffs]) < 1e-6
    decay = (1 - LR * WD) ** STEPS
    for k in params:
        if k.endswith(NEVER_READ):      # moved by the decay alone
            torch.testing.assert_close(params[k], start[k] * decay)
            np.testing.assert_allclose(np.asarray(jparams[k]),
                                       params[k].numpy(), atol=1e-7, rtol=0)


def test_fused_state_dict_round_trip():
    model = BertForPretraining(BertConfig(**CFG), fuse=True, device="cpu",
                               seed=3)
    arrays = export_paddle_tpu_state_dict(model)
    assert set(arrays) == set(_arrays(_jmodel(True, seed=0)))
    twin = load_paddle_tpu_state_dict(
        BertForPretraining(BertConfig(**CFG), fuse=True, device="cpu",
                           seed=4), arrays)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 twin.parameters()))
    with pytest.raises(ValueError, match="does not match"):
        load_paddle_tpu_state_dict(
            BertForPretraining(BertConfig(**CFG), device="cpu"), arrays)


def test_fused_layers_start_from_the_unfused_distribution():
    """Matrices normal(0, initializer_range), biases 0, LN scales 1: the
    fused model draws its matrices by the unfused one's rule."""
    cfg = BertConfig(**dict(CFG, hidden_size=256, intermediate_size=512))
    fused = BertModel(cfg, fuse=True, device="cpu", seed=1)
    layer = fused.encoder_layers[0]
    for w in (layer.fused_attn.qkv_weight, layer.fused_attn.linear_weight,
              layer.ffn.linear1_weight, layer.ffn.linear2_weight):
        assert abs(w.mean().item()) < 2e-3
        assert abs(w.std().item() - cfg.initializer_range) < 2e-3
    for name, p in layer.named_parameters():
        if name.endswith(("bias", "_bias")):
            assert not p.any(), name
        elif name.endswith(("ln_scale", "_ln1_scale", "_ln2_scale")):
            assert torch.equal(p, torch.ones_like(p)), name


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_heads_are_drawn_after_the_encoder_not_from_a_fresh_stream(fuse):
    """One generator draws the whole model: the MLM transform's weight
    (the heads' first draw) is no copy of the word embedding's first
    rows (the encoder's first draw), as a second generator from the same
    seed would make it."""
    model = BertForPretraining(BertConfig(**CFG), fuse=fuse, device="cpu",
                               seed=5)
    emb = model.bert.embeddings.word_embeddings.weight
    head = model.cls.transform.weight
    assert not torch.equal(head, emb[:head.shape[0]])
    assert model.cls.decoder_weight is emb
    twin = BertForPretraining(BertConfig(**CFG), fuse=fuse, device="cpu",
                              seed=5)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 twin.parameters()))


@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_feedforward_matches_reference(pre_ln):
    rng = np.random.default_rng(40 + pre_ln)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    w1, w2 = (rng.standard_normal(s).astype(np.float32) * 0.2
              for s in ((32, 64), (64, 32)))
    b1, b2 = (rng.standard_normal(n).astype(np.float32) for n in (64, 32))
    ln = [rng.standard_normal(32).astype(np.float32) for _ in range(4)]
    args = (x, w1, w2, b1, b2, *ln)
    kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, activation="gelu",
              pre_layer_norm=pre_ln)
    want = JIF.fused_feedforward(*(JTensor(jnp.asarray(a)) for a in args),
                                 **kw)._value
    got = IF.fused_feedforward(*(torch.from_numpy(a) for a in args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_fused_bias_dropout_residual_layer_norm_matches_reference():
    rng = np.random.default_rng(50)
    x, res = (rng.standard_normal((2, 8, 32)).astype(np.float32)
              for _ in range(2))
    bias, g, b = (rng.standard_normal(32).astype(np.float32)
                  for _ in range(3))
    args = (x, res, bias, g, b)
    want = JIF.fused_bias_dropout_residual_layer_norm(
        *(JTensor(jnp.asarray(a)) for a in args), dropout_rate=0.0)._value
    got = IF.fused_bias_dropout_residual_layer_norm(
        *(torch.from_numpy(a) for a in args), dropout_rate=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    layer = FusedBiasDropoutResidualLayerNorm(32, dropout_rate=0.0,
                                              device="cpu")
    with torch.no_grad():
        layer.linear_bias.copy_(torch.from_numpy(bias))
        layer.ln.weight.copy_(torch.from_numpy(g))
        layer.ln.bias.copy_(torch.from_numpy(b))
    torch.testing.assert_close(layer(torch.from_numpy(x),
                                     torch.from_numpy(res)), got)


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_fused_matmul_bias_and_linear_match_reference(tx, ty):
    rng = np.random.default_rng(60 + 2 * tx + ty)
    x = rng.standard_normal((3, 16, 8) if tx else (3, 8, 16))
    y = rng.standard_normal((12, 16) if ty else (16, 12))
    bias = rng.standard_normal(12)
    x, y, bias = (a.astype(np.float32) for a in (x, y, bias))
    want = JIF.fused_matmul_bias(*(JTensor(jnp.asarray(a))
                                   for a in (x, y, bias)), tx, ty)._value
    got = IF.fused_matmul_bias(*(torch.from_numpy(a) for a in (x, y, bias)),
                               transpose_x=tx, transpose_y=ty)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    if not tx:
        lin = IF.fused_linear(*(torch.from_numpy(a) for a in (x, y, bias)),
                              transpose_weight=ty)
        torch.testing.assert_close(lin, got)


def test_downscale_in_infer_dropout_raises_by_name():
    x = torch.ones((2, 4, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        IF.fused_bias_dropout_residual_layer_norm(
            x, x, mode="downscale_in_infer")


@pytest.mark.parametrize("what", ["cache_kv", "multi_transformer",
                                  "functional_multi_transformer",
                                  "need_weights"])
def test_serving_pieces_raise_by_name(what):
    """The serving pieces this slice refused are served since the decoder
    slice (tests/test_torch_fused_mt.py holds them against the
    reference); what stays refused names its queue item."""
    if what == "cache_kv":
        layer = FusedTransformerEncoderLayer(64, 2, 128, device="cpu")
        init_weights(layer, 0, 0.02)
        layer.eval()
        x = torch.randn((1, 4, 64))
        with torch.no_grad():
            torch.testing.assert_close(
                layer(x, cache=torch.zeros((2, 1, 0, 2, 32))), layer(x),
                atol=1e-5, rtol=0)
    elif what == "multi_transformer":
        stack = FusedMultiTransformer(64, 2, 128, device="cpu")
        assert stack.num_layers == 1
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            FusedMultiTransformer(64, 2, 128, nranks=2, device="cpu")
    elif what == "functional_multi_transformer":
        stack = FusedMultiTransformer(64, 2, 128, num_layers=2,
                                      device="cpu")
        init_weights(stack, 0, 0.02)
        x = torch.randn((1, 4, 64))
        lists = [list(p) for p in stack.children()]
        with torch.no_grad():
            torch.testing.assert_close(IF.fused_multi_transformer(x, *lists),
                                       stack(x))
    else:
        attn = FusedMultiHeadAttention(64, 2, need_weights=True,
                                       device="cpu")
        init_weights(attn, 0, 0.02)
        assert attn(torch.zeros((1, 4, 64))).shape == (1, 4, 64)
