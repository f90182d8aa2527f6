"""The port's BERT against paddle_tpu's on the same weights.

paddle_tpu's BERT is built from a seed, its parameters exported as numpy
arrays and loaded into the port (`load_paddle_tpu_state_dict`; the MLM
decoder is tied to the word embedding in both). The reference runs its
Pallas kernels in interpret mode with its gates open, as on a TPU; the
port runs its plain versions on the CPU. Checked:

- a masked `BertForPretraining` forward ([B, 1, 1, S] bool key padding,
  S=128, so both take the general flash path): MLM and NSP logits
  within 2e-6 of the tensor's largest |value| (16 float32 ulps of it:
  summation order; the reference's default initializers make logits of
  up to about 25, and a logit's rounding error follows that scale, not
  its own);
- an unmasked forward, which both send through the qkv-direct branch of
  MultiHeadAttention (the which-major qkv3 kernels; the port's plain
  version), at the same tolerance;
- three ``SpmdTrainStep`` AdamW steps at dropout 0 (MLM + NSP loss)
  against the reference's on a one-device ``HybridMesh``: losses at rtol
  1e-5, step-1 grads at atol 1e-5 (the tied embedding's gradient sums
  both uses), parameters after step 3 as test_torch_train.py bounds
  them (2*lr per element, mean |diff| < 1e-6). The key projections'
  biases are held apart: their true gradient is exactly 0 (softmax does
  not see a constant added to a row's scores), so both sides' round-off
  (about 1e-9) is what Adam normalises into steps of about lr; their
  grads are held at 1e-6 of 0 instead;
- the state-dict round trip with the tied embedding, and the arguments
  that earlier slices refused (the fused layers' cache, ``need_weights``,
  MHA's cache: served since the decoder slice; a CUDA tensor in the qkv3
  entry goes to the kernel wrapper, never to the plain version).
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
from paddle_tpu.jit.api import functional_call as jfunctional_call
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBertPre
from paddle_tpu.models.bert import BertModel as JBertModel
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.distributed import SpmdTrainStep
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     BertForSequenceClassification,
                                     BertModel, export_paddle_tpu_state_dict,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.nn import MultiHeadAttention, init_weights
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

ATOL = 1e-5
LOGITS_REL = 2e-6
LR, WD, STEPS = 1e-3, 0.01, 3
B, S = 2, 128
#: the small masked-path config: h 64, 2 layers, 2 heads (d 32), vocab 128
CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128,
           max_position_embeddings=128, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
#: d 64, so the unmasked forward takes the qkv-direct branch (D 64 or 128)
QKV3_CFG = dict(CFG, hidden_size=128)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """paddle_tpu's Pallas kernels in interpret mode with their gates
    open. Its fallback counters are process-wide, and another test in
    the same worker may have left a count: they are reset before the
    test (which asserts them empty) and after it."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    monkeypatch.setattr(jkernels, "pallas_available", lambda: True)
    jkernels.reset_kernel_fallback_counters()
    yield
    jkernels.reset_kernel_fallback_counters()


def test_fixture_clears_a_fallback_count_left_by_an_earlier_test(request):
    """The reference's fallback registry is process-wide: a count left by
    an earlier test in the same worker must not reach the tests that
    assert it empty."""
    jkernels._note_fallback("flash_attention", "left by an earlier test")
    request.getfixturevalue("pallas_interpret")
    assert jkernels.kernel_fallback_counters() == {}


def _both(cfg, seed=7):
    """The reference's BertForPretraining and the port's with its
    weights."""
    paddle_tpu.seed(seed)
    jmodel = JBertPre(JBertModel(JBertConfig(**cfg)))
    jmodel.eval()
    arrays = {n: np.asarray(p._value) for n, p in jmodel.named_parameters()}
    model = load_paddle_tpu_state_dict(
        BertForPretraining(BertConfig(**cfg), device="cpu"), arrays)
    return jmodel, model, arrays


def _batch(vocab, seed):
    """Numpy: ids, the [B, 1, 1, S] key-padding mask, MLM labels on ~15%
    of the real positions (-100 elsewhere), NSP labels."""
    rng = np.random.default_rng(seed)
    lens = np.array([S, 77])
    real = np.arange(S)[None] < lens[:, None]
    ids = rng.integers(0, vocab, (B, S)) * real
    pick = real & (rng.uniform(size=(B, S)) < 0.15)
    return {"input_ids": ids, "attention_mask": real[:, None, None, :],
            "mlm_labels": np.where(pick, ids, -100),
            "nsp_labels": rng.integers(0, 2, (B,))}


def _loss(model, state, batch):
    logits, nsp = functional_call(model, state, (batch["input_ids"],),
                                  {"attention_mask": batch["attention_mask"]})
    return (F.cross_entropy(logits, batch["mlm_labels"])
            + F.cross_entropy(nsp, batch["nsp_labels"]))


def _jloss(model, state, batch):
    logits, nsp = jfunctional_call(
        model, state, JTensor(batch["input_ids"]),
        attention_mask=JTensor(batch["attention_mask"]))
    return (JF.cross_entropy(logits, JTensor(batch["mlm_labels"]))
            + JF.cross_entropy(nsp, JTensor(batch["nsp_labels"])))


def _forward_both(jmodel, model, ids, mask):
    jkw = {} if mask is None else {"attention_mask": JTensor(
        jnp.asarray(mask))}
    kw = {} if mask is None else {"attention_mask": torch.from_numpy(mask)}
    with jautograd.no_grad():
        jl, jn = jmodel(JTensor(jnp.asarray(ids)), **jkw)
    with torch.no_grad():
        tl, tn = model(torch.from_numpy(ids), **kw)
    return (np.asarray(jl._value), np.asarray(jn._value)), (tl.numpy(),
                                                           tn.numpy())


def test_masked_forward_matches_reference(pallas_interpret):
    jmodel, model, _ = _both(CFG)
    batch = _batch(CFG["vocab_size"], 1)
    want, got = _forward_both(jmodel, model, batch["input_ids"],
                              batch["attention_mask"])
    assert jkernels.kernel_fallback_counters() == {}
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, atol=LOGITS_REL * np.abs(w).max(),
                                   rtol=0)


def test_unmasked_forward_takes_qkv3_and_matches_reference(
        pallas_interpret, monkeypatch):
    jmodel, model, _ = _both(QKV3_CFG)
    ids = _batch(QKV3_CFG["vocab_size"], 2)["input_ids"]
    x = torch.zeros((B, S, 128))
    assert model.bert.encoder_layers[0].self_attn._qkv_direct_enabled(
        x, x, x, None)
    calls = []
    monkeypatch.setattr(
        "paddle_tpu_torch.nn.transformer.flash_attention_qkv3",
        lambda *a, **k: calls.append(1) or pfa.flash_attention_qkv3(*a, **k))
    want, got = _forward_both(jmodel, model, ids, None)
    assert len(calls) == QKV3_CFG["num_hidden_layers"]
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, atol=LOGITS_REL * np.abs(w).max(),
                                   rtol=0)


def _jax_grads(step, params, batch, key):
    names = [n for n, _ in step.model.named_parameters()]

    def loss_of(p):
        with jrng_guard(key), jautograd.no_grad():
            return _jloss(step.model, {n: p[n] for n in names},
                          batch)._value.astype(jnp.float32)

    return jax.value_and_grad(loss_of)(params)


def test_three_adamw_steps_match_spmd_train_step(pallas_interpret):
    paddle_tpu.seed(7)
    jmodel = JBertPre(JBertModel(JBertConfig(**CFG)))
    jmodel.train()
    mesh = HybridMesh(HybridParallelConfig(), devices=jax.devices()[:1])
    jstep = JStep(jmodel, _jloss, JAdamW(learning_rate=LR, weight_decay=WD),
                  mesh, donate=False)
    jparams, jstate = jstep.init()
    model = load_paddle_tpu_state_dict(
        BertForPretraining(BertConfig(**CFG), device="cpu"),
        {k: np.asarray(v) for k, v in jparams.items()})
    model.train()
    step = SpmdTrainStep(model, _loss, AdamW(learning_rate=LR,
                                             weight_decay=WD))
    params, state = step.init()
    assert set(params) == set(jparams)
    losses, jlosses = [], []
    for i in range(STEPS):
        nb = _batch(CFG["vocab_size"], 10 + i)
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        tb = {k: torch.from_numpy(v) for k, v in nb.items()}
        key = jax.random.PRNGKey(i)
        if i == 0:
            jgrads = _jax_grads(jstep, jparams, jb, key)[1]
            grads = step.loss_and_grads(params, tb, i)[1]
            for k, g in grads.items():
                np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                           atol=ATOL, rtol=0, err_msg=k)
                if k.endswith("k_proj.bias"):
                    assert np.abs(np.asarray(jgrads[k])).max() < 1e-6
                    assert g.abs().max() < 1e-6
        jl, jparams, jstate = jstep(jparams, jstate, jb, key)
        loss, params, state = step(params, state, tb, i)
        jlosses.append(float(jl))
        losses.append(float(loss))
    assert jkernels.kernel_fallback_counters() == {}
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    diffs = [np.abs(np.asarray(jparams[k]) - params[k].numpy())
             for k in jparams if not k.endswith("k_proj.bias")]
    assert max(d.max() for d in diffs) <= 2 * LR
    assert np.mean([d.mean() for d in diffs]) < 1e-6
    # the tied decoder is the trained word embedding itself
    assert model.cls.decoder_weight.data_ptr() == params[
        "bert.embeddings.word_embeddings.weight"].data_ptr()


def test_state_dict_round_trip_keeps_the_tie():
    model = BertForPretraining(BertConfig(**CFG), device="cpu", seed=3)
    arrays = export_paddle_tpu_state_dict(model)
    assert "cls.decoder_weight" not in arrays
    paddle_tpu.seed(0)
    jnames = {n for n, _ in JBertPre(JBertModel(JBertConfig(
        **CFG))).named_parameters()}
    assert set(arrays) == jnames
    twin = load_paddle_tpu_state_dict(
        BertForPretraining(BertConfig(**CFG), device="cpu", seed=4), arrays)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 twin.parameters()))
    assert twin.cls.decoder_weight is \
        twin.bert.embeddings.word_embeddings.weight
    with pytest.raises(ValueError, match="does not match"):
        load_paddle_tpu_state_dict(twin, dict(arrays, extra=np.zeros(1)))


def test_sequence_classification_head_shapes():
    model = BertForSequenceClassification(BertConfig(**CFG), num_classes=3,
                                          device="cpu")
    batch = _batch(CFG["vocab_size"], 5)
    out = model(torch.from_numpy(batch["input_ids"]),
                attention_mask=torch.from_numpy(batch["attention_mask"]))
    assert out.shape == (B, 3)


@pytest.mark.parametrize("what", ["fuse", "qkv3_cuda", "d_over_128",
                                  "need_weights", "cache"])
def test_later_slice_arguments_raise(what, monkeypatch):
    if what == "fuse":            # the fused BERT's serving cache: served
        layer = BertModel(BertConfig(**QKV3_CFG), fuse=True,
                          device="cpu").encoder_layers[0]
        x = torch.randn((1, 128, 128))
        empty = torch.zeros((2, 1, 0, 2, 64))     # [2, B, L, H, D]
        with torch.no_grad():
            torch.testing.assert_close(layer(x, cache=empty), layer(x),
                                       atol=1e-5, rtol=0)
    elif what == "qkv3_cuda":     # a CUDA tensor goes to the B5 wrapper
        monkeypatch.setattr(pfa, "runs_plain", lambda t, k: False)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            pfa.flash_attention_qkv3(torch.zeros((1, 128, 3 * 128)), 2)
    elif what == "d_over_128":    # where the kernels run (a card): no
        # longer refused; the launcher gets the heads at their own width
        x = torch.randn((1, 128, 2, 256))
        want = F.scaled_dot_product_attention(x, x, x)
        assert want.shape == x.shape
        seen = []

        def fwd(q, k, v, *args):
            seen.append(q.shape)
            return pfa.flash_reference(q, k, v, *args)

        monkeypatch.setattr(pfa, "runs_plain", lambda t, k: False)
        monkeypatch.setattr(pfa, "flash_attention_fwd", fwd)
        got = F.scaled_dot_product_attention(x, x, x)
        assert seen == [x.shape]
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    elif what == "need_weights":    # served: (out, None), as the reference
        mha = MultiHeadAttention(64, 2, need_weights=True, device="cpu")
        init_weights(mha, 0, 0.02)
        out, weights = mha(torch.zeros((1, 4, 64)))
        assert out.shape == (1, 4, 64) and weights is None
    else:                           # served: the cache grows by the step
        mha = MultiHeadAttention(64, 2, device="cpu")
        init_weights(mha, 0, 0.02)
        x = torch.randn((1, 4, 64))
        out, cache = mha(x, cache=mha.gen_cache(x))
        assert out.shape == (1, 4, 64) and cache.k.shape == (1, 4, 2, 32)
