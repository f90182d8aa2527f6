"""The models' white-list products under `amp.auto_cast`, against the
reference's: GPT's tied LM head, BERT's MLM head, the fused layers and
the quantized linear compute through `ops.matmul`, as the reference's
through ``ops.matmul`` / ``Tensor.matmul`` (the white list's
``matmul``).

``gpt-test`` and a small BERT (dropout 0, lengths that take the composed
attention in both packages) run a forward and a backward under O1 and
O2 (`amp.decorate` on both sides) in float16, on the reference's weights
and the same batch: the logits' dtype is the reference's (float16 for
GPT at both levels), the logits lie within 8 float16 ulps of the
reference's at their largest magnitude, and the grads follow
`test_torch_amp_transformer.py`'s rule (relative L2 within twice the
reference's own distance from the float32 model, each tensor's median
element within 32 ulps). With AMP off, logits and grads are bit for bit
those of the ``torch.matmul`` composition the repair replaced. The
fused sites (`fused_multi_head_attention`, `fused_feedforward`,
`fused_matmul_bias`) and the quantized linear are held alike."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.incubate.nn import functional as jIF
from paddle_tpu.jit.api import functional_call as jfunctional_call
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBertPre
from paddle_tpu.models.bert import BertModel as JBertModel
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import GPTModel as JGPTModel
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion
from paddle_tpu.nn import functional as jF
from paddle_tpu.quantization import layers as jql
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.incubate.nn import functional as pIF
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     GPTForPretraining,
                                     GPTPretrainingCriterion,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.models.gpt import GPTConfig, gpt_config
from paddle_tpu_torch.nn import functional as pF
from paddle_tpu_torch.quantization import layers as pql

import _torch_layers as tl
from _torch_ops import rand
from test_torch_amp_transformer import GRAD_NOISE, MEDIAN_ULPS, _ulps

ULP16 = 2.0 ** -11
ULPS = 8
#: the loss scale of each model's float16 backward, as a `GradScaler`
#: settles it: large enough that the small GPT's cotangents are normal
#: float16 numbers, small enough that BERT's largest grads do not
#: overflow (at 2^15 some reach inf in both packages)
SCALES = {"gpt": 2.0 ** 15, "bert": 2.0 ** 8}
GPT_CFG = dict(vars(gpt_config("gpt-test")), hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
BERT_CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=128,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
B, S = 2, 24


def _gpt_pair():
    paddle_tpu.seed(11)
    jmodel = JGPT(JGPTModel(JConfig(**GPT_CFG)))
    jmodel.eval()
    model = load_paddle_tpu_state_dict(
        GPTForPretraining(GPTConfig(**GPT_CFG), device="cpu"),
        tl.arrays(jmodel))
    return jmodel, model.requires_grad_(True).eval()


def _bert_pair():
    paddle_tpu.seed(12)
    jmodel = JBertPre(JBertModel(JBertConfig(**BERT_CFG)))
    jmodel.eval()
    model = load_paddle_tpu_state_dict(
        BertForPretraining(BertConfig(**BERT_CFG), device="cpu"),
        tl.arrays(jmodel))
    return jmodel, model.requires_grad_(True).eval()


def _ids(vocab, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, S)), rng.integers(0, vocab, (B, S))


def _gpt_loss_ref(logits, labels):
    return JCriterion()(logits, labels)


def _bert_loss_ref(out, labels):
    logits, nsp = out
    return jF.cross_entropy(logits, labels) + jF.cross_entropy(
        nsp, JTensor(jnp.zeros((B,), jnp.int32)))


def _bert_loss(out, labels):
    logits, nsp = out
    return pF.cross_entropy(logits, labels) + pF.cross_entropy(
        nsp, torch.zeros(B, dtype=torch.int64))


def _ref_run(jmodel, ids, labels, loss_of, level, scale):
    """The reference's loss, first output and grads under O1/O2 float16
    (one jitted ``jax.value_and_grad`` of the scaled loss)."""
    params = {n: p._value for n, p in jmodel.named_parameters()}

    def f(p):
        with jautograd.no_grad():
            out = jfunctional_call(jmodel, p, JTensor(jnp.asarray(ids)))
            loss = loss_of(out, JTensor(jnp.asarray(labels)))
        first = out[0] if isinstance(out, tuple) else out
        return loss._value * scale, first._value

    with jamp.auto_cast(level=level, dtype="float16"):
        (loss, out), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(params)
    return (str(out.dtype),
            np.asarray(out.astype(jnp.float32)),
            {n: np.asarray(g.astype(jnp.float32)) / scale
             for n, g in grads.items()})


def _port_run(model, ids, labels, loss_of, amp=True, level="O1", scale=1.0):
    model.zero_grad(set_to_none=True)
    with pamp.auto_cast(enable=amp, level=level, dtype="float16"):
        out = model(torch.from_numpy(ids))
        loss = loss_of(out, torch.from_numpy(labels))
    (loss * scale).backward()
    first = out[0] if isinstance(out, tuple) else out
    return (first, {n: p.grad.float().numpy() / scale
                    for n, p in model.named_parameters()
                    if p.grad is not None})


def _grads_held(got, want, exact):
    assert sorted(got) == sorted(want), sorted(set(want) ^ set(got))

    def dist(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)

    for name, g in want.items():
        if name.endswith("k_proj.bias") or "qkv" in name and "bias" in name:
            continue    # a true gradient of 0 in part: round-off only
        assert dist(got[name], g) <= GRAD_NOISE * max(
            dist(g, exact[name]), 1e-6), (name, dist(got[name], g),
                                          dist(g, exact[name]))
        med = np.median(_ulps(got[name], g, ULP16))
        assert med <= MEDIAN_ULPS, (name, med)


MODELS = {"gpt": (_gpt_pair, _gpt_loss_ref, GPTPretrainingCriterion(),
                  GPT_CFG["vocab_size"]),
          "bert": (_bert_pair, _bert_loss_ref, _bert_loss,
                   BERT_CFG["vocab_size"])}


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("which", list(MODELS))
def test_model_under_auto_cast_float16(which, level):
    pair, ref_loss, loss, vocab = MODELS[which]
    jmodel, model = pair()
    ids, labels = _ids(vocab, 3)
    _, exact = _port_run(model, ids, labels, loss, amp=False)
    if level == "O2":
        jamp.decorate(jmodel, level="O2", dtype="float16")
        pamp.decorate(model, level="O2", dtype="float16")
    ref_dtype, ref_out, ref_grads = _ref_run(jmodel, ids, labels, ref_loss,
                                             level, SCALES[which])
    out, grads = _port_run(model, ids, labels, loss, level=level,
                           scale=SCALES[which])
    assert str(out.dtype)[6:] == ref_dtype
    if which == "gpt" or level == "O2":
        assert out.dtype == torch.float16
    tl.close_to_scale(out.detach().float().numpy(), ref_out, ULPS * ULP16,
                      f"{which} logits")
    _grads_held(grads, ref_grads, exact)


def test_gpt_head_with_amp_off_is_the_composition_bit_for_bit():
    _, model = _gpt_pair()
    ids, labels = _ids(GPT_CFG["vocab_size"], 4)
    logits, grads = _port_run(model, ids, labels, GPTPretrainingCriterion(),
                              amp=False)
    model.zero_grad(set_to_none=True)
    w = model.gpt.embeddings.word_embeddings.weight
    comp = model.gpt(torch.from_numpy(ids)) @ w.T
    assert torch.equal(logits, comp)
    pF.cross_entropy(comp, torch.from_numpy(labels),
                     reduction="none").mean().backward()
    for n, p in model.named_parameters():
        assert torch.equal(torch.from_numpy(grads[n]), p.grad), n
    mask = torch.from_numpy((labels % 3 > 0).astype("float32"))
    crit = GPTPretrainingCriterion()(comp.detach(), torch.from_numpy(labels),
                                     mask)
    loss = pF.cross_entropy(comp.detach(), torch.from_numpy(labels),
                            reduction="none")
    assert torch.equal(crit, (loss * mask).sum() / mask.sum().clamp(min=1.0))


def test_bert_head_with_amp_off_is_the_composition_bit_for_bit():
    _, model = _bert_pair()
    ids, _ = _ids(BERT_CFG["vocab_size"], 5)
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(ids))
        seq, _ = model.bert(torch.from_numpy(ids))
        heads = model.cls
        h = heads.layer_norm(heads.activation(heads.transform(seq)))
        comp = torch.matmul(h, heads.decoder_weight.T) + heads.decoder_bias
    assert torch.equal(logits, comp)


def _fused_inputs():
    h, d, m = 2, 8, 16
    return dict(x=rand((2, 6, m), 20),
                qkv_weight=rand((3, h, d, m), 21, low=-0.3, high=0.3),
                linear_weight=rand((m, m), 22, low=-0.3, high=0.3),
                qkv_bias=rand((3, h, d), 23), linear_bias=rand((m,), 24),
                ln_scale=rand((m,), 25), ln_bias=rand((m,), 26),
                w1=rand((m, 32), 27, low=-0.3, high=0.3),
                w2=rand((32, m), 28, low=-0.3, high=0.3),
                b1=rand((32,), 29), b2=rand((m,), 30))


FUSED = {
    "fused_multi_head_attention": lambda F, a: F.fused_multi_head_attention(
        a["x"], a["qkv_weight"], a["linear_weight"], qkv_bias=a["qkv_bias"],
        linear_bias=a["linear_bias"], ln_scale=a["ln_scale"],
        ln_bias=a["ln_bias"], dropout_rate=0.0, attn_dropout_rate=0.0,
        training=False),
    "fused_feedforward": lambda F, a: F.fused_feedforward(
        a["x"], a["w1"], a["w2"], a["b1"], a["b2"], ln2_scale=a["ln_scale"],
        ln2_bias=a["ln_bias"], dropout1_rate=0.0, dropout2_rate=0.0,
        training=False),
    "fused_matmul_bias": lambda F, a: F.fused_matmul_bias(
        a["x"], a["linear_weight"], a["linear_bias"], transpose_y=True),
}


@pytest.mark.parametrize("site", list(FUSED))
def test_fused_site_under_auto_cast(site):
    arrays = _fused_inputs()
    with jautograd.no_grad(), jamp.auto_cast(dtype="float16"):
        want = FUSED[site](jIF, {k: tl.jtensor(v) for k, v in arrays.items()})
    with torch.no_grad(), pamp.auto_cast(dtype="float16"):
        got = FUSED[site](pIF, {k: tl.t(v) for k, v in arrays.items()})
    want_dt = np.dtype(want._value.dtype).name
    assert str(got.dtype)[6:] == want_dt
    unit = ULP16 if want_dt == "float16" else 2.0 ** -11
    tl.close_to_scale(got.float().numpy(),
                      np.asarray(want._value.astype(jnp.float32)),
                      ULPS * unit, site)
    # with AMP off: the float32 composition, bit for bit
    with torch.no_grad():
        off = FUSED[site](pIF, {k: tl.t(v) for k, v in arrays.items()})
        if site == "fused_matmul_bias":
            a = {k: tl.t(v) for k, v in arrays.items()}
            comp = a["x"] @ a["linear_weight"].transpose(-1, -2) + \
                a["linear_bias"]
            assert torch.equal(off, comp)
    assert off.dtype == torch.float32


def test_quantized_linear_under_auto_cast():
    """The product in float16, then the float32 bias: float32 out, as the
    reference's ``ops.matmul(x, w) + bias``."""
    paddle_tpu.seed(13)
    jlayer = jql.QuantedLinear(jnn.Linear(6, 3))
    layer = pql.QuantedLinear(pnn.Linear(6, 3, device="cpu"))
    load_paddle_tpu_state_dict(layer.inner, tl.arrays(jlayer.inner))
    jlayer.eval()
    layer.eval()
    x = rand((4, 6), 31)
    with jautograd.no_grad(), jamp.auto_cast(dtype="float16"):
        want = jlayer(tl.jtensor(x))
    with torch.no_grad(), pamp.auto_cast(dtype="float16"):
        got = layer(tl.t(x))
    assert np.dtype(want._value.dtype).name == "float32" == str(got.dtype)[6:]
    tl.close_to_scale(got.numpy(), np.asarray(want._value), ULPS * ULP16,
                      "quanted linear")
    with torch.no_grad():
        off = layer(tl.t(x))
        jout = jlayer(tl.jtensor(x))
    np.testing.assert_allclose(off.numpy(), np.asarray(jout._value),
                               rtol=1e-5, atol=1e-6)
