"""A small `nn.Transformer` trained a step under `amp.auto_cast`, O1 and
O2, in float16 and bfloat16, against paddle_tpu's.

Two encoder and two decoder layers, d_model 128 (2 heads of 64), FFN
256, dropout 0, a 97-word embedding shared by source and target and a
``Linear(128, 97)`` head, 128-token sources and targets (B=2), the
causal mask, ``F.cross_entropy`` on the logits. At these lengths the
gates take every attention, on both sides: the reference runs with its
Pallas gates open and its kernels in interpret mode, so its encoder's
self-attention is the qkv-direct branch (a white-list ``matmul`` of the
input and the stacked weights, then a gray add of the float32 biases)
into the gray ``flash_attention_qkv3``, and its decoder's attentions the
gray ``flash_attention``; the port's plain versions run where its
kernels run on a card.

Held: the multiset of (op name, cast dtype) over the white- and
black-list ops reaching each package's AMP hook (recorded through
``set_amp_hook``) is the same; the loss and the logits lie within 8 ulps
of their dtype at the tensor's largest magnitude (2^-11 a ulp in
float16, 2^-8 in bfloat16, as `chip_smoke.flash_ulps` counts them). The
gradients are held against the AMP dtype's own rounding: each lies no
farther from the reference's (relative L2) than GRAD_NOISE times the
reference's own distance from the float32 model's. They cannot be held
to 8 ulps: the two packages' LayerNorms sum in another order in float32,
so a value cast to the AMP dtype after one lands one ulp apart here and
there, a ReLU input near 0 flips, and the gradient behind it moves by a
whole row's contribution. On this model in float16 the port's gradients
lie at most 15.4 ulps (the median element of a tensor, each at its
own scale: `_ulps`) from the reference's, and the reference's own 15.3
from float32; in relative L2 the port stands at most 1.53 times the
reference's own rounding (float16 O2), 1.12 at O1. So each gradient is
held both ways: in relative L2 to GRAD_NOISE times the reference's own
distance, and its median element to MEDIAN_ULPS. O2 casts the parameters with ``amp.decorate`` on both
sides, so its gradients come in the AMP dtype; O1's in float32.
"""
import collections
import importlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import amp as jamp
from paddle_tpu import kernels as jkernels
from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core import dispatch as jdispatch
from paddle_tpu.jit.api import functional_call as jfunctional_call
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core import dispatch as pdispatch
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.nn import functional as pF

import _torch_layers as tl

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
jauto = importlib.import_module("paddle_tpu.amp.auto_cast")
pauto = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

B, S, VOCAB, D = 2, 128, 97, 128
ULP = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8}
ULPS = 8
# float16 trains with a loss scale, as its users train it (without one the
# cotangents, about 1e-5 here, are float16 subnormals: their rounding then
# sits at about 12 float16 ulps of each gradient in both packages alike);
# bfloat16 has float32's range and trains without
LOSS_SCALE = {"float16": 2.0 ** 15, "bfloat16": 1.0}
GRAD_NOISE = 2.0
# and each gradient's median element within this many ulps of the
# reference's (`_ulps`; measured at most 15.4 in float16, 5.2 in
# bfloat16, where the reference's own lie 15.3 and 5.8 from float32)
MEDIAN_ULPS = 32
LISTED = jauto.white_list | jauto.black_list


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    monkeypatch.setattr(jkernels, "pallas_available", lambda: True)
    jkernels.reset_kernel_fallback_counters()
    yield
    jkernels.reset_kernel_fallback_counters()


def _model(nn, **kw):
    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.tr = nn.Transformer(D, 2, 2, 2, 256, dropout=0.0, **kw)
            self.emb = nn.Embedding(VOCAB, D, **kw)
            self.head = nn.Linear(D, VOCAB, **kw)

        def forward(self, src, tgt, mask, labels):
            out = self.tr(self.emb(src), self.emb(tgt), tgt_mask=mask)
            logits = self.head(out)
            loss = (jF if nn is jnn else pF).cross_entropy(
                logits.reshape([-1, VOCAB]), labels.reshape([-1]))
            return loss, logits

    return Seq2Seq()


def _ulps(x, ref, unit):
    """``|x - ref|`` of each element in ulps (``unit`` at scale 1) of its
    scale: the largest of its own ``|ref|``, the rms of its row (last
    axis) and 1/64 of the tensor's rms, as `chip_smoke.flash_ulp` counts
    it."""
    r = ref.reshape(-1, ref.shape[-1])
    scale = np.maximum(np.abs(r), np.sqrt(np.square(r).mean(1, keepdims=True)))
    scale = np.maximum(scale, np.sqrt(np.square(r).mean()) / 64)
    return np.abs(x.reshape(r.shape) - r) / (scale * unit)


def _recorder(hook, log, name_of):
    def rec(op):
        dt = hook(op)
        if dt is not None and op in LISTED:
            log[(op, name_of(dt))] += 1
        return dt
    return rec


def _ref_step(jmodel, batch, level, dtype, log):
    """The reference's loss, logits and grads under auto_cast, through
    jax.value_and_grad over its parameters (one jitted trace) of the
    scaled loss; the grads unscaled in float32."""
    params = {n: p._value for n, p in jmodel.named_parameters()}
    scale = LOSS_SCALE[dtype]

    def f(p):
        with jautograd.no_grad():
            loss, logits = jfunctional_call(jmodel, p, *batch)
        return loss._value * scale, logits._value

    with jamp.auto_cast(level=level, dtype=dtype):
        jdispatch.set_amp_hook(_recorder(
            jauto.amp_dtype_for_op, log, lambda d: np.dtype(d).name))
        try:
            (loss, logits), grads = jax.jit(jax.value_and_grad(
                f, has_aux=True))(params)
        finally:
            jdispatch.set_amp_hook(jauto.amp_dtype_for_op)
    return (np.asarray(loss) / scale, np.asarray(logits.astype(np.float32)),
            {n: np.asarray(g.astype(np.float32)) / scale
             for n, g in grads.items()})


def _port_step(model, batch, level, dtype, log):
    with pamp.auto_cast(level=level, dtype=dtype):
        pdispatch.set_amp_hook(_recorder(pauto.amp_dtype_for_op, log,
                                         dtype_name))
        try:
            loss, logits = model(*batch)
        finally:
            pdispatch.set_amp_hook(pauto.amp_dtype_for_op)
    scale = LOSS_SCALE[dtype]
    (loss * scale).backward()
    return (loss.detach().float().numpy(), logits.detach().float().numpy(),
            {n: p.grad.float().numpy() / scale
             for n, p in model.named_parameters()},
            logits.dtype, {n: p.grad.dtype for n, p in
                           model.named_parameters()})


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_transformer_step_under_auto_cast(pallas_interpret, monkeypatch,
                                          level, dtype):
    paddle_tpu.seed(5)
    jmodel = _model(jnn)
    jmodel.eval()
    model = tl.port_of(jmodel, _model(pnn, device="cpu"))
    f32 = tl.port_of(jmodel, _model(pnn, device="cpu"))
    if level == "O2":
        jamp.decorate(jmodel, level="O2", dtype=dtype)
        pamp.decorate(model, level="O2", dtype=dtype)
        low = getattr(torch, dtype)
        assert all(p.dtype == low for p in model.parameters())
    calls = collections.Counter()
    for mod, name in ((pF, "flash_attention"),
                      (importlib.import_module("paddle_tpu_torch.nn."
                                               "transformer"),
                       "flash_attention_qkv3")):
        real = getattr(mod, name)

        def counted(*a, _r=real, _n=name, **k):
            calls[_n, str(a[0].dtype)[6:]] += 1
            return _r(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    rng = np.random.default_rng(7)
    src, tgt, labels = (rng.integers(0, VOCAB, (B, S)) for _ in range(3))
    mask = model.tr.generate_square_subsequent_mask(S)
    jlog, plog = collections.Counter(), collections.Counter()
    want = _ref_step(jmodel, (tl.jtensor(src), tl.jtensor(tgt),
                              tl.jtensor(mask.numpy()), tl.jtensor(labels)),
                     level, dtype, jlog)
    got = _port_step(model, (tl.t(src), tl.t(tgt), mask, tl.t(labels)),
                     level, dtype, plog)
    assert jkernels.kernel_fallback_counters() == {}
    # the same ops reach the hook, cast to the same dtypes
    assert plog == jlog
    assert jlog[("linear", dtype)] == 27 and jlog[("layer_norm",
                                                    "float32")] == 10
    assert jlog[("matmul", dtype)] == 2 and jlog[("cross_entropy",
                                                   "float32")] == 1
    # every attention in a flash branch: the encoder's qkv-direct one in
    # float32 under O1 (the float32 biases promote the projection back),
    # in the AMP dtype under O2; the decoder's two in the AMP dtype
    enc = "float32" if level == "O1" else dtype
    assert calls == {("flash_attention_qkv3", enc): 2,
                     ("flash_attention", dtype): 4}
    assert got[3] == getattr(torch, dtype)
    grad_dtype = torch.float32 if level == "O1" else getattr(torch, dtype)
    assert set(got[4].values()) == {grad_dtype}
    rel = ULPS * ULP[dtype]
    tl.close_to_scale(got[0], want[0], rel, "loss")
    tl.close_to_scale(got[1], want[1], rel, "logits")
    # the float32 model (no AMP) on the same weights and batch
    f32(tl.t(src), tl.t(tgt), mask, tl.t(labels))[0].backward()
    exact = {n: p.grad.numpy() for n, p in f32.named_parameters()}
    assert sorted(got[2]) == sorted(want[2]) == sorted(exact)

    def dist(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for name, g in want[2].items():
        if name.endswith("k_proj.bias"):
            # a true gradient of 0: both sides hold only round-off
            assert np.abs(got[2][name]).max() <= rel * np.abs(
                got[2][name.replace("k_proj.bias", "q_proj.bias")]).max()
            continue
        assert dist(got[2][name], g) <= GRAD_NOISE * dist(g, exact[name]), (
            name, dist(got[2][name], g), dist(g, exact[name]))
        med = np.median(_ulps(got[2][name], g, ULP[dtype]))
        assert med <= MEDIAN_ULPS, (name, med)
