"""`ParamAttr`, `create_parameter`, `core.Parameter`, the regularizers,
`LazyGuard` and the layers' default initializers (ROADMAP C.8) against
paddle_tpu's, and the eager optimizer step that reads the attrs.

- The initializer a parameter is drawn with, in the reference's order
  (the attr's, the global weight or bias one, the layer's default, then
  XavierUniform or zeros), ``bias_attr=False`` and ``trainable=False``.
- Three eager steps of AdamW, Adam and Momentum over parameters with
  rate scales, an L2Decay, ``need_clip=False`` and a frozen one, under a
  global-norm clip, against the reference's eager step at float32 1e-5:
  the Adam forms run the multi-tensor Adam kernel's plain version, the
  rate scale in each entry.
- A `Parameter`'s attributes through ``deepcopy``, ``Module.to``,
  pickling, `framework.io` save/load, `models.convert` and
  `SpmdTrainStep`.
- C.8: every layer of the port draws its weights when built, finite and
  by the reference's rule; with no ``device`` and no card it raises.
- The slice: a small `nn.Transformer` (d_model 64, 2 heads, 1+1 layers)
  with chip_smoke phase 24's attrs and a frozen LayerNorm, three eager
  steps of AdamW with a global-norm clip, loss and parameters against
  the reference's (its loss and grads jitted as one program, its step
  eager): each loss at 1e-5; after each step each tensor's update
  (parameter less its start) within 1e-3 of the reference's, in the L2
  norm (Adam divides each grad by its magnitude, so a grad near
  round-off takes its round-off into its step: single elements part by
  up to 0.3% of a step, the worst tensor by 8.6e-5 here). The key
  projections' biases have a true gradient of 0, so Adam moves them by
  round-off alone: they are held to the steps' bound.

Global state (the global initializers, `LazyGuard`) is restored by
fixtures; the port draws from its own seeded generators.
"""
import copy
import io
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as J
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.framework import param_attr as jpa
from paddle_tpu.jit.api import functional_call as jfunctional_call
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.regularizer import L2Decay as JL2Decay
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework as pfw
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as T
from paddle_tpu_torch.core import Parameter
from paddle_tpu_torch.core.random import rng_guard, step_generator
from paddle_tpu_torch.framework import param_attr as ppa
from paddle_tpu_torch.models import load_paddle_tpu_state_dict
from paddle_tpu_torch.nn import initializer as pinit
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

import _torch_layers as tl

REL = 1e-5
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _rng_state_kept():
    with tl.rng_state_kept():
        yield


@pytest.fixture
def restore_globals():
    """Puts back both packages' global initializers and lazy switches."""
    saved = [dict(m._GLOBAL_INIT) for m in (jinit, pinit)] + \
        [list(m._LAZY_INIT) for m in (jpa, ppa)]
    yield
    for m, s in zip((jinit, pinit), saved[:2]):
        m._GLOBAL_INIT.clear()
        m._GLOBAL_INIT.update(s)
    for m, s in zip((jpa, ppa), saved[2:]):
        m._LAZY_INIT[:] = s


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t, np.float32)


def _seeded(fn, seed=0):
    with rng_guard(step_generator(seed, "cpu")):
        return fn()


# -- which initializer --------------------------------------------------------
@pytest.mark.parametrize("case", ["attr", "global_weight", "global_bias",
                                  "layer_default", "fallback"])
def test_the_initializer_follows_the_reference_precedence(case,
                                                          restore_globals):
    """(1) the attr's initializer beats the global one; (2) the global
    weight initializer beats a layer's default (LayerNorm's scale too);
    (3) the global bias initializer; (4) the layer's own default
    (LayerNorm's ones, Embedding's Normal(0, 1)); (5) XavierUniform for a
    weight, zeros for a bias."""
    def build(nn, init, attr_cls, **kw):
        if case in ("attr", "global_weight", "global_bias"):
            init.set_global_initializer(
                init.Constant(0.3),
                init.Constant(-0.2) if case == "global_bias" else None)
        wattr = attr_cls(initializer=init.Constant(0.7)) \
            if case == "attr" else None
        if case == "fallback":                 # no default of its own
            return (nn.Conv2D(16, 32, 3, **kw),)
        return (nn.Linear(256, 128, weight_attr=wattr, **kw),
                nn.LayerNorm(32, **kw), nn.Embedding(300, 64, **kw))

    jl = build(jnn, jinit, jpaddle.ParamAttr)
    pl = _seeded(lambda: build(pnn, pinit, ptt.ParamAttr, **CPU))
    drawn = case in ("layer_default", "fallback")
    for j, p in zip(jl, pl):
        for (jn, jp), (pn, pp) in zip(j.named_parameters(),
                                      p.named_parameters()):
            assert jn == pn and isinstance(pp, Parameter)
            want, got = _np(jp), _np(pp.detach())
            if drawn and pn == "weight" and not isinstance(p, pnn.LayerNorm):
                assert np.isfinite(got).all()
                assert got.std() == pytest.approx(want.std(), rel=0.05)
                if not isinstance(p, pnn.Embedding):   # XavierUniform
                    assert np.abs(got).max() <= _xavier_limit(got.shape)
            else:
                np.testing.assert_array_equal(got, want, err_msg=pn)
    if case == "attr":
        assert (_np(pl[0].weight.detach()) == np.float32(0.7)).all()


def test_attr_forms_bias_false_and_trainable_false_follow_the_reference():
    to_attr = ppa.ParamAttr._to_attr
    assert to_attr(None) is None and to_attr(False) is False
    assert to_attr("fc_w").name == "fc_w"
    init = pinit.Constant(0.5)
    assert to_attr(init).initializer is init
    attr = ptt.ParamAttr(name="x")
    assert to_attr(attr) is attr
    for m in (jpa, ppa):
        with pytest.raises(TypeError):
            m.ParamAttr._to_attr(3)
    j = jnn.Linear(4, 3, bias_attr=False)
    p = pnn.Linear(4, 3, bias_attr=False, **CPU)
    assert p.bias is None and j.bias is None
    assert list(p.state_dict()) == list(j.state_dict()) == ["weight"]
    assert pnn.LayerNorm(4, weight_attr=False, **CPU).weight is None
    frozen = ptt.ParamAttr(trainable=False, learning_rate=0.25,
                           regularizer=L1Decay(0.5), need_clip=False)
    p = pnn.Linear(4, 3, weight_attr=frozen, **CPU)
    j = jnn.Linear(4, 3, weight_attr=jpaddle.ParamAttr(
        trainable=False, learning_rate=0.25, need_clip=False))
    w = p.weight
    assert w.trainable is j.weight.trainable is False
    assert not w.requires_grad and w.stop_gradient
    assert w.optimize_attr == j.weight.optimize_attr == {"learning_rate": 0.25}
    assert w.need_clip is j.weight.need_clip is False
    assert w.regularizer._coeff == 0.5 and w.regularizer._l1
    assert p.bias.trainable and p.bias.optimize_attr["learning_rate"] == 1.0
    named = ptt.create_parameter([2, 3], "float32", name="w0",
                                 attr=pinit.Constant(2.0), **CPU)
    assert named.name == "w0" and (named == 2.0).all()
    assert ptt.create_parameter([3], attr=False, **CPU) is None


# -- the eager step reads the attrs ------------------------------------------
def _attr_params(pkg):
    """The parameters of the eager-step case in one package: a rate
    scale 0.5 with an L2Decay(0.1), a rate scale 2 with
    ``need_clip=False``, a plain one and a frozen one."""
    rng = np.random.default_rng(7)
    vals = {k: rng.standard_normal(s).astype(np.float32) for k, s in
            (("w", (6, 5)), ("b", (5,)), ("c", (4, 3)), ("f", (3,)))}
    if pkg == "jax":
        mk, attr, init, reg = jpaddle.create_parameter, jpaddle.ParamAttr, \
            jinit.Assign, JL2Decay
    else:
        mk, attr, init, reg = ptt.create_parameter, ptt.ParamAttr, \
            pinit.Assign, L2Decay
    kw = {} if pkg == "jax" else CPU
    attrs = {"w": attr(learning_rate=0.5, regularizer=reg(0.1)),
             "b": attr(learning_rate=2.0, need_clip=False),
             "c": attr(), "f": attr(trainable=False)}
    out = []
    for k, a in attrs.items():
        a.initializer = init(vals[k])
        a.name = k
        out.append(mk(list(vals[k].shape), "float32", attr=a, **kw))
    return out


@pytest.mark.parametrize("name", ["AdamW", "Adam", "Momentum"])
def test_eager_steps_read_the_attrs_like_the_reference(name):
    kw = dict(learning_rate=0.05, weight_decay=0.01)
    jps, tps = _attr_params("jax"), _attr_params("torch")
    jo = getattr(J, name)(parameters=jps,
                          grad_clip=jnn.ClipGradByGlobalNorm(0.5), **kw)
    to = getattr(T, name)(parameters=tps,
                          grad_clip=pnn.ClipGradByGlobalNorm(0.5), **kw)
    rng = np.random.default_rng(8)
    for _ in range(3):
        for jp, tp in zip(jps, tps):
            g = rng.standard_normal(tuple(tp.shape)).astype(np.float32)
            jp._grad = JTensor(jnp.asarray(g))
            if tp.requires_grad:
                tp.grad = torch.from_numpy(g)
        jo.step()
        to.step()
    for jp, tp in zip(jps, tps):
        tl.close_to_scale(tp.detach().numpy(), _np(jp), REL,
                          f"{name} {tp.name}")
    assert (tps[3].detach().numpy() == _np(jps[3])).all()


# -- Parameter ----------------------------------------------------------------
def _attributed():
    layer = pnn.Linear(3, 2, weight_attr=ptt.ParamAttr(
        name="lin_w", learning_rate=0.5, regularizer=L2Decay(0.1),
        need_clip=False), **CPU)
    return layer


def _attrs(p):
    return (type(p), p.name, p.optimize_attr, p.need_clip,
            type(p.regularizer), getattr(p.regularizer, "_coeff", None),
            p.trainable)


def test_parameter_attributes_survive_copies_moves_and_files(tmp_path):
    layer = _seeded(_attributed)
    w = layer.weight
    want = _attrs(w)
    assert want[:5] == (Parameter, "lin_w", {"learning_rate": 0.5}, False,
                        L2Decay)
    twin = copy.deepcopy(layer)
    assert _attrs(twin.weight) == want and twin.weight is not w
    assert torch.equal(twin.weight, w)
    assert twin.weight.regularizer is not w.regularizer
    layer.to(torch.float64).to("cpu")
    assert layer.weight is w and w.dtype == torch.float64
    assert _attrs(layer.weight) == want
    layer.to(dtype="float32")
    back = pickle.loads(pickle.dumps(w))
    assert _attrs(back) == want and torch.equal(back, w)
    buf = io.BytesIO()
    torch.save(layer, buf)
    buf.seek(0)
    assert _attrs(torch.load(buf, weights_only=False).weight) == want
    path = str(tmp_path / "lin.pdparams")
    pfw.save({"w": w, "sd": layer.state_dict()}, path)
    got = pfw.load(path)
    assert isinstance(got["w"], Parameter) and got["w"].name == "lin_w"
    assert layer.set_state_dict(got["sd"]) == ([], [])
    load_paddle_tpu_state_dict(layer, {k: v.numpy() for k, v in
                                       got["sd"].items()})
    assert layer.weight is w and _attrs(w) == want


def test_a_train_step_keeps_the_models_parameters_and_their_attributes():
    from paddle_tpu_torch.distributed import SpmdTrainStep

    class Net(torch.nn.Module):             # a torch module of port layers
        def __init__(self):
            super().__init__()
            self.a = _attributed()
            self.b = pnn.Linear(2, 1, **CPU)

        def forward(self, x):
            return self.b(self.a(x))

    net = _seeded(Net)
    assert list(net.state_dict()) == ["a.weight", "a.bias", "b.weight",
                                      "b.bias"]
    w = net.a.weight

    def loss_fn(model, state, batch):
        return torch.func.functional_call(model, state, (batch["x"],)) \
            .square().mean()

    step = SpmdTrainStep(net, loss_fn, T.AdamW(learning_rate=0.1))
    params, state = step.init()
    before = w.detach().clone()
    step(params, state, {"x": torch.ones(4, 3)}, 0)
    assert net.a.weight is w and not torch.equal(w.detach(), before)
    assert w.name == "lin_w" and w.optimize_attr["learning_rate"] == 0.5


# -- C.8 and the device rule ----------------------------------------------------
def _xavier_limit(shape):
    fi, fo = pinit._fan_in_out(shape)
    return math.sqrt(6.0 / (fi + fo))


LAYERS = {
    "Linear": lambda: pnn.Linear(512, 512, **CPU),
    "Conv2D": lambda: pnn.Conv2D(3, 4, 3, **CPU),
    "Conv2DTranspose": lambda: pnn.Conv2DTranspose(4, 6, 3, **CPU),
    "MultiHeadAttention": lambda: pnn.MultiHeadAttention(64, 4, **CPU),
    "TransformerDecoderLayer": lambda: pnn.TransformerDecoderLayer(
        32, 2, 64, **CPU),
    "FusedMultiHeadAttention": lambda: _incubate().FusedMultiHeadAttention(
        32, 2, **CPU),
    "FusedFeedForward": lambda: _incubate().FusedFeedForward(32, 64, **CPU),
    "FusedMultiTransformer": lambda: _incubate().FusedMultiTransformer(
        32, 2, 64, num_layers=2, **CPU),
    "MoELayer": lambda: _moe().MoELayer(32, num_expert=4, d_hidden=64,
                                        **CPU),
    "ViT": lambda: _vit_fresh(),
}


def _incubate():
    from paddle_tpu_torch.incubate import nn as inn
    return inn


def _moe():
    from paddle_tpu_torch.incubate.distributed.models import moe
    return moe


def _vit_fresh():
    """ViT as built, before its seeded `init_weights`."""
    from paddle_tpu_torch.models import vit

    real = vit.init_weights
    vit.init_weights = lambda *a, **k: None
    try:
        return vit.VisionTransformer("vit-test", device="cpu")
    finally:
        vit.init_weights = real


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_fresh_layers_draw_by_the_reference_rule(name):
    """Every parameter finite; weights XavierUniform within their
    fan-derived bound, reaching half of it; biases zero; LayerNorm
    scales one; the embedding Normal(0, 1)."""
    layer = _seeded(LAYERS[name], seed=sorted(LAYERS).index(name))
    for n, p in layer.named_parameters():
        v = p.detach().float()
        assert torch.isfinite(v).all(), n
        leaf = n.split(".")[-2 if n.split(".")[-1].isdigit() else -1]
        if "ln" in leaf or "norm" in n or leaf.endswith("_scale") or \
                leaf.endswith("_scales"):
            want = 1.0 if "scale" in leaf or leaf == "weight" else 0.0
            assert (v == want).all(), n
        elif "bias" in leaf or leaf in ("b1", "b2"):
            assert (v == 0).all(), n
        else:
            limit = _xavier_limit(tuple(v.shape))
            assert v.abs().max() <= limit * (1 + 1e-6), n
            assert v.abs().max() >= 0.5 * limit, n


def test_embedding_draws_normal_and_zeroes_its_padding_row():
    e = _seeded(lambda: pnn.Embedding(2000, 64, padding_idx=-1, **CPU))
    w = e.weight.detach()
    assert not w[-1].any() and e._padding_idx == 1999
    assert w[:-1].std().item() == pytest.approx(1.0, abs=5 / math.sqrt(
        2 * w[:-1].numel()))


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


NO_DEVICE = {
    "Linear": lambda: pnn.Linear(4, 4),
    "LayerNorm": lambda: pnn.LayerNorm(4),
    "Embedding": lambda: pnn.Embedding(5, 4),
    "Conv2D": lambda: pnn.Conv2D(1, 1, 1),
    "Transformer": lambda: pnn.Transformer(16, 2, 1, 1, 32),
    "create_parameter": lambda: ptt.create_parameter([2])}


@pytest.mark.parametrize("name", sorted(NO_DEVICE))
def test_a_layer_with_no_device_and_no_card_raises(name, no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NO_DEVICE[name]()
    assert len(pnn.Sequential()) == 0          # nothing to draw: no device


def test_lazy_guard_defers_the_draw_like_the_reference(restore_globals):
    with ptt.LazyGuard():
        lin = pnn.Linear(64, 32, **CPU)
        emb = pnn.Embedding(10, 4, padding_idx=2, **CPU)
    with jpaddle.LazyGuard():
        jlin = jnn.Linear(64, 32)
    assert ppa._LAZY_INIT == [False] and jpa._LAZY_INIT == [False]
    assert lin.weight.device.type == "meta" and lin.bias.is_meta
    assert jlin.weight._init_fn is not None
    w = lin.weight
    for p in (*lin.parameters(), *emb.parameters()):
        _seeded(p.initialize)
    jlin.weight.initialize()
    assert lin.weight is w and w.device.type == "cpu"
    assert w.abs().max() <= _xavier_limit((64, 32)) and w.std() > 0
    assert not lin.bias.any() and not emb.weight[2].any()
    assert emb.weight[3].any() and w._init_fn is None
    assert tuple(_np(jlin.weight).shape) == tuple(w.shape)


# -- the slice ------------------------------------------------------------------
D, HEADS, FFN, SRC, TGT, B, LR = 64, 2, 128, 8, 6, 2, 1e-2
UPDATE_REL = 1e-3


def _phase24_attrs(pkg, init, reg):
    return (pkg.ParamAttr(initializer=init.XavierNormal(), learning_rate=0.5,
                          regularizer=reg(1e-4)),
            pkg.ParamAttr(need_clip=False))


def test_transformer_trains_eagerly_from_its_attrs_like_the_reference():
    wa, ba = _phase24_attrs(jpaddle, jinit, JL2Decay)
    jm = jnn.Transformer(D, HEADS, 1, 1, FFN, dropout=0.0, weight_attr=wa,
                         bias_attr=ba)
    pwa, pba = _phase24_attrs(ptt, pinit, L2Decay)
    pm = _seeded(lambda: pnn.Transformer(D, HEADS, 1, 1, FFN, dropout=0.0,
                                         weight_attr=pwa, bias_attr=pba,
                                         **CPU))
    tl.port_of(jm, pm).train()
    jm.train()
    frozen = "encoder.layers.0.norm1.weight"
    jf = dict(jm.named_parameters())[frozen]
    jf.trainable, jf.stop_gradient = False, True
    pf = pm.get_parameter(frozen)
    pf.trainable = False
    pf_start = pf.detach().clone()
    w = pm.get_parameter("decoder.layers.0.linear1.weight")
    assert w.optimize_attr == {"learning_rate": 0.5} and \
        w.regularizer._coeff == 1e-4
    assert not pm.get_parameter("decoder.layers.0.linear1.bias").need_clip
    jo = J.AdamW(learning_rate=LR, parameters=jm.parameters(),
                 grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    po = T.AdamW(learning_rate=LR, parameters=pm.parameters(),
                 multi_precision=True,
                 grad_clip=pnn.ClipGradByGlobalNorm(1.0))

    rng = np.random.default_rng(24)
    batches = [tuple(rng.standard_normal(s).astype(np.float32)
                     for s in ((B, SRC, D), (B, TGT, D), (B, TGT, D)))
               for _ in range(3)]
    jmask = jm.generate_square_subsequent_mask(TGT)
    pmask = pm.generate_square_subsequent_mask(TGT)
    names = [n for n, _ in jm.named_parameters()]

    def jloss(params, src, tgt, target):
        with jautograd.no_grad():
            out = jfunctional_call(jm, params, JTensor(src), JTensor(tgt),
                                   tgt_mask=jmask)
        return jnp.mean((out._value - target) ** 2)

    jstep = jax.jit(jax.value_and_grad(jloss))
    starts = {n: p.detach().clone() for n, p in pm.named_parameters()}
    jparams = dict(jm.named_parameters())
    for i, (src, tgt, target) in enumerate(batches):
        loss, grads = jstep({n: p._value for n, p in jm.named_parameters()},
                            src, tgt, target)
        for n, p in jm.named_parameters():
            p._grad = JTensor(grads[n])
        jo.step()
        jo.clear_grad()
        out = pm(torch.from_numpy(src), torch.from_numpy(tgt),
                 tgt_mask=pmask)
        ploss = (out - torch.from_numpy(target)).square().mean()
        ploss.backward()
        po.step()
        po.clear_grad()
        assert ploss.item() == pytest.approx(float(loss), rel=REL)
        for n, p in pm.named_parameters():
            got, want = p.detach().numpy(), _np(jparams[n])
            if n.endswith("k_proj.bias"):
                # a zero true gradient: Adam steps round-off, at most its
                # rate a step
                moved = np.abs(got - starts[n].numpy()).max()
                assert moved <= (i + 1) * LR * 1.01, n
            else:
                # Adam divides each grad by its magnitude, so a grad near
                # round-off takes its round-off into its step: each
                # tensor's update held as a whole
                start = starts[n].numpy()
                gap = np.linalg.norm((got - start) - (want - start))
                assert gap <= UPDATE_REL * np.linalg.norm(want - start), \
                    (n, i, gap / np.linalg.norm(want - start))
    assert torch.equal(pf.detach(), pf_start)
    assert names == [n for n, _ in pm.named_parameters()]


def test_the_encoder_takes_its_qkv_branch_without_biases():
    """``bias_attr=False``: no projection has a bias, and the port's
    encoder layer at S=128 still runs the qkv-direct branch (B5's plain
    version here), adding no bias (the reference adds them only when all
    three exist, :133-134); its output matches the reference's."""
    jl = jnn.TransformerEncoderLayer(128, 2, 64, dropout=0.0,
                                     bias_attr=False)
    pl = _seeded(lambda: pnn.TransformerEncoderLayer(
        128, 2, 64, dropout=0.0, bias_attr=False, **CPU))
    tl.port_of(jl, pl)
    assert pl.self_attn.q_proj.bias is None and pl.linear1.bias is None
    x = np.random.default_rng(5).standard_normal((1, 128, 128)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    assert pl.self_attn._qkv_direct_enabled(xt, xt, xt, None)
    with torch.no_grad():
        got = pl(xt).numpy()
    tl.close_to_scale(got, _np(jl.eval()(tl.jtensor(x))), REL, "encoder")
