"""The port's ResNet family (`vision.models.resnet`) against paddle_tpu's,
with the reference's weights and batch-norm buffers carried across by
`models.load_layer_state_dict`.

The reference's ``resnet50(num_classes=10)`` is built once for the
module (under its `LazyGuard`, its weights then drawn from a numpy seed:
He-normal convolutions, scales near one, small shifts) and carried into
the port's. One train-mode step (the mean cross-entropy and its
backward), then eval-mode passes on the running statistics it left.

- Train mode: the loss, the logits and every batch norm's ``_mean`` and
  ``_variance`` after the step within REL (2e-4) of each tensor's largest
  |value| (float32 through 53 convolutions and batch norms summed in
  other orders). Its grads are held by direction: each at cosine >=
  0.995 and relative L2 distance <= 0.1 from the reference's. A
  train-mode batch norm's backward projects the mean and the normalised
  input out of the gradient that reaches it, most of which lies along
  them at initialisation, and so magnifies the float32 rounding of that
  gradient: in the port alone, float32 against float64 of this step
  leaves grads of the early layers at 1.4-2.7% relative L2 error
  (cosine 0.9995 at worst); the port and the reference part by 3.4% at
  most (cosine 0.99942). The same step in eval mode has no such
  magnification (float32 against float64 within 1.1e-6).
- Eval mode: the logits and every grad within REL, at 2 x 3 x 64 x 64,
  and the logits also at 2 x 3 x 32 x 32, the size of
  `examples/train_vision.py`'s images. The train step runs at 64 x 64:
  at 32 x 32 layer4's batch norms normalise 2 values a channel and the
  train-mode forward itself is chaotic (in the port alone a 1e-6
  relative change of the input moves layer4's output by 4.2 of its
  largest 4.8).

The reference's passes are jitted ``jax.value_and_grad`` calls over the
input and its parameters (`_torch_fns.ref_layer_step`), its module
evaluated under ``jax.ensure_compile_time_eval`` so that the max pool's
-inf start stays a constant (with it traced, ``reduce_window`` has no
reverse mode); its running statistics are read out of the traced call. `BasicBlock`,
`BottleneckBlock` (with a strided projection shortcut) and ``resnet18``
are held elementwise at small sizes (1e-5); every variant builds the
reference's parameter and buffer names and shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import LazyGuard as JLazyGuard
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import vision
from paddle_tpu_torch.models import load_layer_state_dict
from paddle_tpu_torch.nn import functional as F

import _torch_fns as tf

REL = 2e-4
TRAIN_GRAD_COS, TRAIN_GRAD_L2 = 0.995, 0.1


@pytest.fixture(autouse=True)
def _state_kept():
    with tf.state_kept():
        yield


def _numpy_weights(jmodel, seed):
    """``jmodel``'s parameters drawn in numpy: He-normal weights of rank
    > 1 (the classifier's by its fan-in), batch-norm scales 1 + N(0,
    0.1), shifts and biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    for name, p in jmodel.named_parameters():
        shape = tuple(p._value.shape)
        if len(shape) > 1:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 2 else shape[0]
            gain = 2.0 if len(shape) > 2 else 1.0
            v = rng.standard_normal(shape) * np.sqrt(gain / fan_in)
        elif name.endswith("weight"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        p._value = jnp.asarray(v.astype(np.float32))
        p._init_fn = None


def _lazy_reference(make, seed):
    with JLazyGuard():
        jmodel = make()
    _numpy_weights(jmodel, seed)
    return jmodel


def ref_eval_forward(jmodel, x):
    """The reference's eval forward of ``x``, jitted as one program."""
    jmodel.eval()
    sd = jmodel.state_dict()

    def f(values):
        saved = {n: sd[n]._value for n in sd}
        try:
            for n, v in values.items():
                sd[n]._value = v
            with jautograd.no_grad():
                return jmodel(JTensor(jnp.asarray(x)))._value
        finally:
            for n, v in saved.items():
                sd[n]._value = v

    return np.asarray(jax.jit(f)({n: t._value for n, t in sd.items()}))


def held(got, want, rel=REL, grads_by_direction=False):
    """Each result within ``rel`` of its scale; with
    ``grads_by_direction`` the grads by cosine and relative L2 distance
    instead (TRAIN_GRAD_COS, TRAIN_GRAD_L2)."""
    for g, w, what in zip(got, want, ("loss", "out", "grads", "buffers")):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), what
            for n in w:
                if what == "grads" and grads_by_direction:
                    a, b = g[n].astype(np.float64), w[n].astype(np.float64)
                    cos = (a * b).sum() / np.sqrt((a * a).sum()
                                                  * (b * b).sum())
                    rel_l2 = np.linalg.norm(a - b) / np.linalg.norm(b)
                    assert cos >= TRAIN_GRAD_COS and \
                        rel_l2 <= TRAIN_GRAD_L2, (n, cos, rel_l2)
                else:
                    tf.tl.close_to_scale(g[n], w[n], rel, f"{what} {n}")
        else:
            tf.tl.close_to_scale(g, w, rel, what)


def eval_forward_held(jmodel, model, x, bufs, rel=REL):
    """The eval forward of both, the reference on ``bufs`` (its running
    statistics after the step)."""
    for n, v in bufs.items():
        jmodel.state_dict()[n]._value = jnp.asarray(v)
    jmodel.eval()
    model.eval()
    got, want = tf.layer_forward(jmodel, model, x)
    tf.tl.close_to_scale(got, want, rel, "eval logits")
    return got


X = tf.randn((2, 3, 64, 64), 0)
X32 = tf.randn((2, 3, 32, 32), 11)
LABELS = np.array([3, 7])


def _ce_jax(out):
    lp = jax.nn.log_softmax(out.astype(jnp.float32), -1)
    return -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(LABELS)[:, None],
                                         -1))


def _ce_port(out):
    return pnn.CrossEntropyLoss()(out, torch.from_numpy(LABELS))


@pytest.fixture(scope="module")
def resnet50_pair():
    with tf.state_kept():
        jmodel = _lazy_reference(lambda: jmodels.resnet50(num_classes=10), 1)
        model = load_layer_state_dict(
            vision.resnet50(num_classes=10, device="cpu"), tf.tl.arrays(jmodel))
    return jmodel, model


@pytest.fixture(scope="module")
def resnet50_stepped(resnet50_pair):
    """Both after one train step: ``(jmodel, model, port's results,
    reference's results)``; both modules then hold the running
    statistics the reference's step left (the eval checks start from the
    same values)."""
    jmodel, model = resnet50_pair
    with tf.state_kept():
        want = tf.ref_layer_step(jmodel, _ce_jax, X)
        got = tf.port_layer_step(model, _ce_port, X)
    for n, v in want[3].items():
        jmodel.state_dict()[n]._value = jnp.asarray(v)
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(torch.from_numpy(np.array(want[3][n])))
    return jmodel, model, got, want


def test_resnet50_train_step(resnet50_stepped):
    """The loss, logits and every batch-norm buffer after one train
    step; every grad by direction."""
    _, _, got, want = resnet50_stepped
    assert len(got[3]) == 106 and len(got[2]) == 161 + 1     # and x
    held(got, want, grads_by_direction=True)


def test_resnet50_eval_forward_and_grads(resnet50_stepped):
    """On the running statistics the step left: the logits and every
    grad at 64 x 64 (they differ from the train step's), the logits at
    32 x 32."""
    jmodel, model, stepped, _ = resnet50_stepped
    want = tf.ref_layer_step(jmodel, _ce_jax, X, train=False)
    got = tf.port_layer_step(model, _ce_port, X, train=False)
    held(got, want)
    assert not np.allclose(got[1], stepped[1], rtol=1e-2)
    with torch.no_grad():
        got32 = model.eval()(torch.from_numpy(X32)).numpy()
    tf.tl.close_to_scale(got32, ref_eval_forward(jmodel, X32), REL,
                         "eval logits 32 x 32")


def test_resnet50_structure_and_loss_layer(resnet50_pair):
    """The port's state dict is the reference's, name for name and
    shape for shape (parameters, then buffers); `nn.CrossEntropyLoss`
    gives the reference's loss on the logits."""
    jmodel, model = resnet50_pair
    want = {n: tuple(v.shape) for n, v in jmodel.state_dict().items()}
    got = {n: tuple(v.shape) for n, v in model.state_dict().items()}
    assert list(got) == list(want) and got == want
    logits = tf.randn((2, 10), 5)
    with jautograd.no_grad():
        jl = jnn.CrossEntropyLoss()(JTensor(logits), JTensor(LABELS))
    pl = pnn.CrossEntropyLoss()(torch.from_numpy(logits),
                                torch.from_numpy(LABELS))
    tf.tl.close_to_scale(pl.numpy(), np.asarray(jl._value), 1e-6)


def _block_pair(jblock, block, seed):
    jmodel = _lazy_reference(jblock, seed)
    return jmodel, load_layer_state_dict(block(), tf.tl.arrays(jmodel))


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_blocks_train_step_and_eval(kind):
    """A block alone, with a strided projection shortcut (1x1 conv and
    batch norm): output, every grad and buffer after a train step, then
    the eval forward."""
    if kind == "basic":
        cls, inplanes, planes, cin = "BasicBlock", 6, 8, 6
    else:
        cls, inplanes, planes, cin = "BottleneckBlock", 6, 4, 6
    jcls, pcls = getattr(jmodels, cls), getattr(vision.models, cls)
    out_ch = planes * jcls.expansion

    def jmake():
        down = jnn.Sequential(jnn.Conv2D(inplanes, out_ch, 1, stride=2,
                                         bias_attr=False),
                              jnn.BatchNorm2D(out_ch))
        return jcls(inplanes, planes, stride=2, downsample=down)

    def pmake():
        down = pnn.Sequential(pnn.Conv2D(inplanes, out_ch, 1, stride=2,
                                         bias_attr=False, device="cpu"),
                              pnn.BatchNorm2D(out_ch, device="cpu"))
        return pcls(inplanes, planes, stride=2, downsample=down,
                    device="cpu")

    jblock, block = _block_pair(jmake, pmake, 2)
    x = tf.randn((3, cin, 7, 6), 3)
    r = tf.randn((3, out_ch, 4, 3), 4)
    want = tf.ref_layer_step(jblock, lambda o: ((o - r) ** 2).mean(), x)
    got = tf.port_layer_step(
        block, lambda o: ((o - torch.from_numpy(r)) ** 2).mean(), x)
    held(got, want, 1e-5)
    eval_forward_held(jblock, block, x, want[3], 1e-5)


def test_resnet18_eval_forward():
    """``resnet18`` in eval mode on carried running statistics."""
    jmodel = _lazy_reference(lambda: jmodels.resnet18(num_classes=5), 6)
    rng = np.random.default_rng(7)
    for n, b in jmodel.named_buffers():
        v = (rng.standard_normal(b._value.shape) * 0.1 if n.endswith("_mean")
             else 1.0 + rng.random(b._value.shape))
        b._value = jnp.asarray(v.astype(np.float32))
    model = load_layer_state_dict(vision.resnet18(num_classes=5,
                                                  device="cpu"),
                                  tf.tl.arrays(jmodel))
    x = tf.randn((1, 3, 40, 40), 8)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    tf.tl.close_to_scale(got, ref_eval_forward(jmodel, x), 1e-5)


@pytest.mark.parametrize("name,kw", [
    ("resnet18", {}), ("resnet34", {}), ("resnet101", {}),
    ("resnext50_32x4d", {}), ("resnext101_64x4d", {}),
    ("wide_resnet50_2", {}), ("resnet50", {"with_pool": False,
                                           "num_classes": 0})])
def test_variants_build_the_reference_structure(name, kw):
    """Names and shapes of every parameter and buffer, in order, built
    lazily on both sides (no weight is drawn)."""
    from paddle_tpu_torch import LazyGuard

    with JLazyGuard():
        jmodel = getattr(jmodels, name)(**kw)
    with LazyGuard():
        model = getattr(vision, name)(device="cpu", **kw)
    want = [(n, tuple(v._value.shape)) for n, v in
            jmodel.state_dict().items()]
    assert [(n, tuple(v.shape)) for n, v in model.state_dict().items()] \
        == want


def test_pretrained_raises_and_convert_checks():
    with pytest.raises(RuntimeError, match="pretrained"):
        vision.resnet18(pretrained=True, device="cpu")
    layer = pnn.BatchNorm2D(3, device="cpu")
    good = {"weight": np.ones(3), "bias": np.zeros(3), "_mean": np.zeros(3),
            "_variance": np.ones(3)}
    with pytest.raises(ValueError, match="missing"):
        load_layer_state_dict(layer, {k: v for k, v in good.items()
                                      if k != "_mean"})
    with pytest.raises(ValueError, match="unexpected"):
        load_layer_state_dict(layer, {**good, "extra": np.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        load_layer_state_dict(layer, {**good, "_variance": np.ones(4)})


def test_flatten_then_classifier_matches_reference_ops():
    """The head: the port's ``torch.flatten(x, 1)`` is the reference's
    ``ops.flatten(x, 1)``, and the classifier a `Linear` on it."""
    from paddle_tpu import ops

    x = tf.randn((2, 8, 1, 1), 9)
    with jautograd.no_grad():
        want = np.asarray(ops.flatten(JTensor(x), 1)._value)
    np.testing.assert_array_equal(torch.flatten(torch.from_numpy(x),
                                                1).numpy(), want)
    tf.both(JF.linear, F.linear, [want, tf.randn((8, 3), 10)], [0, 1], 1e-6)
