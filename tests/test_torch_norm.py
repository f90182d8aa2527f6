"""The port's normalisations (`nn.functional.norm`, the layers of
`nn.norm`) against paddle_tpu's, on the same numpy inputs, with the
reference's weights and buffers carried across
(`models.load_layer_state_dict`).

Outputs and grads within 1e-5 of each tensor's largest |value|
(float32: the statistics summed in another order; torch's batch norm
backward is its own formula, the reference's jax's derivative of the
composition). The batch norms run as a user runs them: a training forward
and backward, a second one, then an eval forward and backward, and the
running ``_mean`` and ``_variance`` after each (the reference's passes
jitted, its running statistics read out of them and written back),
in NCHW and NHWC, 1-D (``[N, C]``, NCL, NLC) and 3-D (NDHWC), with
``use_global_stats`` True in training and False in eval. The momentum is
the reference's (``running = m * running + (1 - m) * batch``) and the
update takes the biased batch variance; both are read off exactly. The
buffers agree within 1e-6 of their largest |value|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as F

import _torch_fns as tf

REL = 1e-5
BUF_REL = 1e-6


@pytest.fixture(autouse=True)
def _state_kept():
    with tf.state_kept():
        yield


X4 = tf.randn((3, 6, 4, 5), 0, 2.0) + 0.5
X4_NHWC = np.ascontiguousarray(X4.transpose(0, 2, 3, 1))
W6, B6 = tf.randn((6,), 1) + 1.0, tf.randn((6,), 2)


@pytest.mark.parametrize("name,arrays,diff,kw", [
    ("layer_norm", [X4, [4, 5], tf.randn((4, 5), 3), tf.randn((4, 5), 4)],
     [0, 2, 3], {}),
    ("rms_norm", [X4, tf.randn((5,), 5)], [0, 1], {}),
    ("rms_norm", [X4], [0], {"epsilon": 1e-3}),
    ("instance_norm", [X4], [0], {}),
    ("instance_norm", [X4_NHWC], [0], {"data_format": "NHWC"}),
    ("group_norm", [X4], [0], {"num_groups": 3}),
    ("group_norm", [X4_NHWC], [0], {"num_groups": 2,
                                    "data_format": "NHWC"}),
    ("group_norm", [tf.randn((4, 6), 6)], [0], {"num_groups": 2}),
    ("local_response_norm", [X4], [0], {"size": 3}),
    ("local_response_norm", [X4_NHWC], [0], {
        "size": 4, "alpha": 1e-2, "beta": 0.5, "k": 2.0,
        "data_format": "NHWC"}),
], ids=["layer_norm", "rms_norm", "rms_norm_no_weight", "instance_nchw",
        "instance_nhwc", "group_nchw", "group_nhwc", "group_2d", "lrn",
        "lrn_nhwc"])
def test_norm_functions(name, arrays, diff, kw):
    tf.both(getattr(JF, name), getattr(F, name), arrays, diff, REL, **kw)


@pytest.mark.parametrize("name", ["instance_norm", "group_norm"])
def test_norm_functions_affine(name):
    """The scale and shift reach the output and take their grads."""
    kw = {"num_groups": 3} if name == "group_norm" else {}

    def call(fn, ts):
        x, w, b = ts
        return fn(x, weight=w, bias=b, **kw)

    def ref(x, w, b):
        return call(getattr(JF, name), (x, w, b))

    def port(x, w, b):
        return call(getattr(F, name), (x, w, b))

    tf.held(tf.port_vjp(port, [X4, W6, B6], [0, 1, 2]),
            tf.ref_vjp(ref, [X4, W6, B6], [0, 1, 2]), REL, name)


def _steps(jlayer, layer, x, seed, train=True):
    """Both layers' ``(loss, out, grads, buffers)`` for the loss ``sum(out
    * r)`` (`_torch_fns.ref_layer_step`, `port_layer_step`); the running
    statistics the reference's pass leaves are written back into it."""
    r = tf.randn(x.shape, seed)
    want = tf.ref_layer_step(jlayer, lambda o: (o * jnp.asarray(r)).sum(),
                             x, train)
    got = tf.port_layer_step(layer, lambda o: (o * torch.from_numpy(r))
                             .sum(), x, train)
    for n, v in want[3].items():
        jlayer.state_dict()[n]._value = jnp.asarray(v)
    return got, want


def _held(got, want, what=""):
    """Output and grads within REL, buffers within BUF_REL (the loss, a
    sum of the output's terms, cancels: the output is held instead)."""
    for rel, g, w, part in zip((REL, REL, BUF_REL), got[1:], want[1:],
                               ("out", "grad", "buffer")):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), (what, part)
            for n in w:
                tf.tl.close_to_scale(g[n], w[n], rel, f"{what} {part} {n}")
        else:
            tf.tl.close_to_scale(g, w, rel, f"{what} {part}")
    return got[3]


BN_CASES = {
    "2d_nchw": ("BatchNorm2D", (6,), {}, X4),
    "2d_nhwc": ("BatchNorm2D", (6,), {"data_format": "NHWC"}, X4_NHWC),
    "1d_nc": ("BatchNorm1D", (6,), {}, tf.randn((8, 6), 7, 2.0)),
    "1d_ncl": ("BatchNorm1D", (6,), {"momentum": 0.8},
               tf.randn((4, 6, 5), 8)),
    "1d_nlc": ("BatchNorm1D", (6,), {"data_format": "NLC"},
               tf.randn((4, 5, 6), 9)),
    "3d_ndhwc": ("BatchNorm3D", (6,), {"data_format": "NDHWC",
                                       "epsilon": 1e-3},
                 tf.randn((2, 3, 2, 4, 6), 11)),
}


@pytest.mark.parametrize("case", list(BN_CASES))
def test_batch_norm_train_then_eval(case):
    """Train forward + backward, a second train forward, an eval
    forward: outputs, grads and the running buffers after each."""
    name, args, kw, x = BN_CASES[case]
    jlayer = getattr(jnn, name)(*args, **kw)
    jlayer.weight.set_value(W6)
    jlayer.bias.set_value(B6)
    layer = tf.twin(jlayer, lambda: getattr(pnn, name)(*args, **kw,
                                                      device="cpu"))
    first = _held(*_steps(jlayer, layer, x, 12), case)
    assert not np.allclose(first["_mean"], 0.0)
    x2 = x * 0.5 + 1.0
    second = _held(*_steps(jlayer, layer, x2, 13), case)
    # the reference's convention, read off the port's buffers
    axes = tuple(i for i in range(x.ndim)
                 if i != (1 if kw.get("data_format", "NC").startswith("NC")
                          else x.ndim - 1))
    m = kw.get("momentum", 0.9)
    np.testing.assert_allclose(
        second["_variance"], m * first["_variance"]
        + (1 - m) * x2.astype(np.float64).var(axis=axes), rtol=1e-5)
    third = _held(*_steps(jlayer, layer, x2, 14, train=False), case)
    np.testing.assert_array_equal(third["_mean"], second["_mean"])


@pytest.mark.parametrize("training,use_global_stats", [
    (True, True), (False, False)], ids=["train_global", "eval_batch"])
def test_batch_norm_use_global_stats(training, use_global_stats):
    """``use_global_stats`` takes precedence over the mode: True in
    training normalises with the running statistics and leaves them; False
    in eval normalises with the batch's and updates them."""
    jlayer = jnn.BatchNorm2D(6, use_global_stats=use_global_stats)
    jlayer._mean.set_value(tf.randn((6,), 13))
    jlayer._variance.set_value(np.abs(tf.randn((6,), 14)) + 0.5)
    layer = tf.twin(jlayer, lambda: pnn.BatchNorm2D(
        6, use_global_stats=use_global_stats, device="cpu"))
    before = layer._mean.numpy().copy()
    after = _held(*_steps(jlayer, layer, X4, 15, train=training))
    assert np.array_equal(after["_mean"], before) == use_global_stats


def test_batch_norm_functional_with_the_buffers():
    """`F.batch_norm` writes the running statistics it is given, in
    place, and gives no grad to them."""
    rm, rv = np.zeros(6, np.float32), np.ones(6, np.float32)
    jm, jv = JTensor(jnp.asarray(rm)), JTensor(jnp.asarray(rv))
    pm, pv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    x = torch.tensor(X4, requires_grad=True)
    y = F.batch_norm(x, pm, pv, training=True, momentum=0.7)
    want = JF.batch_norm(JTensor(jnp.asarray(X4)), jm, jv, training=True,
                         momentum=0.7)
    tf.tl.close_to_scale(y.detach().numpy(), np.asarray(want._value), REL)
    tf.tl.close_to_scale(pm.numpy(), np.asarray(jm._value), BUF_REL)
    tf.tl.close_to_scale(pv.numpy(), np.asarray(jv._value), BUF_REL)
    assert not pm.requires_grad and not pv.requires_grad


def test_batch_norm_classes_share_the_2d_forward():
    """`BatchNorm` and `SyncBatchNorm` (one process) are `BatchNorm2D`:
    the same outputs and buffers from the same values."""
    x = torch.from_numpy(X4)
    outs = []
    for cls in (pnn.BatchNorm2D, pnn.BatchNorm, pnn.SyncBatchNorm):
        layer = tf.twin(jnn.BatchNorm2D(6), lambda: cls(6, device="cpu"))
        with torch.no_grad():
            outs.append((layer(x), layer._mean.clone(),
                         layer._variance.clone()))
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)


def test_batch_norm_buffers_and_state_dict_names():
    layer = pnn.BatchNorm2D(4, device="cpu")
    assert list(layer.state_dict()) == ["weight", "bias", "_mean",
                                        "_variance"]
    assert layer._mean.dtype == torch.float32
    assert layer._mean.abs().sum() == 0 and (layer._variance == 1).all()
    assert list(layer.state_dict()) == list(jnn.BatchNorm2D(4).state_dict())


def test_sync_batch_norm_convert_and_world():
    """`convert_sync_batchnorm` swaps every batch norm, values kept; in
    a world of more than one rank the forward raises naming A12."""
    net = pnn.Sequential(pnn.Conv2D(3, 4, 3, device="cpu"),
                         pnn.BatchNorm2D(4, device="cpu"))
    with torch.no_grad():
        net[1]._mean.fill_(0.5)
        net[1].weight.fill_(2.0)
    out = pnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(out[1], pnn.SyncBatchNorm)
    assert float(out[1]._mean[0]) == 0.5 and float(
        out[1].weight[0].detach()) == 2.0
    dist = torch.distributed
    real = dist.is_initialized, dist.get_world_size
    dist.is_initialized, dist.get_world_size = (lambda: True), (lambda: 2)
    try:
        with pytest.raises(NotImplementedError, match="A12"):
            out[1](torch.zeros(2, 4, 3, 3))
    finally:
        dist.is_initialized, dist.get_world_size = real


NORM_LAYERS = {
    "GroupNorm": ((2, 6), {}, X4),
    "GroupNorm_nhwc": ((3, 6), {"data_format": "NHWC"}, X4_NHWC),
    "InstanceNorm1D": ((6,), {}, tf.randn((3, 6, 7), 16)),
    "InstanceNorm2D": ((6,), {"epsilon": 1e-3}, X4),
    "InstanceNorm3D": ((6,), {}, tf.randn((2, 6, 2, 3, 4), 17)),
    "LayerNorm": (([4, 5],), {}, X4),
    "RMSNorm": ((5,), {}, X4),
    "LocalResponseNorm": ((5,), {"k": 2.0}, X4),
}


@pytest.mark.parametrize("case", list(NORM_LAYERS))
def test_norm_layers(case):
    """Forward and the grads of x and of every parameter, the
    reference's parameters carried across."""
    args, kw, x = NORM_LAYERS[case]
    name = case.split("_")[0]
    jlayer = getattr(jnn, name)(*args, **kw)
    for i, (_, p) in enumerate(jlayer.named_parameters()):
        p.set_value(tf.randn(tuple(p.shape), 20 + i) + 1.0)
    make = getattr(pnn, name)
    layer = tf.twin(jlayer, lambda: make(*args, **kw, **(
        {"device": "cpu"} if name != "LocalResponseNorm" else {})))
    _held(*_steps(jlayer, layer, x, 18), case)


@pytest.mark.parametrize("dim,iters", [(0, 1), (1, 3)])
def test_spectral_norm(dim, iters):
    """``weight / sigma`` from the reference's ``weight_u``/``weight_v``
    (carried across), the grad through the power iteration; the port
    draws its vectors from its own generator."""
    w = tf.randn((4, 3, 2), 19)
    jlayer = jnn.SpectralNorm([4, 3, 2], dim=dim, power_iters=iters)
    layer = tf.twin(jlayer, lambda: pnn.SpectralNorm(
        [4, 3, 2], dim=dim, power_iters=iters, device="cpu"))
    _held(*_steps(jlayer, layer, w, 21))
    fresh = pnn.SpectralNorm([4, 3, 2], dim=dim, device="cpu")
    assert fresh.weight_u.shape == (w.shape[dim],)
    assert fresh.weight_v.shape == (24 // w.shape[dim],)
