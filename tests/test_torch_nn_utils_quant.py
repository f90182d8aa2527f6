"""The port's `nn.utils` (weight and spectral norm, parameter vectors),
`quantization.layers` and `nn.quant` against paddle_tpu's, with the same
weights (`models.load_layer_state_dict`: the parameters ``weight_g`` and
``weight_v``, the observers' ``scale`` and ``seen`` buffers) and numpy
inputs.

Outputs and grads (the loss ``sum(y * r)``) within REL (1e-5) of each
tensor's largest |value|, float32:

- ``weight_norm`` on a `Linear` at ``dim`` 0, 1 and None and on a
  `Conv2D`: the reference's parameter names and shapes, the forward and
  the grads of ``weight_g``, ``weight_v``, the bias and the input; the
  weight is derived state (no parameter, a plain attribute that each
  forward recomputes, as the reference's hook does: after loading new
  ``weight_g``/``weight_v`` it follows them at the next forward);
  ``remove_weight_norm`` makes it a parameter again with the same
  forward;
- ``spectral_norm`` with the reference's ``u`` and ``v`` (its numpy
  draws, set into the port's buffers): the forward and the grads;
- ``parameters_to_vector`` and ``vector_to_parameters``;
- ``fake_quant``: the forward and the straight-through grad (1 inside
  the clip range, 0 outside); `FakeQuanterWithAbsMax`;
  `MovingAverageAbsMaxObserver`, `QuantedLinear`, `QuantedConv2D` and
  the wrappers of `nn.quant` over three training passes, each pass's
  output, grads and ``scale``/``seen`` buffers (``_torch_fns.
  ref_layer_step``, the running scale written back into the reference),
  then an eval pass on the stored scale; the functional layers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import quant as jquant
from paddle_tpu.nn import utils as jutils
from paddle_tpu.quantization import layers as jql
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import quant
from paddle_tpu_torch.nn import utils
from paddle_tpu_torch.quantization import layers as ql

import _torch_fns as tf

REL = 1e-5
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _state_kept():
    with tf.state_kept():
        yield


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_linear(dim):
    jlayer = jutils.weight_norm(jnn.Linear(5, 3), dim=dim)
    layer = tf.twin(jlayer, lambda: utils.weight_norm(
        pnn.Linear(5, 3, **CPU), dim=dim))
    names = sorted(n for n, _ in layer.named_parameters())
    assert names == ["bias", "weight_g", "weight_v"]
    for n, p in jlayer.named_parameters():
        assert tuple(p.shape) == tuple(layer.get_parameter(n).shape), n
    jw = torch.from_numpy(np.array(jlayer.weight._value))
    x = tf.randn((4, 5), 1)
    got = tf.port_layer_step(layer, None, [x], False)  # hook: the weight
    torch.testing.assert_close(layer.weight, jw, rtol=1e-6, atol=1e-6)
    tf.step_held(got, tf.ref_layer_step(jlayer, None, [x], False), REL,
                 f"weight_norm dim={dim}")
    assert "weight" not in layer._parameters
    with torch.no_grad():
        layer.weight_g.mul_(2.0)
    out = layer(torch.from_numpy(x))
    torch.testing.assert_close(layer.weight, 2 * jw, rtol=1e-6, atol=1e-6)
    utils.remove_weight_norm(layer)
    assert sorted(n for n, _ in layer.named_parameters()) == ["bias",
                                                             "weight"]
    torch.testing.assert_close(layer(torch.from_numpy(x)), out)


def test_weight_norm_conv():
    jlayer = jutils.weight_norm(jnn.Conv2D(2, 3, 3))
    layer = tf.twin(jlayer, lambda: utils.weight_norm(
        pnn.Conv2D(2, 3, 3, **CPU)))
    x = tf.randn((2, 2, 5, 5), 2)
    tf.step_held(tf.port_layer_step(layer, None, [x], False),
                 tf.ref_layer_step(jlayer, None, [x], False), REL,
                 "weight_norm conv")


def test_spectral_norm():
    np.random.seed(7)
    jlayer = jutils.spectral_norm(jnn.Linear(6, 4), n_power_iterations=2)
    np.random.seed(7)
    u, v = np.random.normal(0, 1, 6), np.random.normal(0, 1, 4)
    layer = tf.twin(jlayer, lambda: utils.spectral_norm(
        pnn.Linear(6, 4, **CPU), n_power_iterations=2))
    with torch.no_grad():
        layer.weight_u.copy_(torch.from_numpy(u))
        layer.weight_v.copy_(torch.from_numpy(v))
    assert sorted(layer.state_dict()) == ["bias", "weight_orig"]
    x = tf.randn((3, 6), 3)
    tf.step_held(tf.port_layer_step(layer, None, [x], False),
                 tf.ref_layer_step(jlayer, None, [x], False), REL,
                 "spectral_norm")


def test_parameter_vectors():
    jlayer = jnn.Linear(3, 2)
    layer = tf.twin(jlayer, lambda: pnn.Linear(3, 2, **CPU))
    want = jutils.parameters_to_vector(jlayer.parameters())
    got = utils.parameters_to_vector(layer.parameters())
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(want._value))
    vec = tf.randn((8,), 4)
    jutils.vector_to_parameters(JTensor(jnp.asarray(vec)),
                                jlayer.parameters())
    utils.vector_to_parameters(torch.from_numpy(vec), layer.parameters())
    for (n, p), (_, q) in zip(jlayer.named_parameters(),
                              layer.named_parameters()):
        np.testing.assert_array_equal(q.detach().numpy(),
                                      np.asarray(p._value), err_msg=n)


def test_fake_quant_ste():
    x = tf.randn((5, 7), 5)                   # |x| up to ~2.5, scale 0.8
    tf.both(lambda a: jql.fake_quant(a, 0.8, 4),
            lambda a: ql.fake_quant(a, 0.8, 4), [x], [0], REL)
    t = torch.tensor(x, requires_grad=True)
    ql.fake_quant(t, 0.8).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(),
                                  (np.abs(x) <= 0.8).astype(np.float32))
    tf.both(lambda a: jql.FakeQuanterWithAbsMax(6)(a),
            lambda a: ql.FakeQuanterWithAbsMax(6)(a), [x], [0], REL)


def _observed(make_ref, make, x, steps=3):
    """``steps`` training passes and one eval pass of the reference layer
    and its twin on ``x`` scaled by 1, 2, 0.5 and 1.5: each pass's loss,
    output, grads and buffers held."""
    jlayer = make_ref()
    layer = tf.twin(jlayer, make)
    for i, scale in enumerate([1.0, 2.0, 0.5, 1.5][:steps + 1]):
        train = i < steps
        xi = (x * scale).astype(np.float32)
        want = tf.ref_layer_step(jlayer, lambda o: (o * _r(o.shape)).sum(),
                                 xi, train)
        got = tf.port_layer_step(layer, lambda o: (o * torch.from_numpy(
            _r(tuple(o.shape)))).sum(), xi, train)
        for n, v in want[3].items():
            jlayer.state_dict()[n]._value = jnp.asarray(v)
        tf.tl.close_to_scale(got[1], want[1], REL, f"pass {i} out")
        assert sorted(got[2]) == sorted(want[2])
        for n in want[2]:
            tf.tl.close_to_scale(got[2][n], want[2][n], REL, f"pass {i} {n}")
        assert sorted(got[3]) == sorted(want[3])
        for n in want[3]:
            np.testing.assert_allclose(got[3][n], want[3][n], rtol=REL,
                                       err_msg=f"pass {i} buffer {n}")
    return layer


def _r(shape):
    return tf.randn(tuple(shape), 41)


OBSERVED = {
    "MovingAverageAbsMaxObserver": (
        lambda: jql.MovingAverageAbsMaxObserver(8, 0.9),
        lambda: ql.MovingAverageAbsMaxObserver(8, 0.9, **CPU), (4, 6)),
    "QuantedLinear": (
        lambda: jql.QuantedLinear(jnn.Linear(6, 3)),
        lambda: ql.QuantedLinear(pnn.Linear(6, 3, **CPU)), (4, 6)),
    "QuantedConv2D": (
        lambda: jql.QuantedConv2D(jnn.Conv2D(2, 3, 3, padding=1)),
        lambda: ql.QuantedConv2D(pnn.Conv2D(2, 3, 3, padding=1, **CPU)),
        (2, 2, 5, 5)),
    "QuantizedConv2DTranspose": (
        lambda: jquant.QuantizedConv2DTranspose(jnn.Conv2DTranspose(2, 3,
                                                                    3)),
        lambda: quant.QuantizedConv2DTranspose(pnn.Conv2DTranspose(
            2, 3, 3, **CPU)), (2, 2, 4, 4)),
    "QuantizedColumnParallelLinear": (
        lambda: jquant.QuantizedColumnParallelLinear(jnn.Linear(6, 3)),
        lambda: quant.QuantizedColumnParallelLinear(pnn.Linear(6, 3, **CPU)),
        (4, 6)),
    "QuantizedRowParallelLinear": (
        lambda: jquant.QuantizedRowParallelLinear(jnn.Linear(6, 3), 4, 6),
        lambda: quant.QuantizedRowParallelLinear(pnn.Linear(6, 3, **CPU),
                                                 4, 6), (4, 6)),
    "FakeQuantChannelWiseAbsMax": (
        lambda: jquant.FakeQuantChannelWiseAbsMax(quant_axis=1),
        lambda: quant.FakeQuantChannelWiseAbsMax(quant_axis=1), (4, 6)),
    "MovingAverageAbsMaxScale": (
        lambda: jquant.MovingAverageAbsMaxScale(),
        lambda: quant.MovingAverageAbsMaxScale(**CPU), (4, 6)),
    "QuantStub": (lambda: jquant.QuantStub(),
                  lambda: quant.QuantStub(**CPU), (4, 6)),
    "MAOutputScaleLayer": (
        lambda: jquant.MAOutputScaleLayer(jnn.Linear(6, 3)),
        lambda: quant.MAOutputScaleLayer(pnn.Linear(6, 3, **CPU)), (4, 6)),
    "FakeQuantMAOutputScaleLayer": (
        lambda: jquant.FakeQuantMAOutputScaleLayer(jnn.Linear(6, 3)),
        lambda: quant.FakeQuantMAOutputScaleLayer(pnn.Linear(6, 3, **CPU)),
        (4, 6)),
}


@pytest.mark.parametrize("name", list(OBSERVED))
def test_quant_layer_passes(name):
    make_ref, make, shape = OBSERVED[name]
    layer = _observed(make_ref, make, tf.randn(shape, 6))
    if hasattr(layer, "act_quanter"):
        assert int(layer.act_quanter.seen) == 1


def test_quantized_aliases_and_functional_layers():
    assert quant.QuantizedLinear is ql.QuantedLinear
    assert quant.QuantizedConv2D is ql.QuantedConv2D
    a, b = tf.randn((2, 3), 7), tf.randn((2, 3), 8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = JTensor(jnp.asarray(a)), JTensor(jnp.asarray(b))
    fl = quant.functional_layers
    jfl = jquant.functional_layers
    for name in ("add", "subtract", "multiply", "divide"):
        np.testing.assert_allclose(
            getattr(fl, name)()(ta, tb).numpy(),
            np.asarray(getattr(jfl, name)()(ja, jb)._value), rtol=1e-6)
    cases = [("reshape", ([3, 2],)), ("transpose", ([1, 0],)),
             ("flatten", ())]
    for name, args in cases:
        np.testing.assert_array_equal(
            getattr(fl, name)()(ta, *args).numpy(),
            np.asarray(getattr(jfl, name)()(ja, *args)._value))
    np.testing.assert_array_equal(
        fl.concat()([ta, tb], 1).numpy(),
        np.asarray(jfl.concat()([ja, jb], 1)._value))
