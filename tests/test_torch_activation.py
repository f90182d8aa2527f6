"""The port's activations (`nn.functional.activation`, the layers of
`nn.activation`) against paddle_tpu's, on the same numpy inputs.

Each deterministic function runs forward and backward with the loss
``sum(y * r)`` for a random ``r``: the output and the input's grad (and
PReLU's weight's) within 1e-5 of each tensor's largest |value| (float32,
the same formula; the erf, tanh and exp of the two libraries differ in
the last bits). The inputs are normal at scale 3, so every threshold,
clip and branch of the reference's formulas is crossed, on values that
never sit on a boundary. The reference's own parameters and defaults are
exercised where they differ from torch's namesakes: hardsigmoid's slope
0.1666667, selu's scale and alpha, softplus's beta and threshold, gelu
exact and tanh, softmax's dtype, maxout's groups and axis, prelu's
data_format. `rrelu` in training and `gumbel_softmax` draw random
numbers: they are held in distribution, against their expected law and
against the reference's draws, each within 5 standard errors; the
port's draws come from its own generator, not torch's global one.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.random import rng_guard, step_generator
from paddle_tpu_torch.nn import functional as F

import _torch_fns as tf

REL = 1e-5
SIGMAS = 5.0


@pytest.fixture(autouse=True)
def _state_kept():
    with tf.state_kept():
        yield


X = tf.randn((3, 4, 6), 0, scale=3.0)

FUNCTIONS = [
    ("relu", {}), ("relu6", {}), ("gelu", {}), ("gelu",
                                                {"approximate": True}),
    ("silu", {}), ("swish", {}), ("sigmoid", {}), ("tanh", {}),
    ("softmax", {}), ("softmax", {"axis": 1}),
    ("softmax", {"axis": 0, "dtype": "float64"}), ("log_softmax", {}),
    ("log_softmax", {"axis": 1, "dtype": "float64"}), ("leaky_relu", {}),
    ("leaky_relu", {"negative_slope": 0.2}), ("elu", {"alpha": 0.7}),
    ("selu", {}), ("selu", {"scale": 1.2, "alpha": 1.5}),
    ("celu", {"alpha": 0.8}), ("hardshrink", {}),
    ("hardshrink", {"threshold": 1.5}), ("hardsigmoid", {}),
    ("hardsigmoid", {"slope": 0.2, "offset": 0.4}), ("hardswish", {}),
    ("hardtanh", {}), ("hardtanh", {"min": -0.5, "max": 2.0}),
    ("maxout", {"groups": 2}), ("maxout", {"groups": 3, "axis": -1}),
    ("softplus", {}), ("softplus", {"beta": 2.0, "threshold": 3.0}),
    ("softshrink", {}), ("softshrink", {"threshold": 1.2}), ("softsign", {}),
    ("mish", {}), ("tanhshrink", {}), ("thresholded_relu", {}),
    ("thresholded_relu", {"threshold": 0.3}), ("log_sigmoid", {}),
    ("glu", {}), ("glu", {"axis": 1}), ("rrelu", {"training": False}),
    ("rrelu", {"lower": 0.05, "upper": 0.5, "training": False})]


@pytest.mark.parametrize("name,kw", FUNCTIONS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(FUNCTIONS)])
def test_activation_forward_and_grad(name, kw):
    tf.both(getattr(JF, name), getattr(F, name), [X], [0], REL, **kw)


@pytest.mark.parametrize("shape,weight,data_format", [
    ((3, 4, 5), (1,), "NCHW"), ((2, 4, 3, 3), (4,), "NCHW"),
    ((2, 3, 3, 4), (4,), "NHWC"), ((3, 4, 5), (5,), "NCL")],
    ids=["one", "nchw", "nhwc", "ncl_last"])
def test_prelu_forward_and_grads(shape, weight, data_format):
    x, w = tf.randn(shape, 1, 3.0), np.abs(tf.randn(weight, 2)) / 4
    tf.both(JF.prelu, F.prelu, [x, w], [0, 1], REL,
            data_format=data_format)


def test_relu_in_place():
    t = torch.from_numpy(X.copy())
    assert F.relu_(t) is t
    np.testing.assert_array_equal(t.numpy(), np.maximum(X, 0))


LAYERS = [
    ("ReLU", (), {}), ("ReLU6", (), {}), ("GELU", (True,), {}),
    ("SiLU", (), {}), ("Swish", (), {}), ("Sigmoid", (), {}),
    ("Tanh", (), {}), ("Softmax", (1,), {}), ("LogSoftmax", (),
                                              {"axis": 0}),
    ("LeakyReLU", (0.3,), {}), ("ELU", (), {"alpha": 0.5}),
    ("SELU", (), {}), ("CELU", (1.5,), {}), ("Hardshrink", (0.7,), {}),
    ("Hardsigmoid", (), {}), ("Hardswish", (), {}),
    ("Hardtanh", (-2.0, 1.0), {}), ("Softplus", (), {"beta": 0.5}),
    ("Softshrink", (), {"threshold": 0.1}), ("Softsign", (), {}),
    ("Mish", (), {}), ("Tanhshrink", (), {}),
    ("ThresholdedReLU", (2.0,), {}), ("LogSigmoid", (), {}),
    ("GLU", (), {"axis": 1, "name": "g"}), ("Maxout", (2,), {})]


@pytest.mark.parametrize("name,args,kw", LAYERS, ids=[n for n, _, _ in
                                                      LAYERS])
def test_activation_layers(name, args, kw):
    """Each layer binds its arguments to the function's parameters as
    the reference's `_simple` does (``name`` dropped)."""
    got, want = tf.layer_forward(getattr(jnn, name)(*args, **kw),
                                 getattr(pnn, name)(*args, **kw), X)
    tf.tl.close_to_scale(got, want, REL, name)


def test_prelu_layer_from_the_reference_weights():
    jlayer = jnn.PReLU(4, init=0.1, data_format="NCHW")
    layer = tf.twin(jlayer, lambda: pnn.PReLU(4, init=0.3, device="cpu"))
    assert float(layer.weight[0].detach()) == pytest.approx(0.1)
    x = tf.randn((2, 4, 3, 3), 3, 3.0)
    got, want = tf.layer_forward(jlayer, layer, x)
    tf.tl.close_to_scale(got, want, REL)


def _slopes(out, x):
    neg = x < 0
    return out[neg] / x[neg]


def _mean_within(values, mean, std, what):
    """The sample mean of ``values`` within SIGMAS standard errors of
    ``mean`` (``std`` the law's standard deviation)."""
    err = std / np.sqrt(values.size)
    assert abs(values.mean() - mean) <= SIGMAS * err, (what, values.mean(),
                                                       mean, err)


def test_rrelu_training_in_distribution():
    """Each negative element draws its slope uniform in [lower, upper):
    both packages' slopes lie in the range, their means within 5
    standard errors of (lower + upper) / 2 and of each other; positive
    elements pass unchanged."""
    lower, upper = 0.1, 0.4
    x = tf.randn((40, 100), 4)
    got = F.rrelu(torch.from_numpy(x), lower, upper, training=True).numpy()
    want = np.asarray(JF.rrelu(JTensor(x), lower, upper,
                               training=True)._value)
    std = (upper - lower) / np.sqrt(12)
    for out, who in ((got, "port"), (want, "reference")):
        s = _slopes(out, x)
        assert ((s >= lower - 1e-6) & (s < upper + 1e-6)).all(), who
        np.testing.assert_array_equal(out[x >= 0], x[x >= 0])
        _mean_within(s, (lower + upper) / 2, std, who)
    a, b = _slopes(got, x), _slopes(want, x)
    err = std * np.sqrt(1 / a.size + 1 / b.size)
    assert abs(a.mean() - b.mean()) <= SIGMAS * err, (a.mean(), b.mean())


def test_rrelu_layer_draws_in_training():
    layer = pnn.RReLU(0.1, 0.4)
    x = torch.from_numpy(tf.randn((20, 50), 5))
    s = _slopes(layer(x).numpy(), x.numpy())
    assert s.std() > 0.05 and ((s >= 0.1 - 1e-6) & (s < 0.4 + 1e-6)).all()


LOGITS = np.array([1.0, 0.2, -0.5, 2.0, 0.0], np.float32)


def _frequencies(samples):
    return samples.reshape(-1, LOGITS.size).mean(axis=0)


def test_gumbel_softmax_hard_samples_the_softmax():
    """The Gumbel-max trick: hard samples of 4000 rows of the same
    logits pick each class with its softmax probability, within 5
    standard errors, in both packages; every row is one-hot (within
    1e-6: the straight-through sum rounds) and the soft rows sum to
    1."""
    n = 4000
    x = np.tile(LOGITS, (n, 1))
    p = np.exp(LOGITS) / np.exp(LOGITS).sum()
    got = F.gumbel_softmax(torch.from_numpy(x), 1.0, hard=True).numpy()
    want = np.asarray(JF.gumbel_softmax(JTensor(x), 1.0, hard=True)._value)
    for out, who in ((got, "port"), (want, "reference")):
        # one + y - y rounds within a float32 ulp of the one-hot
        hot = np.round(out)
        np.testing.assert_allclose(out, hot, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(hot.sum(-1), 1.0)
        err = np.sqrt(p * (1 - p) / n)
        assert (np.abs(_frequencies(hot) - p) <= SIGMAS * err).all(), (
            who, _frequencies(hot), p)
    soft = F.gumbel_softmax(torch.from_numpy(x[:8]), 0.5).numpy()
    np.testing.assert_allclose(soft.sum(-1), 1.0, rtol=1e-6)


def test_gumbel_softmax_hard_is_straight_through():
    """The hard sample's gradient is the soft sample's."""
    x = torch.tensor(np.tile(LOGITS, (6, 1)), requires_grad=True)
    gen_state = torch.random.get_rng_state()
    with rng_guard(step_generator(3, "cpu")):
        hard = F.gumbel_softmax(x, 0.7, hard=True, axis=1)
    with rng_guard(step_generator(3, "cpu")):
        soft = F.gumbel_softmax(x, 0.7, axis=1)
    r = torch.from_numpy(tf.randn((6, 5), 6))
    g_hard, = torch.autograd.grad((hard * r).sum(), x)
    g_soft, = torch.autograd.grad((soft * r).sum(), x)
    torch.testing.assert_close(g_hard, g_soft)
    assert torch.equal(torch.random.get_rng_state(), gen_state)
