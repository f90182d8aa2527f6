"""The port's convolutions (`nn.functional.conv*d` and their transposes,
the six layers of `nn.conv`) against paddle_tpu's, on the same numpy
inputs.

Each case runs the reference's functional under ``jax.value_and_grad``
and the port's under ``torch.autograd``, with the loss ``sum(y * r)`` for
a random ``r``. Outputs and the grads of x, weight and bias are held
within 1e-5 of each tensor's largest |value| (float32, the same products
summed in another order). Covered: every padding form of the reference's
``_padding`` (an int, one a dim, a flat 2n list, pairs, SAME, SAME_LOWER,
VALID) at strides 1-3 with dilation and groups, channel-last layouts, 1-D
and 3-D, the three transposes with ``output_padding``, groups and
dilation (string padding at stride 1; at stride 2 both refuse it), and
the layers loaded from the reference's state dict.
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import (export_paddle_tpu_state_dict,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.nn import functional as F

import _torch_layers as tl

REL = 1e-5


def _case(seed, x_shape, w_shape, out_ch):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(x_shape).astype("float32"),
            rng.standard_normal(w_shape).astype("float32"),
            rng.standard_normal(out_ch).astype("float32"))


def _both(name, x, w, b, **kw):
    """``(port, reference)``: each a list [y, dx, dw, db] of numpy arrays
    for ``F.<name>`` and ``JF.<name>`` with the loss ``sum(y * r)``."""
    jfn, pfn = getattr(JF, name), getattr(F, name)
    with jautograd.no_grad():
        y_shape = jfn(JTensor(x), JTensor(w), JTensor(b), **kw).shape
    r = np.random.default_rng(99).standard_normal(tuple(y_shape)).astype(
        "float32")

    def f(xv, wv, bv):
        with jautograd.no_grad():
            y = jfn(JTensor(xv), JTensor(wv), JTensor(bv), **kw)._value
        return (y * r).sum(), y

    (_, y), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                               has_aux=True))(x, w, b)
    want = [np.asarray(y)] + [np.asarray(g) for g in grads]
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    out = pfn(*ts, **kw)
    (out * torch.from_numpy(r)).sum().backward()
    got = [out.detach().numpy()] + [a.grad.numpy() for a in ts]
    return got, want


def _held(got, want):
    assert got[0].shape == want[0].shape
    for what, g, w in zip(("y", "dx", "dw", "db"), got, want):
        tl.close_to_scale(g, w, REL, what)


PADDINGS = [1, [1, 2], [1, 2, 0, 1], [(1, 0), (2, 1)], "same_lower", "VALID"]


@pytest.mark.parametrize("padding,stride", [
    *((p, 2) for p in PADDINGS), ("SAME", 1), ("SAME", 3)], ids=str)
def test_conv2d_padding_forms_strides_groups_dilation(padding, stride):
    x, w, b = _case(stride, (2, 4, 9, 7), (6, 2, 3, 3), 6)
    _held(*_both("conv2d", x, w, b, stride=stride, padding=padding,
                 dilation=[1, 2], groups=2))


def test_conv2d_channel_last():
    x, w, b = _case(5, (2, 9, 7, 4), (6, 4, 3, 2), 6)
    _held(*_both("conv2d", x, w, b, stride=2, padding="SAME",
                 data_format="NHWC"))


@pytest.mark.parametrize("name,x_shape,w_shape,kw", [
    ("conv1d", (2, 4, 11), (6, 2, 3),
     dict(stride=2, padding=[(2, 1)], groups=2, dilation=2)),
    ("conv3d", (1, 2, 5, 6, 7), (4, 2, 2, 3, 3),
     dict(stride=[1, 2, 2], padding=[0, 1, 1, 0, 2, 1])),
    ("conv3d", (1, 5, 6, 7, 2), (4, 1, 3, 2, 2),
     dict(stride=2, padding="SAME", groups=2, data_format="NDHWC")),
], ids=["1d", "3d_flat", "3d_ndhwc_same"])
def test_conv1d_conv3d(name, x_shape, w_shape, kw):
    x, w, b = _case(7, x_shape, w_shape, w_shape[0])
    _held(*_both(name, x, w, b, **kw))


@pytest.mark.parametrize("padding,stride,output_padding", [
    (0, 1, 0), ([1, 0], 3, 2), ([(1, 0), (0, 2)], 2, 1)], ids=str)
def test_conv2d_transpose(padding, stride, output_padding):
    x, w, b = _case(11, (2, 4, 5, 4), (4, 3, 3, 2), 6)
    _held(*_both("conv2d_transpose", x, w, b, stride=stride,
                 padding=padding, output_padding=output_padding, groups=2,
                 dilation=[2, 1]))


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_transpose_string_padding(padding):
    x, w, b = _case(13, (2, 4, 5, 4), (4, 3, 3, 2), 3)
    _held(*_both("conv2d_transpose", x, w, b, padding=padding))
    # XLA refuses a string padding on an lhs-dilated conv; so does the port
    with pytest.raises(ValueError, match="String padding"):
        F.conv2d_transpose(*(torch.from_numpy(a) for a in (x, w, b)),
                           stride=2, padding=padding)
    with pytest.raises(ValueError, match="String padding"):
        with jautograd.no_grad():
            JF.conv2d_transpose(JTensor(x), JTensor(w), JTensor(b),
                                stride=2, padding=padding)


@pytest.mark.parametrize("name,x_shape,w_shape,kw", [
    ("conv1d_transpose", (2, 6, 4), (4, 3, 2),
     dict(stride=3, padding=[(0, 1)], output_padding=2, data_format="NLC")),
    ("conv3d_transpose", (1, 2, 3, 4, 3), (2, 2, 2, 3, 2),
     dict(stride=[2, 1, 2], padding=[1, 0, 1], output_padding=[1, 0, 0])),
    ("conv2d_transpose", (2, 5, 4, 4), (4, 3, 3, 3),
     dict(stride=2, padding=1, output_padding=1, data_format="NHWC")),
], ids=["1d_nlc", "3d", "2d_nhwc"])
def test_conv1d_conv3d_transpose_and_channel_last(name, x_shape, w_shape, kw):
    x, w, b = _case(17, x_shape, w_shape, w_shape[1] * kw.get("groups", 1))
    _held(*_both(name, x, w, b, **kw))


@pytest.mark.parametrize("pair", [
    ("Conv2D", (4, 6, 3), dict(stride=2, padding="SAME", groups=2),
     (2, 4, 7, 6)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1, groups=2),
     (2, 4, 5, 4)),
], ids=lambda p: p[0])
def test_layers_load_the_reference_state_dict(pair):
    """Each layer built with the reference's arguments holds its weight
    layout, loads its state dict, computes its forward, and exports the
    same arrays back."""
    cls, args, kw, x_shape = pair
    jlayer = getattr(jnn, cls)(*args, **kw)
    layer = getattr(pnn, cls)(*args, **kw, device="cpu")
    arrays = tl.arrays(jlayer)
    assert {k: v.shape for k, v in arrays.items()} == {
        n: tuple(p.shape) for n, p in layer.named_parameters()}
    load_paddle_tpu_state_dict(layer, arrays)
    x = np.random.default_rng(3).standard_normal(x_shape).astype("float32")
    with jautograd.no_grad():
        want = np.asarray(jlayer(JTensor(x))._value)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    tl.close_to_scale(got, want, REL)
    back = export_paddle_tpu_state_dict(layer)
    assert sorted(back) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])


def test_layer_init_and_padding_mode():
    """`nn.init_weights` draws the conv weight (listed in
    ``_init_normal``) and leaves the bias at zero; a padding mode other
    than zeros is refused, where the reference would pad with zeros."""
    layer = pnn.Conv2D(3, 8, 4, stride=4, device="cpu")
    pnn.init_weights(layer, 0, 0.02)
    assert 0.01 < float(layer.weight.detach().std()) < 0.03
    assert not layer.bias.any()
    with pytest.raises(ValueError, match="padding_mode"):
        pnn.Conv2D(3, 8, 3, padding_mode="reflect", device="cpu")
