"""The port's pooling (`nn.functional.pooling`, the layers of
`nn.pooling`) against paddle_tpu's, on the same numpy inputs.

Forward and the input's grad (the loss ``sum(y * r)``): max pooling
exactly (the same elements picked and routed), average pooling within
1e-6 of each tensor's largest |value| (float32 sums in another order).
Covered: every padding form the reference takes (an int, per dim, a flat
2n list, pairs, the n + 2 nested layout form, SAME, VALID), strides,
``ceil_mode`` (the high side extended until a partial window gives an
output), ``exclusive`` on and off with padding, channels last, 1-D and
3-D, ``return_mask``'s flattened indices (channels last too), and the
adaptive pools on sizes the output divides and on sizes it does not
(floor/ceil windows). ``divisor_override`` and the adaptive max pools'
``return_mask`` are taken and ignored, as in the reference.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as F

import _torch_fns as tf

AVG_REL = 1e-6


@pytest.fixture(autouse=True)
def _state_kept():
    with tf.state_kept():
        yield


X2 = tf.randn((2, 3, 7, 9), 0)
X2_NHWC = np.ascontiguousarray(X2.transpose(0, 2, 3, 1))
X1 = tf.randn((2, 3, 11), 1)
X3 = tf.randn((1, 2, 5, 6, 7), 2)


def _exact(name, arrays, **kw):
    got = tf.port_vjp(getattr(F, name), arrays, [0], **kw)
    want = tf.ref_vjp(getattr(JF, name), arrays, [0], jit=False, **kw)
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][0], want[1][0])


MAX_CASES = {
    "k3s2p1": ("max_pool2d", X2, dict(kernel_size=3, stride=2, padding=1)),
    "per_dim": ("max_pool2d", X2, dict(kernel_size=[3, 2], stride=[1, 2],
                                       padding=[1, 0])),
    "flat_2n": ("max_pool2d", X2, dict(kernel_size=3, stride=2,
                                       padding=[0, 1, 1, 2])),
    "pairs": ("max_pool2d", X2, dict(kernel_size=2, padding=[(1, 0),
                                                             (0, 1)])),
    "layout_form": ("max_pool2d", X2, dict(
        kernel_size=3, stride=2, padding=[[0, 0], [0, 0], [1, 1], [1, 0]])),
    "same": ("max_pool2d", X2, dict(kernel_size=3, stride=2,
                                    padding="SAME")),
    "valid": ("max_pool2d", X2, dict(kernel_size=3, stride=2,
                                     padding="VALID")),
    "ceil": ("max_pool2d", X2, dict(kernel_size=3, stride=2, padding=1,
                                    ceil_mode=True)),
    "nhwc": ("max_pool2d", X2_NHWC, dict(kernel_size=3, stride=2, padding=1,
                                         ceil_mode=True,
                                         data_format="NHWC")),
    "1d": ("max_pool1d", X1, dict(kernel_size=4, stride=3, padding=2,
                                  ceil_mode=True)),
    "3d": ("max_pool3d", X3, dict(kernel_size=[2, 3, 3], stride=2,
                                  padding=1)),
}


@pytest.mark.parametrize("case", list(MAX_CASES))
def test_max_pool(case):
    name, x, kw = MAX_CASES[case]
    _exact(name, [x], **kw)


AVG_CASES = {
    "exclusive_pad": ("avg_pool2d", X2, dict(kernel_size=3, stride=2,
                                             padding=1)),
    "inclusive_pad": ("avg_pool2d", X2, dict(kernel_size=3, stride=2,
                                             padding=1, exclusive=False)),
    "ceil_exclusive": ("avg_pool2d", X2, dict(kernel_size=3, stride=2,
                                              ceil_mode=True)),
    "ceil_inclusive": ("avg_pool2d", X2, dict(
        kernel_size=[2, 4], stride=[2, 3], padding=[1, 0], ceil_mode=True,
        exclusive=False)),
    "same_nhwc": ("avg_pool2d", X2_NHWC, dict(kernel_size=3, stride=2,
                                              padding="SAME",
                                              data_format="NHWC")),
    "divisor_ignored": ("avg_pool2d", X2, dict(kernel_size=2,
                                               divisor_override=3)),
    "1d": ("avg_pool1d", X1, dict(kernel_size=3, stride=2, padding=1,
                                  ceil_mode=True)),
    "3d": ("avg_pool3d", X3, dict(kernel_size=2, stride=[1, 2, 2],
                                  padding=[1, 0, 1], exclusive=False)),
}


@pytest.mark.parametrize("case", list(AVG_CASES))
def test_avg_pool(case):
    name, x, kw = AVG_CASES[case]
    tf.both(getattr(JF, name), getattr(F, name), [x], [0], AVG_REL, **kw)


ADAPTIVE_CASES = {
    "avg2d_divides": ("adaptive_avg_pool2d", X2[:, :, :6, :9], ((3, 3),)),
    "avg2d_not": ("adaptive_avg_pool2d", X2, ((3, 4),)),
    "avg2d_global": ("adaptive_avg_pool2d", X2, (1,)),
    "avg1d": ("adaptive_avg_pool1d", X1, (4,)),
    "avg3d": ("adaptive_avg_pool3d", X3, ((2, 3, 4),)),
    "max2d_not": ("adaptive_max_pool2d", X2, ((4, 5),)),
    "max1d": ("adaptive_max_pool1d", X1, (3,)),
    "max3d": ("adaptive_max_pool3d", X3, ((5, 2, 3),)),
}


@pytest.mark.parametrize("case", list(ADAPTIVE_CASES))
def test_adaptive_pool(case):
    name, x, args = ADAPTIVE_CASES[case]
    x = np.ascontiguousarray(x)
    tf.both(getattr(JF, name), getattr(F, name), [x, *args], [0], AVG_REL)


def test_adaptive_avg_pool_nhwc():
    tf.both(JF.adaptive_avg_pool2d, F.adaptive_avg_pool2d, [X2_NHWC, 3],
            [0], AVG_REL, data_format="NHWC")


def test_adaptive_max_pool_ignores_return_mask():
    x = torch.from_numpy(X2)
    torch.testing.assert_close(F.adaptive_max_pool2d(x, 3, return_mask=True),
                               F.adaptive_max_pool2d(x, 3))


@pytest.mark.parametrize("x,kw", [
    (X2, dict(kernel_size=3, stride=2, padding=1)),
    (X2, dict(kernel_size=[2, 3], stride=2, padding="SAME", ceil_mode=True)),
    (X2_NHWC, dict(kernel_size=3, stride=[2, 1], padding=[1, 1],
                   data_format="NHWC")),
], ids=["nchw", "same_ceil", "nhwc"])
def test_max_pool_return_mask(x, kw):
    """The values and the flattened spatial indices of each window's
    first largest element, exactly."""
    pout, pmask = F.max_pool2d(torch.from_numpy(x), return_mask=True, **kw)
    jout, jmask = JF.max_pool2d(JTensor(x), return_mask=True, **kw)
    np.testing.assert_array_equal(pout.numpy(), np.asarray(jout._value))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask._value))
    assert pmask.dtype == torch.int32
    flat = torch.from_numpy(x).movedim(-1, 1) if "data_format" in kw \
        else torch.from_numpy(x)
    m = pmask.movedim(-1, 1) if "data_format" in kw else pmask
    picked = flat.flatten(2).gather(2, m.flatten(2).long())
    np.testing.assert_array_equal(picked.reshape(m.shape).numpy(),
                                  (pout.movedim(-1, 1) if "data_format"
                                   in kw else pout).numpy())


def test_valid_padding_refuses_ceil_mode():
    for fn in (F.max_pool2d, JF.max_pool2d):
        with pytest.raises(ValueError, match="VALID"):
            fn(torch.from_numpy(X2) if fn is F.max_pool2d else JTensor(X2),
               3, padding="VALID", ceil_mode=True)


def test_integer_max_pool():
    x = np.random.default_rng(3).integers(-50, 50, (1, 2, 5, 5))
    got = F.max_pool2d(torch.from_numpy(x), 2, padding=1).numpy()
    want = np.asarray(JF.max_pool2d(JTensor(x), 2, padding=1)._value)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("name,args,kw,x", [
    ("MaxPool2D", (3,), dict(stride=2, padding=1), X2),
    ("MaxPool1D", (3,), dict(ceil_mode=True), X1),
    ("MaxPool3D", (2,), dict(stride=1), X3),
    ("AvgPool2D", (3,), dict(stride=2, padding=1, exclusive=False), X2),
    ("AvgPool1D", (2,), dict(padding=1), X1),
    ("AvgPool3D", (2,), dict(ceil_mode=True), X3),
    ("AdaptiveAvgPool2D", ((1, 1),), {}, X2),
    ("AdaptiveAvgPool1D", (4,), {}, X1),
    ("AdaptiveAvgPool3D", (2,), {}, X3),
    ("AdaptiveMaxPool2D", (3,), {}, X2),
    ("AdaptiveMaxPool1D", (5,), {}, X1),
    ("AdaptiveMaxPool3D", ((2, 2, 3),), {}, X3)],
    ids=lambda v: v if isinstance(v, str) else "")
def test_pooling_layers(name, args, kw, x):
    got, want = tf.layer_forward(getattr(jnn, name)(*args, **kw),
                                 getattr(pnn, name)(*args, **kw), x)
    tf.tl.close_to_scale(got, want, AVG_REL, name)
