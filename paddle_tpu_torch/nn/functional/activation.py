"""The activations (``paddle_tpu/nn/functional/activation.py``).

Each computes the reference's formula, which is not always torch's
namesake: `hardsigmoid` is ``clip(slope * x + offset, 0, 1)`` with slope
0.1666667 (:92); `selu` takes its scale and alpha (:77); `softplus` is
``x`` above ``threshold`` and ``log1p(exp(beta x)) / beta`` below
(:135); `gelu` is exact (erf) unless ``approximate`` (:31); `softmax` and
`log_softmax` cast to ``dtype`` first (:51, :60); `maxout` splits the
``axis`` into ``(C / groups, groups)`` and takes the max over the groups
(:105); `prelu` finds its channel on dim 1 only for ``"NCHW"`` (:114);
`leaky_relu`, `prelu` and `rrelu` keep ``x`` where it is >= 0. A torch
function stands in only where it computes the same values. `rrelu` in
training and `gumbel_softmax` draw from the current `core.random`
generator: they match the reference in distribution only.
"""
from __future__ import annotations

import torch

from ...core import random as _random
from ...core.dispatch import amp_cast
from .common import _torch_dtype

_F = torch.nn.functional


def relu(x, name=None):
    return torch.relu(x)


def relu_(x, name=None):
    return x.relu_()


def relu6(x, name=None):
    return _F.relu6(x)


def gelu(x, approximate=False, name=None):
    """GELU, exact (erf) unless ``approximate`` (tanh)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return _F.silu(x)


def swish(x, name=None):
    return _F.silu(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = amp_cast("log_softmax", x)
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    return _F.elu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return _F.celu(x, alpha)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0).to(x.dtype)


def hardswish(x, name=None):
    return _F.hardswish(x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def maxout(x, groups, axis=1, name=None):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


def prelu(x, weight, data_format="NCHW", name=None):
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    ch_axis = 1 if data_format == "NCHW" else x.dim() - 1
    shape = [1] * x.dim()
    shape[ch_axis] = weight.numel()
    return torch.where(x >= 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=True,
          name=None):
    """Training: a slope drawn uniform in ``[lower, upper)`` an element;
    otherwise their mean."""
    if training:
        gen = _random.current_generator(x.device)
        a = torch.rand(x.shape, generator=gen, device=x.device) \
            * (upper - lower) + lower
        return torch.where(x >= 0, x, a.to(x.dtype) * x)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _F.softplus(x, beta, threshold)


def softshrink(x, threshold=0.5, name=None):
    return torch.sign(x) * torch.clamp(x.abs() - threshold, min=0.0)


def softsign(x, name=None):
    return _F.softsign(x)


def mish(x, name=None):
    return _F.mish(x)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def log_sigmoid(x, name=None):
    return _F.logsigmoid(x)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with g standard Gumbel noise
    (float32, cast to x's dtype); ``hard``: the argmax's one-hot in the
    forward, the soft sample's gradient (straight through)."""
    gen = _random.current_generator(x.device)
    e = torch.empty(x.shape, device=x.device).exponential_(generator=gen)
    g = (-torch.log(e)).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if not hard:
        return y
    idx = y.argmax(dim=axis)
    onehot = _F.one_hot(idx, x.shape[axis]).to(y.dtype).movedim(-1, axis)
    return onehot + y - y.detach()


__all__ = ["relu", "relu_", "relu6", "gelu", "silu", "swish", "sigmoid",
           "tanh", "softmax", "log_softmax", "leaky_relu", "elu", "selu",
           "celu", "hardshrink", "hardsigmoid", "hardswish", "hardtanh",
           "maxout", "prelu", "rrelu", "softplus", "softshrink", "softsign",
           "mish", "tanhshrink", "thresholded_relu", "log_sigmoid", "glu",
           "gumbel_softmax"]
