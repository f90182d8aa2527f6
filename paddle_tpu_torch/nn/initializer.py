"""Weight initializers.

Counterpart: ``paddle_tpu/nn/initializer.py``. An initializer is called
as ``init(shape, dtype, device=None)`` and returns a new tensor on
``device`` (`device.resolve_device`'s rule: ``None`` is the card). The
random ones draw from the port's generator for that device
(`core.random.current_generator`: the innermost `rng_guard`'s, else the
device's default), in float32, then cast to ``dtype``, as the reference
draws from its key in float32. The same seed gives other numbers than
the reference's JAX key; the distributions and every fan-derived bound
are the reference's (`_fan_in_out`: a 2-D weight is ``[in, out]``, more
dims are OIHW with fan_in ``shape[1] * receptive``).

`set_global_initializer(weight_init, bias_init=None)` sets the
initializers `framework.param_attr.build_parameter` takes before a
layer's own defaults.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.random import current_generator
from ..device import resolve_device, resolve_dtype


def _fan_in_out(shape):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[0] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[1] * receptive if len(shape) > 2 else shape[1]
    # conv kernels are stored OIHW, as in the reference
    if len(shape) > 2:
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    return fan_in, fan_out


def _dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else resolve_dtype(dtype)


def _normal(shape, device):
    dev = resolve_device(device)
    return torch.randn(tuple(shape), generator=current_generator(dev),
                       device=dev, dtype=torch.float32)


def _uniform(shape, low, high, device):
    dev = resolve_device(device)
    out = torch.empty(tuple(shape), device=dev, dtype=torch.float32)
    return out.uniform_(low, high, generator=current_generator(dev))


def _host(array, dtype, device):
    return torch.from_numpy(array).to(device=resolve_device(device),
                                      dtype=_dtype(dtype))


class Initializer:
    def __call__(self, shape, dtype, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype),
                          device=resolve_device(device))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device=None):
        return (_normal(shape, device) * self.std + self.mean).to(
            _dtype(dtype))


class TruncatedNormal(Initializer):
    """Normal truncated to two standard deviations around the mean
    (``jax.random.truncated_normal(-2, 2)``: its inverse-CDF draw)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device=None):
        lo, hi = math.erf(-2.0 / math.sqrt(2)), math.erf(2.0 / math.sqrt(2))
        z = torch.erfinv(_uniform(shape, lo, hi, device)) * math.sqrt(2)
        z = z.clamp_(-2.0, 2.0)
        return (z * self.std + self.mean).to(_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device=None):
        return _uniform(shape, self.low, self.high, device).to(_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (_normal(shape, device) * std).to(_dtype(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit, device).to(_dtype(dtype))


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        std = _kaiming_gain(self.negative_slope, self.nonlinearity) \
            / math.sqrt(fi)
        return (_normal(shape, device) * std).to(_dtype(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        limit = _kaiming_gain(self.negative_slope, self.nonlinearity) \
            * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit, device).to(_dtype(dtype))


class Assign(Initializer):
    """A given value (a tensor, an array or nested lists) of exactly the
    parameter's shape."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        v = self.value if isinstance(self.value, torch.Tensor) \
            else torch.from_numpy(np.array(self.value))
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"Assign initializer shape {tuple(v.shape)} != "
                             f"{tuple(shape)}")
        return v.detach().to(device=resolve_device(device),
                             dtype=_dtype(dtype), copy=True)


class Orthogonal(Initializer):
    """``jax.nn.initializers.orthogonal(scale=gain)`` over the last axis:
    the QR of a normal ``[rows, cols]`` matrix (transposed when rows <
    cols), signs fixed by R's diagonal, reshaped to ``shape``."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype, device=None):
        shape = tuple(shape)
        n_rows, n_cols = math.prod(shape) // shape[-1], shape[-1]
        wide = n_rows < n_cols
        a = _normal((n_cols, n_rows) if wide else (n_rows, n_cols), device)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if wide:
            q = q.T
        return (self.gain * q.reshape(shape)).to(_dtype(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype, device=None):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        per = oc // self.groups
        for g in range(self.groups):
            for i in range(min(per, ic)):
                out[(g * per + i, i, *centers)] = 1.0
        return _host(out, dtype, device)


class Bilinear(Initializer):
    """The bilinear-upsampling kernel of a transposed conv's weight
    ``[c_out, c_in, kh, kw]``: the separable triangle filter in every
    channel pair."""

    def __call__(self, shape, dtype, device=None):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects 4-D weights")

        def filt(k):
            f = int(np.ceil(k / 2.0))
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            return 1 - np.abs(np.arange(k) / f - c)

        kernel = np.outer(filt(shape[-2]), filt(shape[-1])).astype(
            np.float32)
        w = np.zeros(shape, np.float32)
        w[...] = kernel
        return _host(w, dtype, device)


# the reference's lowercase aliases for ParamAttr configs
constant = Constant
normal = Normal
uniform = Uniform


def calculate_gain(nonlinearity, param=None):
    """The recommended gain of a nonlinearity (the reference's table)."""
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
             "conv3d_transpose": 1.0, "tanh": 5.0 / 3,
             "relu": math.sqrt(2.0), "selu": 3.0 / 4}
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity {nonlinearity!r}")
    return gains[nonlinearity]


# set_global_initializer: process-wide weight and bias initializers that
# build_parameter takes when no ParamAttr names one
_GLOBAL_INIT = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    _GLOBAL_INIT["weight"] = weight_init
    _GLOBAL_INIT["bias"] = bias_init


__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "Dirac", "Bilinear",
           "calculate_gain", "set_global_initializer"]
