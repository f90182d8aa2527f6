"""The activation layers (``paddle_tpu/nn/activation.py``): one class a
function of `nn.functional.activation`, built by `_simple`, whose
positional and keyword arguments bind to the function's own parameters
after ``x`` (``name`` dropped); and `PReLU`, whose weight ``[
num_parameters]`` starts at ``init`` (``Constant(0.25)``).
"""
from __future__ import annotations

import inspect

from . import functional as F
from .initializer import Constant
from .layer import Layer


def _simple(name, fn, **fixed):
    params = [p for p in inspect.signature(fn).parameters][1:]

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kwargs = dict(fixed)
            self._kwargs.update(zip(params, args))
            self._kwargs.update((k, v) for k, v in kwargs.items()
                                if k != "name")

        def forward(self, x):
            return fn(x, **self._kwargs)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._kwargs.items())

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _simple("ReLU", F.relu)
ReLU6 = _simple("ReLU6", F.relu6)
GELU = _simple("GELU", F.gelu)
SiLU = _simple("SiLU", F.silu)
Swish = _simple("Swish", F.swish)
Sigmoid = _simple("Sigmoid", F.sigmoid)
Tanh = _simple("Tanh", F.tanh)
Softmax = _simple("Softmax", F.softmax)
LogSoftmax = _simple("LogSoftmax", F.log_softmax)
LeakyReLU = _simple("LeakyReLU", F.leaky_relu)
ELU = _simple("ELU", F.elu)
SELU = _simple("SELU", F.selu)
CELU = _simple("CELU", F.celu)
Hardshrink = _simple("Hardshrink", F.hardshrink)
Hardsigmoid = _simple("Hardsigmoid", F.hardsigmoid)
Hardswish = _simple("Hardswish", F.hardswish)
Hardtanh = _simple("Hardtanh", F.hardtanh)
Softplus = _simple("Softplus", F.softplus)
Softshrink = _simple("Softshrink", F.softshrink)
Softsign = _simple("Softsign", F.softsign)
Mish = _simple("Mish", F.mish)
Tanhshrink = _simple("Tanhshrink", F.tanhshrink)
ThresholdedReLU = _simple("ThresholdedReLU", F.thresholded_relu)
LogSigmoid = _simple("LogSigmoid", F.log_sigmoid)
GLU = _simple("GLU", F.glu)
Maxout = _simple("Maxout", F.maxout)
RReLU = _simple("RReLU", F.rrelu)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)


__all__ = ["ReLU", "ReLU6", "GELU", "SiLU", "Swish", "Sigmoid", "Tanh",
           "Softmax", "LogSoftmax", "LeakyReLU", "ELU", "SELU", "CELU",
           "Hardshrink", "Hardsigmoid", "Hardswish", "Hardtanh", "Softplus",
           "Softshrink", "Softsign", "Mish", "Tanhshrink", "ThresholdedReLU",
           "LogSigmoid", "GLU", "Maxout", "RReLU", "PReLU"]
