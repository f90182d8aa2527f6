"""`nn.quant`: fake-quant layers, the quantized wrappers (the
tensor-parallel ones among them) and the observable functional layers.

Counterpart: ``paddle_tpu/nn/quant/`` (``__init__.py``,
``quant_layers.py``, ``functional_layers.py``), over the port's
`quantization.layers`. `QuantizedLinear` and `QuantizedConv2D` are
`QuantedLinear` and `QuantedConv2D` (:141-142).
`QuantizedColumnParallelLinear` and `QuantizedRowParallelLinear` wrap
any layer with a ``.weight`` (:167-207): they fake-quantize the input
and swap the fake-quantized weight into the wrapped layer for its call;
on one process they need nothing of A12. Layers that keep a running
scale hold their buffers on the device they are given (``device=``),
or on the wrapped layer's.
"""
from __future__ import annotations

from ...device import resolve_device
from ...quantization.layers import (  # noqa: F401
    FakeQuanterWithAbsMax, MovingAverageAbsMaxObserver, QuantedConv2D,
    QuantedLinear, _fake_quant_fn, _observers, _scale_buffers,
    ema_absmax_update, fake_quant,
)
from .. import functional as F
from ..layer import Layer
from . import functional_layers  # noqa: F401
from .functional_layers import (  # noqa: F401
    FloatFunctionalLayer, add, concat, divide, flatten, multiply, reshape,
    subtract, transpose,
)


def _device_of(layer):
    """Where ``layer`` keeps its tensors (the card when it holds none)."""
    for t in (*layer.parameters(), *layer.buffers()):
        return t.device
    return resolve_device(None)


class FakeQuantAbsMax(FakeQuanterWithAbsMax):
    def __init__(self, name=None, quant_bits=8, dtype="float32",
                 quant_on_weight=False, reduce_type=None):
        super().__init__(bit_length=quant_bits, name=name)


class FakeQuantMovingAverageAbsMax(MovingAverageAbsMaxObserver):
    def __init__(self, name=None, moving_rate=0.9, quant_bits=8,
                 dtype="float32", reduce_type=None, *, device=None):
        super().__init__(bit_length=quant_bits, moving_rate=moving_rate,
                         name=name, device=device)


class FakeQuantChannelWiseAbsMax(Layer):
    """Abs-max fake quant a channel of ``quant_axis`` (0 for a conv's
    OIHW weight, 1 for a linear's ``[in, out]``)."""

    def __init__(self, name=None, channel_num=None, quant_bits=8,
                 quant_axis=0, dtype="float32", quant_on_weight=True,
                 reduce_type=None):
        super().__init__()
        self.bits = quant_bits
        self.quant_axis = quant_axis

    def forward(self, x):
        red = [i for i in range(x.dim()) if i != self.quant_axis]
        scale = x.detach().abs().amax(dim=red, keepdim=True)
        return _fake_quant_fn(x, scale, self.bits)


class MovingAverageAbsMaxScale(Layer):
    """Observes the running abs-max of what flows through (while
    training) and passes it on unchanged."""

    def __init__(self, name=None, moving_rate=0.9, dtype="float32",
                 reduce_type=None, *, device=None):
        super().__init__(device=device)
        self.moving_rate = moving_rate
        _scale_buffers(self, device)

    def forward(self, x):
        if self.training:
            ema_absmax_update(self.scale, self.seen, x, self.moving_rate)
        return x


def _on_first(out, fn):
    """``fn`` of ``out``, or of its first element when it is a tuple or
    list."""
    if isinstance(out, (tuple, list)):
        return type(out)([fn(out[0])] + list(out[1:]))
    return fn(out)


class MAOutputScaleLayer(Layer):
    """``layer`` with its output's running scale observed."""

    def __init__(self, layer=None, moving_rate=0.9, name=None,
                 dtype="float32", reduce_type=None):
        super().__init__()
        self._layer = layer
        self._ma_output_scale = MovingAverageAbsMaxScale(
            name, moving_rate, dtype, reduce_type, device=_device_of(layer))

    def forward(self, *inputs, **kwargs):
        return _on_first(self._layer(*inputs, **kwargs),
                         self._ma_output_scale)


class FakeQuantMAOutputScaleLayer(Layer):
    """``layer`` with its output fake-quantized on a running scale."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, name=None, *args, **kwargs):
        super().__init__()
        self._layer = layer
        self._fake_quant_output = FakeQuantMovingAverageAbsMax(
            name, moving_rate, activation_bits, device=_device_of(layer))

    def forward(self, *inputs, **kwargs):
        return _on_first(self._layer(*inputs, **kwargs),
                         self._fake_quant_output)


class QuantStub(Layer):
    """Observes and fake-quantizes the activations entering a quantized
    region."""

    def __init__(self, name=None, moving_rate=0.9, quant_bits=8, *,
                 device=None):
        super().__init__()
        self._observer = FakeQuantMovingAverageAbsMax(
            name, moving_rate, quant_bits, device=device)

    def forward(self, x):
        return self._observer(x)


QuantizedLinear = QuantedLinear
QuantizedConv2D = QuantedConv2D


class QuantizedConv2DTranspose(Layer):
    """A `Conv2DTranspose` on fake-quantized weights and inputs."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, *args, **kwargs):
        super().__init__()
        self.inner = layer
        self.weight_quanter, self.act_quanter = _observers(
            layer, weight_bits, activation_bits, moving_rate)

    def forward(self, x, output_size=None):
        c = self.inner
        x = self.act_quanter(x)
        return F.conv2d_transpose(
            x, self.weight_quanter(c.weight), c.bias, c._stride, c._padding,
            c._output_padding, c._groups, c._dilation, output_size,
            c._data_format)


class _QuantizedParallelLinear(Layer):
    """Fake-quantizes the input and the wrapped layer's weight, then runs
    the wrapped layer on them."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9):
        super().__init__()
        self.inner = layer
        self.weight_quanter, self.act_quanter = _observers(
            layer, weight_bits, activation_bits, moving_rate)

    def forward(self, x):
        x = self.act_quanter(x)
        inner = self.inner
        # the quantized weight shadows the parameter for this call
        inner.__dict__["weight"] = self.weight_quanter(inner.weight)
        try:
            return inner(x)
        finally:
            del inner.__dict__["weight"]


class QuantizedColumnParallelLinear(_QuantizedParallelLinear):
    pass


class QuantizedRowParallelLinear(_QuantizedParallelLinear):
    pass


__all__ = [
    "FakeQuantAbsMax", "FakeQuantMovingAverageAbsMax",
    "FakeQuantChannelWiseAbsMax", "QuantizedConv2D",
    "QuantizedConv2DTranspose", "QuantizedLinear",
    "MovingAverageAbsMaxScale", "MAOutputScaleLayer",
    "FakeQuantMAOutputScaleLayer", "QuantStub",
    "QuantizedRowParallelLinear", "QuantizedColumnParallelLinear",
]
