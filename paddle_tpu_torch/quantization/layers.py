"""Fake-quant layers (QAT) and their observer (PTQ).

Counterpart: ``paddle_tpu/quantization/layers.py``.

- `fake_quant` quantizes and dequantizes symmetrically to ``bits``:
  ``round(clip(x / s, -1, 1) * B) / B * s`` with ``B = 2^(bits-1) - 1``
  and ``s`` at least 1e-9 (``torch.round`` and ``jnp.round`` both round
  half to even), through a straight-through estimator: the gradient is
  1 where ``|x| <= s`` and 0 outside (:21-27).
- `ema_absmax_update` writes the running abs-max into an observer's
  buffers on the device, no host read: the first update takes the
  batch's abs-max, later ones ``rate * scale + (1 - rate) * abs-max``
  (:37-48).
- `FakeQuanterWithAbsMax` (weights) quantizes with the tensor's own
  abs-max; `MovingAverageAbsMaxObserver` (activations) keeps float32
  ``scale`` and int32 ``seen`` buffers, updated while training and read
  in eval.
- `QuantedLinear` and `QuantedConv2D` wrap a `Linear` (``W [in, out]``)
  or a `Conv2D` and run it on fake-quantized weights and inputs. The
  observers' buffers live on the wrapped layer's device.

``quantization/imperative.py`` (QAT, PTQ, QuantConfig) is still to port
(ROADMAP A14).
"""
from __future__ import annotations

import torch

from .. import ops
from ..device import resolve_device
from ..nn import functional as F
from ..nn.layer import Layer


def _fake_quant_fn(v, scale, bits):
    bound = 2.0 ** (bits - 1) - 1
    s = torch.clamp(scale, min=1e-9)
    inside = (v.abs() <= s).to(v.dtype)
    q = torch.round(torch.clamp(v / s, -1.0, 1.0) * bound) / bound * s
    return v * inside + (q - v * inside).detach()


def fake_quant(x, scale, bits=8):
    """Quantize-dequantize with the STE; ``scale`` a float or a 0-d
    tensor."""
    return _fake_quant_fn(x, torch.as_tensor(scale, dtype=torch.float32,
                                             device=x.device), bits)


def _scale_buffers(layer, device):
    """An observer's float32 ``scale`` and int32 ``seen``, zero, on
    ``device`` (None: the card)."""
    dev = resolve_device(device)
    layer.register_buffer("scale", torch.zeros((), device=dev))
    layer.register_buffer("seen", torch.zeros((), dtype=torch.int32,
                                              device=dev))


@torch.no_grad()
def ema_absmax_update(scale_buf, seen_buf, x, moving_rate):
    cur = x.detach().abs().max().float()
    scale = torch.where(seen_buf > 0,
                        moving_rate * scale_buf + (1 - moving_rate) * cur,
                        cur)
    scale_buf.copy_(scale)
    seen_buf.fill_(1)
    return scale_buf


class FakeQuanterWithAbsMax(Layer):
    def __init__(self, bit_length=8, name=None):
        super().__init__()
        self.bits = bit_length

    def forward(self, x):
        return _fake_quant_fn(x, x.detach().abs().max(), self.bits)


class MovingAverageAbsMaxObserver(Layer):
    def __init__(self, bit_length=8, moving_rate=0.9, name=None, *,
                 device=None):
        super().__init__(device=device)
        self.bits = bit_length
        self.moving_rate = moving_rate
        _scale_buffers(self, device)

    def forward(self, x):
        if self.training:
            ema_absmax_update(self.scale, self.seen, x, self.moving_rate)
        return fake_quant(x, self.scale, self.bits)


def _observers(layer, weight_bits, activation_bits, moving_rate):
    return (FakeQuanterWithAbsMax(weight_bits),
            MovingAverageAbsMaxObserver(activation_bits, moving_rate,
                                        device=layer.weight.device))


class QuantedLinear(Layer):
    def __init__(self, linear, weight_bits=8, activation_bits=8,
                 moving_rate=0.9):
        super().__init__()
        self.inner = linear
        self.weight_quanter, self.act_quanter = _observers(
            linear, weight_bits, activation_bits, moving_rate)

    def forward(self, x):
        """The fake-quantized product as the reference's: `ops.matmul`
        (cast under AMP), then the bias in its own dtype."""
        x = self.act_quanter(x)
        out = ops.matmul(x, self.weight_quanter(self.inner.weight))
        return out if self.inner.bias is None else out + self.inner.bias


class QuantedConv2D(Layer):
    def __init__(self, conv, weight_bits=8, activation_bits=8,
                 moving_rate=0.9):
        super().__init__()
        self.inner = conv
        self.weight_quanter, self.act_quanter = _observers(
            conv, weight_bits, activation_bits, moving_rate)

    def forward(self, x):
        x = self.act_quanter(x)
        c = self.inner
        return F.conv2d(x, self.weight_quanter(c.weight), c.bias, c._stride,
                        c._padding, c._dilation, c._groups, c._data_format)


__all__ = ["fake_quant", "ema_absmax_update", "FakeQuanterWithAbsMax",
           "MovingAverageAbsMaxObserver", "QuantedLinear", "QuantedConv2D"]
