"""Quantization: the fake-quant layers and their observer
(`quantization.layers`, the counterpart of ``paddle_tpu/quantization/
layers.py``). The reference's ``imperative.py`` (QAT, PTQ,
QuantConfig) is still to port (ROADMAP A14)."""
from .layers import (FakeQuanterWithAbsMax, MovingAverageAbsMaxObserver,
                     QuantedConv2D, QuantedLinear, fake_quant)

__all__ = ["fake_quant", "FakeQuanterWithAbsMax",
           "MovingAverageAbsMaxObserver", "QuantedLinear", "QuantedConv2D"]
