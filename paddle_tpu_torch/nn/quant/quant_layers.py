"""The ``nn.quant.quant_layers`` module path (``paddle_tpu/nn/quant/
quant_layers.py``); the classes live in the package's ``__init__``."""
from . import (  # noqa: F401
    FakeQuantAbsMax, FakeQuantChannelWiseAbsMax, FakeQuantMAOutputScaleLayer,
    FakeQuantMovingAverageAbsMax, MAOutputScaleLayer,
    MovingAverageAbsMaxScale, QuantizedColumnParallelLinear,
    QuantizedConv2D, QuantizedConv2DTranspose, QuantizedLinear,
    QuantizedRowParallelLinear, QuantStub,
)

__all__ = ["FakeQuantAbsMax", "FakeQuantMovingAverageAbsMax",
           "FakeQuantChannelWiseAbsMax", "QuantizedConv2D",
           "QuantizedConv2DTranspose", "QuantizedLinear",
           "MovingAverageAbsMaxScale", "MAOutputScaleLayer",
           "FakeQuantMAOutputScaleLayer", "QuantStub",
           "QuantizedRowParallelLinear", "QuantizedColumnParallelLinear"]
