"""The pooling layers (``paddle_tpu/nn/pooling.py``): each holds its
arguments and calls the `nn.functional.pooling` function of its name;
the adaptive ones take ``output_size`` only (any other argument is
taken and ignored, as in the reference)."""
from __future__ import annotations

from . import functional as F
from .layer import Layer


class _Pool(Layer):
    _fn = None

    def __init__(self, kernel_size=None, stride=None, padding=0, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kw = {k: v for k, v in kw.items() if k != "name"}

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding,
                              **self.kw)


class MaxPool1D(_Pool):
    _fn = F.max_pool1d


class MaxPool2D(_Pool):
    _fn = F.max_pool2d


class MaxPool3D(_Pool):
    _fn = F.max_pool3d


class AvgPool1D(_Pool):
    _fn = F.avg_pool1d


class AvgPool2D(_Pool):
    _fn = F.avg_pool2d


class AvgPool3D(_Pool):
    _fn = F.avg_pool3d


class _AdaptivePool(Layer):
    _fn = None

    def __init__(self, output_size, **kw):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return type(self)._fn(x, self.output_size)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = F.adaptive_avg_pool1d


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = F.adaptive_avg_pool2d


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = F.adaptive_avg_pool3d


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = F.adaptive_max_pool1d


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = F.adaptive_max_pool2d


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = F.adaptive_max_pool3d


__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]
