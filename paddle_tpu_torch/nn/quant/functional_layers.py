"""Observable functional layers (``paddle_tpu/nn/quant/
functional_layers.py``): tensor ops as layers, so that a quantization
pass can attach observers to them."""
from __future__ import annotations

import torch

from ..layer import Layer


class FloatFunctionalLayer(Layer):
    pass


class add(FloatFunctionalLayer):
    def forward(self, x, y, name=None):
        return torch.add(x, y)


class subtract(FloatFunctionalLayer):
    def forward(self, x, y, name=None):
        return torch.subtract(x, y)


class multiply(FloatFunctionalLayer):
    def forward(self, x, y, name=None):
        return torch.multiply(x, y)


class divide(FloatFunctionalLayer):
    def forward(self, x, y, name=None):
        return torch.divide(x, y)


class reshape(FloatFunctionalLayer):
    def forward(self, x, shape, name=None):
        return x.reshape(shape)


class transpose(FloatFunctionalLayer):
    def forward(self, x, perm, name=None):
        return x.permute(*perm)


class concat(FloatFunctionalLayer):
    def forward(self, x, axis=0, name=None):
        return torch.cat(list(x), dim=axis)


class flatten(FloatFunctionalLayer):
    def forward(self, x, start_axis=0, stop_axis=-1, name=None):
        return torch.flatten(x, start_axis, stop_axis)


__all__ = ["FloatFunctionalLayer", "add", "subtract", "multiply", "divide",
           "reshape", "transpose", "concat", "flatten"]
