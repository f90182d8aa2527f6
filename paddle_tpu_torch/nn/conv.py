"""Convolution layers with the reference's layouts.

Counterpart: ``paddle_tpu/nn/conv.py``. Weights are OIHW (``[out,
in/groups, *k]``); the transposes hold ``[in, out/groups, *k]``; the bias
is ``[out]``. The forward is `nn.functional`'s conv of the same name.
The weight is drawn XavierUniform (OIHW fans) and the bias zeros when
the layer is built, unless ``weight_attr``/``bias_attr`` say otherwise
(``bias_attr=False``: no bias); `nn.init_weights` draws the weight
again (it is listed in ``_init_normal``).

``padding_mode``: the reference takes it and pads with zeros whatever it
says; the port takes ``"zeros"`` and refuses the others rather than pad
otherwise than asked (ROADMAP C.3).
"""
from __future__ import annotations

from . import functional as F
from .functional.conv import _tuple
from .layer import Layer


class _ConvNd(Layer):
    _init_normal = ("weight",)

    def __init__(self, in_channels, out_channels, kernel_size, n, transposed,
                 stride=1, padding=0, output_padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        if padding_mode != "zeros":
            raise ValueError(f"padding_mode {padding_mode!r}: only 'zeros' "
                             "is taken (the reference pads with zeros "
                             "whatever the mode)")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _tuple(kernel_size, n)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        if transposed:
            shape = (in_channels, out_channels // groups) + self._kernel_size
        else:
            shape = (out_channels, in_channels // groups) + self._kernel_size
        self.weight = self.create_parameter(shape, attr=weight_attr)
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format,
                         device=device, dtype=dtype)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format,
                         device=device, dtype=dtype)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format,
                         device=device, dtype=dtype)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]
