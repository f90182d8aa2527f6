"""The common layers (``paddle_tpu/nn/common.py``).

`Linear` and `Embedding` keep paddle_tpu's parameter layouts and
defaults (:25-67), so that a ``paddle_tpu`` state dict loads key for key
(`models.convert`). Their parameters are drawn when they are built
(`nn.Layer.create_parameter`); the models then draw theirs again from a
seed (`init_weights`). `Bilinear`'s weight ``[out, in1, in2]`` is drawn
XavierUniform, its bias ``[out]`` zeros. The others hold no parameter:
`Identity`, `Flatten`, the dropouts (`Dropout` lives in `nn.layer`),
the upsampling, padding and shuffling layers, `CosineSimilarity` and
`Unfold`, each calling its `nn.functional` function with the
reference's arguments."""
from __future__ import annotations

import torch

from . import functional as F
from .initializer import Normal, XavierUniform
from .layer import Layer
from .norm import LayerNorm


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(Layer):
    """``y = x @ W + b`` with ``W [in, out]`` (paddle_tpu's layout,
    ``paddle_tpu/nn/functional/common.py:23``), instead of
    ``nn.Linear``'s ``[out, in]``. ``W`` XavierUniform, ``b`` zeros,
    unless the attrs say otherwise; ``bias_attr=False``: no bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


@torch.no_grad()
def _zero_row(weight, row):
    weight[row] = 0.0
    return weight


class Embedding(Layer):
    """Rows of ``weight [num_embeddings, embedding_dim]`` by id
    (``paddle_tpu/nn/functional/common.py:76-87``), drawn Normal(0, 1).
    ``padding_idx`` (negative counts from the end): that row starts at
    zero and every id equal to it looks up zeros (so the row gets no
    gradient). ``sparse`` is taken and ignored, as in the reference."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = None if padding_idx is None else (
            padding_idx if padding_idx >= 0
            else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if self._padding_idx is not None:
            if self.weight._init_fn is not None:
                draw, pidx = self.weight._init_fn, self._padding_idx
                self.weight._init_fn = lambda: _zero_row(draw(), pidx)
            else:
                _zero_row(self.weight, self._padding_idx)

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class _PadNd(Layer):
    def __init__(self, padding, mode, value, data_format):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


@torch.no_grad()
def init_weights(model, seed, std):
    """The models' random init, from a generator seeded with ``seed`` on
    the model's device: weights of every `Linear` and `Embedding` normal
    ``(0, std)``, their biases zero, LayerNorm scales one and shifts
    zero. A layer that holds raw parameters (the fused layers, the
    convolutions) lists its matrices in ``_init_normal`` (paths below
    it, as ``qkv_weights.0``); they are drawn by the same rule, and its
    biases and LayerNorm scales keep the values they were built with."""
    dev = next(iter(model.parameters())).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, (Linear, Embedding)):
            mod.weight.normal_(0.0, std, generator=gen)
        for name in getattr(mod, "_init_normal", ()):
            mod.get_parameter(name).normal_(0.0, std, generator=gen)
        if isinstance(mod, Linear) and mod.bias is not None:
            mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            if mod.weight is not None:
                mod.weight.fill_(1.0)
            if mod.bias is not None:
                mod.bias.zero_()


__all__ = ["Identity", "Linear", "Embedding", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
           "PixelShuffle", "PixelUnshuffle", "ChannelShuffle", "Bilinear",
           "CosineSimilarity", "Unfold", "init_weights"]
