"""The long tail of the layers (``paddle_tpu/nn/extra_layers.py``):
`Fold`, `PairwiseDistance`, `Silu`, `Softmax2D` (softmax over the
channel dim of a 3-D or 4-D input), `MaxUnPool1D/2D/3D`, the margin and
soft-margin losses, `CTCLoss` and `HSigmoidLoss`. Each calls its
`nn.functional` function with the reference's arguments.
`HSigmoidLoss`'s weight ``[rows, feature_size]`` and bias ``[rows]``
have ``num_classes - 1`` rows on the default tree, ``num_classes`` with
``is_custom`` (:137-163), drawn by `create_parameter`'s defaults
(XavierUniform, zeros); with ``is_custom`` its forward needs
``path_table`` and ``path_code``."""
from __future__ import annotations

from . import functional as F
from .layer import Layer


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._args = (output_sizes, kernel_sizes, strides, paddings,
                      dilations)

    def forward(self, x):
        return F.fold(x, *self._args)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Silu(Layer):
    def forward(self, x):
        return F.silu(x)


class Softmax2D(Layer):
    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError(f"Softmax2D expects a 3-D or 4-D input, got "
                             f"{x.dim()}-D")
        return F.softmax(x, axis=-3)


class _MaxUnPoolNd(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self._args
        return type(self)._fn(x, indices, k, s, p, df, osz)


class MaxUnPool1D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool1d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool2D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool2d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool3D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool3d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self._cfg = (p, margin, weight, reduction)

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, *self._cfg)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._cfg = (distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):
        d, m, s, r = self._cfg
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, distance_function=d, margin=m,
            swap=s, reduction=r)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.num_classes = num_classes
        self._is_custom = is_custom
        rows = num_classes if is_custom else num_classes - 1
        self.weight = self.create_parameter([rows, feature_size],
                                            attr=weight_attr)
        self.bias = self.create_parameter([rows], attr=bias_attr,
                                          is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        if self._is_custom and (path_table is None or path_code is None):
            raise ValueError(
                "HSigmoidLoss(is_custom=True): forward needs path_table "
                "and path_code")
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table=path_table,
                               path_code=path_code)


__all__ = ["Fold", "PairwiseDistance", "Silu", "Softmax2D", "MaxUnPool1D",
           "MaxUnPool2D", "MaxUnPool3D", "SoftMarginLoss",
           "MultiLabelSoftMarginLoss", "MultiMarginLoss",
           "TripletMarginWithDistanceLoss", "CTCLoss", "HSigmoidLoss"]
