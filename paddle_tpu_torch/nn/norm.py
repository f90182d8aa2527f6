"""The normalisation layers (``paddle_tpu/nn/norm.py``), their math in
float32 whatever the input dtype, cast back (`nn.functional.norm`).

Scales start at ``Constant(1.0)`` and shifts at zeros unless the attrs
say otherwise; an attr False leaves that parameter out (None). The batch
norms hold float32 running statistics as the buffers ``_mean`` (zeros)
and ``_variance`` (ones), the reference's names, so state dicts carry
across by name (`models.convert.load_layer_state_dict`), and update them
with the reference's momentum (0.9 keeps 90% of the old value).
`SyncBatchNorm` on one process is `BatchNorm`; in a `torch.distributed`
world of more than one rank it raises, its cross-rank statistics being
ROADMAP A12. `SpectralNorm` draws its power-iteration vectors
``weight_u``, ``weight_v`` (persistable buffers, not updated by the
forward, as in the reference) from the current `core.random` generator.
"""
from __future__ import annotations

import math

import torch

from ..core import random as _random
from ..device import resolve_device
from . import functional as F
from .initializer import Constant
from .layer import Layer


class LayerNorm(Layer):
    """LayerNorm over the last ``normalized_shape`` dims with the
    reference's ``epsilon``."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape,
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _ScaleShift(Layer):
    """A layer with a ``[num_features]`` scale and shift."""

    def __init__(self, num_features, weight_attr, bias_attr, device, dtype):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)


class _BatchNormBase(_ScaleShift):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(num_features, weight_attr, bias_attr, device, dtype)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(
            [num_features], dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            [num_features], dtype=torch.float32, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCL" else "NLC",
                         use_global_stats, name, device=device, dtype=dtype)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         "NCHW" if data_format == "NCDHW" else "NDHWC",
                         use_global_stats, name, device=device, dtype=dtype)


class SyncBatchNorm(_BatchNormBase):
    """`BatchNorm` on one process (the reference's statistics are the
    local batch's unless a mesh shards it)."""

    def forward(self, x):
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise NotImplementedError(
                "SyncBatchNorm across ranks (cross-rank batch statistics) "
                "is ROADMAP A12")
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm below it (itself included)
        replaced by a `SyncBatchNorm` holding its values."""
        out = layer
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                device=layer._mean.device)
            with torch.no_grad():
                for name in ("weight", "bias", "_mean", "_variance"):
                    src = getattr(layer, name)
                    if src is not None:
                        getattr(out, name).copy_(src)
        for name, sub in list(layer._modules.items()):
            if sub is not None:
                layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return out


class GroupNorm(_ScaleShift):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__(num_channels, weight_attr, bias_attr, device, dtype)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(_ScaleShift):
    """Channels first whatever ``data_format`` says, as in the
    reference."""

    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__(num_features, weight_attr, bias_attr, device, dtype)
        self._epsilon = epsilon

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma the largest singular value of ``weight``
    folded to ``[shape[dim], -1]``, estimated by ``power_iters`` steps
    from ``weight_u``, ``weight_v`` (gradients flow through the steps)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", *, device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        dev = resolve_device(device)
        gen = _random.current_generator(dev)
        self.register_buffer("weight_u", torch.randn(h, generator=gen,
                                                     device=dev))
        self.register_buffer("weight_v", torch.randn(w, generator=gen,
                                                     device=dev))

    def forward(self, weight):
        w = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = w.T @ u
            v = v / (torch.linalg.vector_norm(v) + self._epsilon)
            u = w @ v
            u = u / (torch.linalg.vector_norm(u) + self._epsilon)
        return weight / (u @ w @ v)


__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm"]
