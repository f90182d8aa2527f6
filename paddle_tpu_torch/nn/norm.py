"""`LayerNorm` computed in float32 and cast back to the input dtype
(``paddle_tpu/nn/norm.py:20-45``, ``nn/functional/norm.py:19-39``)."""
from __future__ import annotations

from . import functional as F
from .initializer import Constant
from .layer import Layer


class LayerNorm(Layer):
    """LayerNorm over the last ``normalized_shape`` dims with the
    reference's ``epsilon``: scale ``Constant(1.0)``, shift zeros, unless
    the attrs say otherwise; an attr False leaves that parameter out
    (None)."""

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


__all__ = ["LayerNorm"]
