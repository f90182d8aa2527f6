"""`LayerNorm` computed in float32 and cast back to the input dtype
(``paddle_tpu/nn/norm.py:20-45``, ``nn/functional/norm.py:19-39``)."""
from __future__ import annotations

from torch import nn

from . import functional as F


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last ``normalized_shape`` dims with the
    reference's ``epsilon`` argument; unit weight and zero bias."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None,
                 dtype=None):
        super().__init__(normalized_shape, eps=epsilon, device=device,
                         dtype=dtype)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.eps)


__all__ = ["LayerNorm"]
