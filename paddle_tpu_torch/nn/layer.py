"""Layers of the port that have no torch twin with the reference's
semantics: `Dropout` (``paddle_tpu/nn/layer/common.py``; upscale_in_train,
random bits from the current `core.random` generator)."""
from __future__ import annotations

from torch import nn

from . import functional as F


class Dropout(nn.Module):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)

    def extra_repr(self):
        return f"p={self.p}"


__all__ = ["Dropout"]
