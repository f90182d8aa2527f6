"""Fused transformer layers (`layers`) and functionals (`functional`).

Counterpart: ``paddle_tpu/incubate/nn/__init__.py``. ``FusedLinear`` is
`nn.Linear`: the gemm epilogue it names is one product plus a bias here,
as the reference leaves it to XLA."""
from . import functional
from ...nn.common import Linear
from .layers import (FusedBiasDropoutResidualLayerNorm, FusedFeedForward,
                     FusedMultiHeadAttention, FusedMultiTransformer,
                     FusedTransformerEncoderLayer)


class FusedLinear(Linear):
    pass


__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedBiasDropoutResidualLayerNorm", "FusedLinear", "functional"]
