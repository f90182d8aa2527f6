"""Neural-network pieces of the port: `functional`, the layers with
paddle_tpu's layouts (`Linear`, `Embedding`, `LayerNorm`, `Dropout`),
the transformer layers (`MultiHeadAttention`, `TransformerEncoderLayer`)
and gradient clipping (`clip`)."""
from . import functional
from .clip import (
    ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
    clip_grad_norm_,
)
from .common import Embedding, Linear, init_weights
from .layer import Dropout
from .norm import LayerNorm
from .transformer import MultiHeadAttention, TransformerEncoderLayer

__all__ = ["functional", "ClipGradBase", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
           "Dropout", "Embedding",
           "LayerNorm", "Linear", "MultiHeadAttention",
           "TransformerEncoderLayer", "init_weights"]
