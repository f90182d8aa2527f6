"""Neural-network pieces of the port: `functional`, the layers with
paddle_tpu's layouts (`Linear`, `Embedding`, `LayerNorm`, `Dropout`, the
convolutions), the transformer layers (`MultiHeadAttention` with its
caches, the encoder and decoder layers and stacks, `Transformer`) and
gradient clipping (`clip`)."""
from . import functional
from .clip import (
    ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
    clip_grad_norm_,
)
from .common import Embedding, Linear, init_weights
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .layer import Dropout
from .norm import LayerNorm
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["functional", "ClipGradBase", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
           "Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose",
           "Conv3D", "Conv3DTranspose", "Dropout", "Embedding",
           "LayerNorm", "Linear", "MultiHeadAttention", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer", "init_weights"]
