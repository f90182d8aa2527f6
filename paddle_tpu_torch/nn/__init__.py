"""Neural-network pieces of the port: the layer base (`Layer`,
`LazyGuard`), the containers (`Sequential`, `LayerList`, `LayerDict`,
`ParameterList`), the initializers (`initializer`), `functional`, the
layers with paddle_tpu's layouts and default initializers (`Linear`,
`Embedding`, `LayerNorm`, `Dropout`, the convolutions), the transformer
layers (`MultiHeadAttention` with its caches, the encoder and decoder
layers and stacks, `Transformer`) and gradient clipping (`clip`)."""
from . import functional, initializer
from .clip import (
    ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
    clip_grad_norm_,
)
from .common import Embedding, Linear, init_weights
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .layer import Dropout, HookRemoveHelper, Layer, LazyGuard
from .norm import LayerNorm
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["functional", "initializer", "ClipGradBase",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "Conv1D", "Conv1DTranspose", "Conv2D",
           "Conv2DTranspose", "Conv3D", "Conv3DTranspose", "Dropout",
           "Embedding", "HookRemoveHelper", "Layer", "LayerDict",
           "LayerList", "LayerNorm", "LazyGuard", "Linear",
           "MultiHeadAttention", "ParameterList", "Sequential",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer", "init_weights"]
