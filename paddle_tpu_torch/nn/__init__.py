"""Neural-network pieces of the port: the layer base (`Layer`,
`LazyGuard`), the containers (`Sequential`, `LayerList`, `LayerDict`,
`ParameterList`), the initializers (`initializer`), `functional` (the
reference's package layout), the activation and loss layers, the
normalisations (`LayerNorm`, the batch, group, instance, RMS,
local-response and spectral norms), pooling, the common layers
(`Linear`, `Embedding`, `Identity`, `Flatten`, the dropouts, padding,
upsampling, shuffling, `Bilinear`, ...) with paddle_tpu's layouts and
default initializers, the convolutions, the transformer layers
(`MultiHeadAttention` with its caches, the encoder and decoder layers
and stacks, `Transformer`), gradient clipping (`clip`), the recurrent
layers (`rnn`: the cells, `RNN`, `BiRNN`, `SimpleRNN`, `LSTM`, `GRU`),
beam search (`BeamSearchDecoder`, `dynamic_decode`), the long tail of
layers (`extra_layers`), `utils` (weight and spectral norm, parameter
vectors) and `quant` (fake-quant layers and quantized wrappers)."""
from . import functional, initializer
from .activation import (CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                         LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU,
                         SELU, Sigmoid, SiLU, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .clip import (
    ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
    clip_grad_norm_,
)
from .common import (AlphaDropout, Bilinear, ChannelShuffle,
                     CosineSimilarity, Dropout2D, Dropout3D, Embedding,
                     Flatten, Identity, Linear, Pad1D, Pad2D, Pad3D,
                     PixelShuffle, PixelUnshuffle, Unfold, Upsample,
                     UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D,
                     init_weights)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .layer import Dropout, HookRemoveHelper, Layer, LazyGuard
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, HingeEmbeddingLoss, KLDivLoss, L1Loss,
                   MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                   TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LayerNorm, LocalResponseNorm, RMSNorm, SpectralNorm,
                   SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)
from .rnn import (BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNN, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)
from .extra_layers import (CTCLoss, Fold, HSigmoidLoss, MaxUnPool1D,
                           MaxUnPool2D, MaxUnPool3D, MultiLabelSoftMarginLoss,
                           MultiMarginLoss, PairwiseDistance, Silu,
                           SoftMarginLoss, Softmax2D,
                           TripletMarginWithDistanceLoss)
from .decode import BeamSearchDecoder, dynamic_decode
from . import (activation, common, extra_layers, loss, norm, pooling, quant,
               rnn, utils)

__all__ = ["functional", "initializer", "ClipGradBase",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "Conv1D", "Conv1DTranspose", "Conv2D",
           "Conv2DTranspose", "Conv3D", "Conv3DTranspose", "Dropout",
           "HookRemoveHelper", "Layer", "LayerDict", "LayerList",
           "LazyGuard", "MultiHeadAttention", "ParameterList", "Sequential",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "BeamSearchDecoder", "dynamic_decode", "utils", "quant",
           *rnn.__all__, *extra_layers.__all__, *activation.__all__, *common.__all__, *loss.__all__,
           *norm.__all__, *pooling.__all__]
