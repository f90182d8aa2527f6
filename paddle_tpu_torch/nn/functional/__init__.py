"""`nn.functional`, in the reference's package layout
(``paddle_tpu/nn/functional/__init__.py``): `activation`, `common`,
`conv`, `loss`, `norm`, `pooling`, `vision` and `extra`, each the torch
counterpart of the reference module of that name (`extra`'s
`max_pool_with_mask` lives in `pooling`, which calls it). Every name is
importable from here, and so are the kernel entries the functions
call: ``flash_attention`` (B2's, which `scaled_dot_product_attention`
reads from here when called), ``flash_attention_enabled`` (its gate)
and ``softmax_ce_logits`` (`cross_entropy`'s fused branch).
"""
from ...kernels import flash_attention_enabled  # noqa: F401
from ...kernels.flash_attention import flash_attention  # noqa: F401
from ...kernels.fused_ce import softmax_ce_logits  # noqa: F401
from .activation import (celu, elu, gelu, glu, gumbel_softmax, hardshrink,
                         hardsigmoid, hardswish, hardtanh, leaky_relu,
                         log_sigmoid, log_softmax, maxout, mish, prelu, relu,
                         relu6, relu_, rrelu, selu, sigmoid, silu, softmax,
                         softplus, softshrink, softsign, swish, tanh,
                         tanhshrink, thresholded_relu)
from .common import (alpha_dropout, bilinear, channel_shuffle,
                     cosine_similarity, dropout, dropout2d, dropout3d,
                     embedding, interpolate, label_smooth, linear,
                     mt_attention_core, normalize, one_hot, pad,
                     pixel_shuffle, pixel_unshuffle,
                     scaled_dot_product_attention, sequence_mask, unfold,
                     upsample)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cosine_embedding_loss, cross_entropy, dice_loss,
                   hinge_embedding_loss, kl_div, l1_loss, log_loss,
                   margin_ranking_loss, mse_loss, nll_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d, max_pool_with_mask)
from .vision import affine_grid, fold, grid_sample, temporal_shift
from .extra import (class_center_sample, ctc_loss, diag_embed, elu_,
                    gather_tree, hsigmoid_loss, margin_cross_entropy,
                    max_unpool1d, max_unpool2d, max_unpool3d,
                    multi_label_soft_margin_loss, multi_margin_loss,
                    npair_loss, pairwise_distance, sigmoid_focal_loss,
                    soft_margin_loss, softmax_, sparse_attention, tanh_,
                    triplet_margin_with_distance_loss, zeropad2d)
from . import activation, common, conv, extra, loss, norm, pooling, vision

__all__ = [*activation.__all__, *common.__all__, *conv.__all__,
           *loss.__all__, *norm.__all__, *pooling.__all__, *vision.__all__,
           *extra.__all__]
