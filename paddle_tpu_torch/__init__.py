"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

`paddle_tpu` (JAX, TPU) is the reference this package is held against.
The port grows slice by slice. It serves GPT through the paged
continuous-batching `serving.Engine`, trains GPT and pretrains BERT
(masked or not, unfused or through the fused layers of `incubate.nn`),
ViT and the encoder-decoder `nn.Transformer` through
`distributed.SpmdTrainStep`, decodes with `nn.Transformer`'s caches and
`incubate.nn.FusedMultiTransformer`'s CacheKV, runs the MoE layer
(`incubate.distributed.models.moe`) on one card, and builds and trains
the reference's ResNet family (`vision.models`) from `nn`'s
convolutions, batch norms, activations, pooling and losses; attention runs in
kernels written by hand for Hopper (`kernels/csrc/`: paged decode
attention, the qkv flash kernels on the pair-major and the which-major
projection, the general [B,S,H,D] flash kernels), and so does the fused
(residual +) LayerNorm of `incubate.nn.functional._ln_maybe_fused`.

Layers derive from `nn.Layer` (a ``torch.nn.Module`` with the
reference's construction, traversal and state-dict rules) and draw their
parameters when built (`ParamAttr`, `nn.initializer`); `LazyGuard`
defers the draw, `regularizer` gives a parameter its weight decay.

Nothing here imports ``jax`` or ``paddle_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (see `device`).
"""
from . import regularizer
from .device import DTYPES, resolve_device, resolve_dtype
from .framework.param_attr import ParamAttr, create_parameter
from .nn.layer import LazyGuard

__all__ = ["DTYPES", "resolve_device", "resolve_dtype", "ParamAttr",
           "create_parameter", "LazyGuard", "regularizer"]
