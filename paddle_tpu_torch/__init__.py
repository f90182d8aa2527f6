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

The core (A2, A3): the reference's dtypes (float16 among them), places
(`CUDAPlace`, `set_device`), its Tensor surface on ``torch.Tensor``
itself (`core.tensor`), autograd over ``torch.autograd`` (`grad`,
`autograd.PyLayer`), the seeds and generator states, and mixed precision
(`amp.auto_cast` O1/O2 on `core.dispatch`'s hook, `amp.decorate`,
`amp.GradScaler`); the flash and Adam kernels take float16.

Nothing here imports ``jax`` or ``paddle_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` or sets the CPU with
``set_device("cpu")`` (see `device`).
"""
import torch as _torch

from . import regularizer
from .device import DTYPES, resolve_device, resolve_dtype
from .framework.param_attr import ParamAttr, create_parameter
from .nn.layer import LazyGuard
from .core.autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                            set_grad_enabled)
from .core.dtype import (bfloat16, bool_, complex64, complex128, float16,
                         float32, float64, int8, int16, int32, int64, uint8)
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace,
                         Place, TPUPlace, device_count, get_device,
                         is_compiled_with_cuda, is_compiled_with_tpu,
                         set_device)
from .core.random import get_rng_state, seed, set_rng_state
# the device generators' states under the reference's CUDA names
# (``paddle_tpu/__init__.py:88-92``)
from .core.random import get_rng_state as get_cuda_rng_state
from .core.random import set_rng_state as set_cuda_rng_state
from .core.tensor import Parameter, Tensor
from . import amp, autograd

__all__ = ["DTYPES", "resolve_device", "resolve_dtype", "ParamAttr",
           "create_parameter", "LazyGuard", "regularizer", "no_grad",
           "enable_grad", "set_grad_enabled", "is_grad_enabled", "grad",
           "bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "NPUPlace", "device_count", "get_device", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "set_device", "seed", "get_rng_state",
           "set_rng_state", "get_cuda_rng_state", "set_cuda_rng_state",
           "Tensor", "Parameter", "amp", "autograd", "bool", "dtype"]

bool = bool_        # paddle.bool
dtype = _torch.dtype    # paddle.dtype: the port's dtypes are torch's
