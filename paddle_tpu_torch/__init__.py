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

The op namespace (A4): every tensor op of the reference's ``paddle.*``
at the top level (`ops`: creation, math, manipulation, linear algebra;
``import paddle_tpu_torch as paddle; paddle.matmul(x, y)``), the
`linalg`, `fft` and `signal` modules, and the reference's Tensor methods
that torch lacks (`ops.methods`). The namespace's functions have the
reference's meanings; a Tensor method torch already has keeps torch's.

Nothing here imports ``jax`` or ``paddle_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` or sets the CPU with
``set_device("cpu")`` (see `device`); so do the creation ops.
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
# the tensor op namespace (``paddle.*``): from here on ``sum``, ``max``,
# ``min``, ``abs``, ``all``, ``any``, ``round``, ``pow`` and ``slice``
# are the ops (this module uses none of the builtins they shadow)
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _op_names
from .ops import manip as _manip
from . import fft, linalg, signal  # noqa: E402

__all__ = ["DTYPES", "resolve_device", "resolve_dtype", "ParamAttr",
           "create_parameter", "LazyGuard", "regularizer", "no_grad",
           "enable_grad", "set_grad_enabled", "is_grad_enabled", "grad",
           "bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "NPUPlace", "device_count", "get_device", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "set_device", "seed", "get_rng_state",
           "set_rng_state", "get_cuda_rng_state", "set_cuda_rng_state",
           "Tensor", "Parameter", "amp", "autograd", "bool", "dtype",
           "linalg", "fft", "signal", "tanh_", "squeeze_", "unsqueeze_",
           "batch", "set_printoptions", "disable_signal_handler",
           "in_dynamic_mode", "save", "load", "set_default_dtype",
           "get_default_dtype", "iinfo", "finfo"]
__all__ += [n for n in _op_names if n not in __all__]

bool = bool_        # paddle.bool
dtype = _torch.dtype    # paddle.dtype: the port's dtypes are torch's


def tanh_(x, name=None):
    return x.tanh_()


def squeeze_(x, axis=None, name=None):
    """``x`` with its size-1 dims ``axis`` (all: None) removed, in
    place."""
    axes = tuple(range(x.ndim)) if axis is None else axis
    dims = _manip._squeeze_axes(x, axes)
    return x.squeeze_(dims) if dims else x


def unsqueeze_(x, axis, name=None):
    for a in _manip._unsqueeze_axes(x, axis):
        x.unsqueeze_(a)
    return x


def batch(reader, batch_size, drop_last=False):
    """Old-style reader decorator: a sample reader made a batch reader
    (``paddle_tpu/__init__.py:127-139``)."""
    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batch_reader


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor printing options (torch's, as tensors print through
    torch)."""
    _torch.set_printoptions(precision=precision, threshold=threshold,
                            edgeitems=edgeitems, linewidth=linewidth,
                            sci_mode=sci_mode)


def disable_signal_handler():
    """Nothing to do: the port installs no fault handlers."""
    return None


def in_dynamic_mode():
    """Always True: the port runs eagerly (static graphs are ROADMAP
    A14)."""
    return True


def save(obj, path, protocol=4, **kwargs):
    from .framework.io import save as _save
    return _save(obj, path, protocol=protocol, **kwargs)


def load(path, **kwargs):
    from .framework.io import load as _load
    return _load(path, **kwargs)


_DEFAULT_DTYPE = ["float32"]


def set_default_dtype(d):
    """Record the default dtype's name (the reference records it and its
    creation ops keep their own defaults)."""
    from .core.dtype import convert_dtype, dtype_name
    _DEFAULT_DTYPE[0] = dtype_name(convert_dtype(d))


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def iinfo(dtype):
    from .core.dtype import convert_dtype
    return _torch.iinfo(convert_dtype(dtype))


def finfo(dtype):
    from .core.dtype import convert_dtype
    return _torch.finfo(convert_dtype(dtype))


#: the reference's lazily imported subpackages that the port has
_LAZY_SUBMODULES = ("nn", "optimizer", "jit", "distributed", "vision",
                    "incubate", "framework", "device", "regularizer",
                    "quantization", "serving", "observability", "models",
                    "kernels", "testing", "core", "ops", "profiler")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                         f"{name!r}")

