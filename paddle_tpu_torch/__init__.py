"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

`paddle_tpu` (JAX, TPU) is the reference this package is held against.
The port grows slice by slice. It serves GPT through the paged
continuous-batching `serving.Engine`, trains GPT and pretrains BERT
(masked or not, unfused or through the fused layers of `incubate.nn`)
through `distributed.SpmdTrainStep`; attention runs in kernels written by
hand for Hopper (`kernels/csrc/`: paged decode attention, the qkv flash
kernels on the pair-major and the which-major projection, the general
[B,S,H,D] flash kernels), and so does the fused (residual +) LayerNorm
of `incubate.nn.functional._ln_maybe_fused`.

Nothing here imports ``jax`` or ``paddle_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (see `device`).
"""
from .device import DTYPES, resolve_device, resolve_dtype

__all__ = ["DTYPES", "resolve_device", "resolve_dtype"]
