"""Device placement: `Place`, `CPUPlace`, `CUDAPlace` and the expected
place.

Counterpart: ``paddle_tpu/core/place.py``. There a place wraps a JAX
device and ``CUDAPlace`` is an alias of ``TPUPlace``; here a place wraps
a `torch.device`: `CUDAPlace(i)` is the CUDA card ``i``, `CPUPlace` the
host and `CUDAPinnedPlace` pinned host memory. `TPUPlace` and
`NPUPlace` raise: the port runs on NVIDIA GPUs.

`set_device` sets the expected place of the process (``"gpu"``,
``"gpu:1"``, ``"cuda:0"``, ``"cpu"``). `device.resolve_device` reads
it: an entry point given no ``device`` runs there, and without one set
on ``cuda``, or raises when no GPU is visible; so ``set_device("cpu")``
is the caller asking for the CPU. A place's ``platform`` is ``"gpu"`` or
``"cpu"``, so `get_device` reads ``"gpu:0"`` as the reference's
``paddle.device.get_device`` does on a GPU.
"""
from __future__ import annotations

import torch

from .. import device as _device

_NO_TPU = ("paddle_tpu_torch runs on NVIDIA GPUs (CUDAPlace) and the "
           "host (CPUPlace); there is no {} here")


class Place:
    """A logical device: wraps a `torch.device`."""

    def __init__(self, device):
        self._device = torch.device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def platform(self) -> str:
        return "gpu" if self._device.type == "cuda" else self._device.type

    @property
    def id(self) -> int:
        return self._device.index or 0

    def is_cpu_place(self) -> bool:
        return self._device.type == "cpu"

    def is_tpu_place(self) -> bool:
        return False

    def is_gpu_place(self) -> bool:
        return self._device.type == "cuda"

    def __eq__(self, other):
        return isinstance(other, Place) and self._device == other._device

    def __hash__(self):
        return hash(self._device)

    def __repr__(self):
        return f"Place({self.platform}:{self.id})"


class CPUPlace(Place):
    def __init__(self, idx: int = 0):
        super().__init__("cpu")


class CUDAPlace(Place):
    """CUDA card ``idx``."""

    def __init__(self, idx: int = 0):
        super().__init__(torch.device("cuda", int(idx)))


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: `Tensor.to` pins a tensor moved here."""


class TPUPlace(Place):
    def __init__(self, idx: int = 0):
        raise RuntimeError(_NO_TPU.format("TPU"))


class NPUPlace(Place):
    def __init__(self, idx: int = 0):
        raise RuntimeError(_NO_TPU.format("NPU"))


def place_of(device) -> Place:
    """The `Place` of a `torch.device` (or device spec)."""
    dev = torch.device(device)
    return CUDAPlace(dev.index or 0) if dev.type == "cuda" else Place(dev)


def expected_place() -> Place:
    """The place an entry point given no device runs on (`set_device`'s,
    else the current CUDA card; raises when there is none)."""
    return place_of(_device.resolve_device(None))


def get_device() -> str:
    p = expected_place()
    return f"{p.platform}:{p.id}"


def set_device(device: str) -> Place:
    """``"cpu"``, ``"gpu"``, ``"gpu:i"`` or ``"cuda:i"``: the expected
    place from now on, for the whole process. Returns it."""
    plat, _, idx = str(device).partition(":")
    if plat in ("tpu", "npu"):
        raise RuntimeError(_NO_TPU.format(plat.upper()))
    if plat == "cpu":
        place = CPUPlace()
    elif plat in ("gpu", "cuda"):
        place = CUDAPlace(int(idx or 0))
    else:
        raise ValueError(f"unknown device {device!r}: use 'cpu', 'gpu' or "
                         "'gpu:<index>'")
    _device.set_expected_device(place.device)
    return place


def is_compiled_with_cuda() -> bool:
    return True


def is_compiled_with_tpu() -> bool:
    return False


def device_count() -> int:
    """The number of visible CUDA cards."""
    return torch.cuda.device_count()


__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "NPUPlace", "place_of", "expected_place", "get_device",
           "set_device", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "device_count"]
