"""Hand-written Hopper kernels and their plain PyTorch versions.

Every kernel module here pairs a kernel wrapper with a plain PyTorch
version of the same function. The dispatch rule is the same for all:

- a tensor on the CPU goes to the plain version (the CPU tests run it,
  and `chip_smoke.py` holds the kernel against it on the card);
- a tensor on a CUDA device goes to the kernel, or the wrapper raises.
  Nothing falls back on CUDA, so there is no fallback counter.

Each wrapper adds one to its kernel's launch count where it launches the
kernel and nowhere else, so a run can show that its main path went
through the kernel (`kernel_launch_counts`).
"""
from __future__ import annotations

import torch

#: launches per kernel since the last `reset_kernel_launch_counts`
_LAUNCHES = {"paged_attention": 0}


def kernel_launch_counts() -> dict:
    """Snapshot of the per-kernel launch counts."""
    return dict(_LAUNCHES)


def reset_kernel_launch_counts():
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def count_launch(name: str):
    """Called by a wrapper right after its kernel launched."""
    _LAUNCHES[name] += 1


def runs_plain(t: torch.Tensor, kernel: str) -> bool:
    """The dispatch rule: True for a CPU tensor (plain version), False
    for a CUDA tensor (the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise RuntimeError(f"{kernel}: no kernel for device {t.device}")


__all__ = ["kernel_launch_counts", "reset_kernel_launch_counts",
           "count_launch", "runs_plain"]
