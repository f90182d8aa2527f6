"""Random state of the port: explicit generators, one scope per step.

Counterpart: ``paddle_tpu/core/random.py`` (``rng_guard``, ``next_key``)
and ``paddle_tpu/kernels/flash_attention.py:135-144`` (``_seed_arr``).
JAX threads a key; the port threads a `torch.Generator`:

- `rng_guard(generator)` makes ``generator`` the source of every random
  draw inside the scope, on this thread (dropout masks, the flash
  kernels' seed). The train step opens one per step, from the step's
  ``key`` (`step_generator`).
- Outside any scope, draws come from the port's own default generator
  for the device, seeded with 0 (never from torch's global one).
- `flash_seed` draws the int32 seed of the flash kernels' in-kernel
  dropout hash, masked to 31 bits as ``_seed_arr`` does. It stays on the
  device: the kernels read it from there, so drawing it costs no
  host-device synchronisation.

Torch's generators and JAX's keys give different numbers from the same
seed; tests hand both packages the same numpy inputs instead.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_local = threading.local()
_DEFAULTS: dict = {}
_DEFAULTS_LOCK = threading.Lock()


def _guards() -> list:
    if not hasattr(_local, "guards"):
        _local.guards = []
    return _local.guards


def step_generator(key, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded from an int ``key``."""
    return torch.Generator(device=torch.device(device)).manual_seed(
        int(key) & 0x7FFF_FFFF_FFFF_FFFF)


@contextlib.contextmanager
def rng_guard(generator: torch.Generator):
    """Scope in which random draws on this thread come from
    ``generator``."""
    guards = _guards()
    guards.append(generator)
    try:
        yield generator
    finally:
        guards.pop()


def current_generator(device) -> torch.Generator:
    """The innermost `rng_guard`'s generator when it lives on ``device``'s
    type, else the default generator of ``device``."""
    device = torch.device(device)
    guards = _guards()
    if guards and guards[-1].device.type == device.type:
        return guards[-1]
    with _DEFAULTS_LOCK:
        gen = _DEFAULTS.get(str(device))
        if gen is None:
            gen = _DEFAULTS[str(device)] = step_generator(0, device)
    return gen


def flash_seed(generator: torch.Generator) -> torch.Tensor:
    """An int32 ``[1]`` seed on the generator's device, ``& 0x7FFFFFFF``."""
    raw = torch.randint(0, 2 ** 32, (1,), generator=generator,
                        device=generator.device, dtype=torch.int64)
    return (raw & 0x7FFFFFFF).to(torch.int32)


__all__ = ["step_generator", "rng_guard", "current_generator", "flash_seed"]
