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
- `fold_in(seed, step)` gives the training loop's key of a step.
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
_MASK64 = (1 << 64) - 1


def _guards() -> list:
    if not hasattr(_local, "guards"):
        _local.guards = []
    return _local.guards


def fold_in(seed, data) -> int:
    """A 63-bit step key from ``(seed, data)``: the counterpart of
    ``jax.random.fold_in(PRNGKey(seed), data)`` that the reference's
    training loop keys each step with. Two rounds of splitmix64, so
    neighbouring seeds and steps give unrelated keys; the same pair gives
    the same key in every process (a resumed run draws what the
    uninterrupted run drew)."""
    x = int(seed) & _MASK64
    for v in (0x243F6A8885A308D3, int(data) & _MASK64):
        x = (x + v + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x & 0x7FFF_FFFF_FFFF_FFFF


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


__all__ = ["fold_in", "step_generator", "rng_guard", "current_generator",
           "flash_seed"]
