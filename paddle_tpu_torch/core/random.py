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
  `default_generator` is the reference's ``Generator`` over those
  per-device generators (``paddle_tpu/core/random.py:23-117``):
  `seed(s)` reseeds every one, made or still to be made, with ``s``;
  `get_rng_state` is their states by device (a copy), which
  `set_rng_state` puts back, so the same draws come again. The
  reference's top-level ``get_cuda_rng_state`` / ``set_cuda_rng_state``
  are aliases of these (``paddle_tpu/__init__.py:88-92``).
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
_MASK63 = 0x7FFF_FFFF_FFFF_FFFF


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
        int(key) & _MASK63)


class Generator:
    """A seed and one `torch.Generator` a device, each made when first
    drawn from, seeded with the seed."""

    def __init__(self, seed: int = 0, *, _gens=None, _lock=None):
        self._seed = int(seed)
        self._gens = {} if _gens is None else _gens
        self._lock = threading.Lock() if _lock is None else _lock

    def manual_seed(self, seed: int):
        """Reseed every device's generator with ``seed``; returns self."""
        with self._lock:
            self._seed = int(seed)
            for gen in self._gens.values():
                gen.manual_seed(self._seed & _MASK63)
        return self

    @property
    def initial_seed(self) -> int:
        return self._seed

    def device_generator(self, device) -> torch.Generator:
        """This generator's `torch.Generator` on ``device``."""
        key = str(torch.device(device))
        with self._lock:
            gen = self._gens.get(key)
            if gen is None:
                gen = self._gens[key] = step_generator(self._seed, device)
        return gen

    def get_state(self) -> dict:
        """``{device: state}`` of every generator made so far (copies)."""
        with self._lock:
            return {k: g.get_state() for k, g in self._gens.items()}

    def set_state(self, state: dict):
        """Put back states from `get_state` (a device not made yet is
        made first)."""
        for key, st in state.items():
            self.device_generator(key).set_state(st)


_DEFAULT = Generator(0, _gens=_DEFAULTS, _lock=_DEFAULTS_LOCK)


def default_generator() -> Generator:
    """The generator draws come from outside any `rng_guard`."""
    return _DEFAULT


def seed(s: int) -> Generator:
    """Reseed the default generators (every device) with ``s``."""
    return _DEFAULT.manual_seed(s)


def get_rng_state() -> dict:
    """The default generators' states by device."""
    return _DEFAULT.get_state()


def set_rng_state(state: dict):
    _DEFAULT.set_state(state)


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
    return _DEFAULT.device_generator(device)


def flash_seed(generator: torch.Generator) -> torch.Tensor:
    """An int32 ``[1]`` seed on the generator's device, ``& 0x7FFFFFFF``."""
    raw = torch.randint(0, 2 ** 32, (1,), generator=generator,
                        device=generator.device, dtype=torch.int64)
    return (raw & 0x7FFFFFFF).to(torch.int32)


__all__ = ["fold_in", "step_generator", "rng_guard", "current_generator",
           "flash_seed", "Generator", "default_generator", "seed",
           "get_rng_state", "set_rng_state"]
