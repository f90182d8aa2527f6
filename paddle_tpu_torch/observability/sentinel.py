"""Recompile sentinel: count the builds of each named step.

Counterpart: ``paddle_tpu/observability/sentinel.py``, with its API and
names. There a *trace* is one XLA trace of a jitted function; here it is
one CUDA graph capture of a named step (`jit.capture.CapturedStep`), or
on the CPU one build of a bucket's step. The paged `Engine` reports its
prefill and verify steps under per-engine names, `generate` its decode
steps under per-model names, so two owners in one process never alias.

- ``note_trace(name, signature)`` records one build: it bumps the
  registry counter ``xla_traces_total{executable=name}`` and keeps the
  shape signature that caused it.
- On a second build of one name with a NEW signature (or with none
  given) the sentinel warns once per name and, when **armed**, raises
  `RecompileError`. A build whose signature repeats one already recorded
  is counted but is no recompile (the reference's rule, :88-94).
- ``traced(name, fn)`` wraps a function so that each call is noted with
  the signature of its arguments.

Signatures come from tensor shapes and dtypes; nested lists, tuples and
dicts are flattened here (the reference uses ``jax.tree_util``).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import warnings

from .registry import get_registry


class RecompileError(RuntimeError):
    """An armed sentinel observed a named step built twice."""


def _leaf_sig(x) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        dt = str(dtype).removeprefix("torch.")
        return f"{dt}[{','.join(str(int(s)) for s in shape)}]"
    return type(x).__name__


def _structure(x, leaves: list) -> str:
    """The nesting of ``x`` as a string; its leaves' signatures go to
    ``leaves`` in order."""
    if isinstance(x, (list, tuple)):
        inner = ", ".join(_structure(v, leaves) for v in x)
        return f"{type(x).__name__}({inner})"
    if isinstance(x, dict):
        inner = ", ".join(f"{k!r}: {_structure(x[k], leaves)}"
                          for k in sorted(x, key=repr))
        return "{" + inner + "}"
    leaves.append(_leaf_sig(x))
    return "*"


def _signature(args, kwargs) -> str:
    """Compact shape signature of a call: its structure, then the shapes
    and dtypes of its tensors (the type name of any other leaf)."""
    leaves: list = []
    tree = _structure((tuple(args), dict(kwargs)), leaves)
    return f"{tree}: ({', '.join(leaves)})"


class RecompileSentinel:
    """Per-named-step build counter with an armable tripwire."""

    def __init__(self, registry=None):
        self._registry = registry or get_registry()
        self._lock = threading.Lock()
        self._signatures: dict[str, list] = {}
        self._armed = 0
        self._warned: set = set()

    @property
    def _counter(self):
        return self._registry.counter(
            "xla_traces_total",
            "builds per named step (1 = capture-once held)",
            labelnames=("executable",))

    # -- recording -------------------------------------------------------
    def note_trace(self, name: str, signature: str | None = None):
        """Record one build of ``name``."""
        with self._lock:
            sigs = self._signatures.setdefault(name, [])
            dup = signature is not None and signature in sigs
            sigs.append(signature)
            n = len(sigs)
            first_warn = n > 1 and not dup and name not in self._warned
            if first_warn:
                self._warned.add(name)
            armed = self._armed > 0
        self._counter.inc(executable=name)
        if n > 1 and not dup:
            prev = next((s for s in sigs[:-1] if s is not None), None)
            detail = ""
            if signature is not None:
                detail = (f"\n  previous signature: {prev}"
                          f"\n  retrace signature:  {signature}")
            msg = (f"[paddle_tpu_torch.observability] step {name!r} built "
                   f"{n} times: a recapture on what should be a "
                   f"capture-once path.{detail}")
            if armed:
                raise RecompileError(msg)
            if first_warn:
                warnings.warn(msg, stacklevel=3)

    def traced(self, name: str, fn):
        """Wrap ``fn`` so that every call is noted under ``name`` with
        the shape signature of its arguments."""
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            self.note_trace(name, _signature(args, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    # -- views -----------------------------------------------------------
    def trace_count(self, name: str) -> int:
        with self._lock:
            return len(self._signatures.get(name, ()))

    def signatures(self, name: str) -> list:
        with self._lock:
            return list(self._signatures.get(name, ()))

    def counts(self) -> dict:
        with self._lock:
            return {k: len(v) for k, v in self._signatures.items()}

    # -- arming ----------------------------------------------------------
    @property
    def is_armed(self) -> bool:
        return self._armed > 0

    def arm(self):
        with self._lock:
            self._armed += 1

    def disarm(self):
        with self._lock:
            self._armed = max(0, self._armed - 1)

    @contextlib.contextmanager
    def armed(self):
        """``with sentinel.armed():`` any rebuild inside raises."""
        self.arm()
        try:
            yield self
        finally:
            self.disarm()

    def reset(self):
        with self._lock:
            self._signatures.clear()
            self._warned.clear()


#: the process-wide default sentinel (the engine and generate report here)
_default_sentinel = RecompileSentinel()


def get_sentinel() -> RecompileSentinel:
    return _default_sentinel


def traced(name, fn):
    return _default_sentinel.traced(name, fn)


__all__ = ["RecompileError", "RecompileSentinel", "get_sentinel", "traced"]
