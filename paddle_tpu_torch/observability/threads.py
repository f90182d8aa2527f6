"""Crash-reporting wrapper for background-thread targets.

Counterpart: ``paddle_tpu/observability/threads.py``, copied. A daemon
thread that dies on an unhandled exception vanishes with at most a
stderr traceback nobody is watching. `guarded_target` wraps a thread
target so an escaped exception is COUNTED on the registry
(``background_thread_crashes_total{thread=...}``) and warned about,
never dropped. The checkpoint manager's commit thread runs through it.

The wrapper is a last-resort net, not a substitute for the loop's own
error handling: it only guarantees the death is visible.
"""
from __future__ import annotations

import warnings

from .registry import get_registry


def guarded_target(name: str, fn, on_crash=None):
    """Wrap ``fn`` for use as a ``threading.Thread`` target: an
    exception escaping it increments
    ``background_thread_crashes_total{thread=name}`` and emits a
    RuntimeWarning instead of dying silently. ``on_crash(exc)``, when
    given, runs after the bookkeeping (e.g. fail pending handles) —
    its own failure is counted too rather than masking the original.
    """
    def _guarded(*args, **kwargs):
        try:
            fn(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - the whole point: count it
            get_registry().counter(
                "background_thread_crashes_total",
                "background threads that died on an unhandled exception",
                labelnames=("thread",)).inc(thread=name)
            warnings.warn(
                f"background thread {name!r} crashed: {exc!r}",
                RuntimeWarning, stacklevel=2)
            if on_crash is not None:
                try:
                    on_crash(exc)
                except Exception as cexc:  # noqa: BLE001
                    get_registry().counter(
                        "background_thread_crashes_total",
                        "background threads that died on an unhandled "
                        "exception", labelnames=("thread",)).inc(
                            thread=f"{name}.on_crash")
                    warnings.warn(
                        f"on_crash handler of {name!r} failed: {cexc!r}",
                        RuntimeWarning, stacklevel=2)

    _guarded.__name__ = f"guarded[{name}]"
    _guarded.__wrapped__ = fn
    return _guarded


__all__ = ["guarded_target"]
