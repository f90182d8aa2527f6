"""Typed client-visible serving errors.

Counterpart: ``paddle_tpu/serving/errors.py``. A `RequestHandle` closed
with a `ServingError` re-raises it as it is; any other cause of an
engine failure surfaces as ``RuntimeError("... failed while request
...")`` raised from that cause. The reference's subclasses (deadline,
overload, infeasible deadline, pool exhaustion after a retry budget,
hung step) arrive with the engine features that raise them, in later
slices of the port.
"""
from __future__ import annotations


class ServingError(RuntimeError):
    """Base of the typed, client-visible serving failures."""


__all__ = ["ServingError"]
