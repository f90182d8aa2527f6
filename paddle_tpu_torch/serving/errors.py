"""Typed client-visible serving errors.

Counterpart: ``paddle_tpu/serving/errors.py`` (and `EngineClosedError`,
``paddle_tpu/serving/engine.py:93``). Every request submitted to an
`Engine` ends in bounded time with its tokens, one of the typed errors
below, or an engine-death ``RuntimeError`` carrying the cause. A
`RequestHandle` closed with a `ServingError` re-raises it as it is, so a
client can ``except DeadlineExceededError`` and read ``handle.partial``;
any other cause surfaces as ``RuntimeError("... failed while request
...")`` raised from it.

- `DeadlineExceededError`: the request's ``deadline_s`` passed, queued
  (no page was reserved) or mid-decode (slot and pages released, the
  tokens so far on ``handle.partial``).
- `OverloadedError`: bounded admission refused it at submit
  (``shed_policy="refuse"``) or shed it (``"shed_newest"``,
  ``"shed_closest_deadline"``): the serving 429.
- `InfeasibleDeadlineError`: ``shed_policy="infeasible"`` refused it at
  submit, its deadline priced as unreachable from the engine's own
  phase-time histograms; an `OverloadedError`.
- `PoolExhaustedError`: the paged admission's retry budget
  (``admission_retries``) ran out against an exhausted pool.
- `HungStepError`: a watchdog found the replica wedged in a step; only
  the cluster (ROADMAP A10) raises it.
- `EngineClosedError`: the cause a request fails with when its engine
  is closed (`Engine.close`); not a `ServingError`, so the handle wraps
  it as an engine death.
"""
from __future__ import annotations


class ServingError(RuntimeError):
    """Base of the typed, client-visible serving failures."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed before it finished; the tokens
    emitted so far stay on ``handle.partial``."""


class OverloadedError(ServingError):
    """Bounded admission refused or shed this request."""


class InfeasibleDeadlineError(OverloadedError):
    """Feasibility admission refused the request at submit: the
    estimated queue delay plus the measured prefill and decode phase
    times exceed its remaining deadline."""


class PoolExhaustedError(ServingError):
    """The admission retries against an exhausted KV page pool ran out;
    the message names the pages needed and the pool's size."""


class HungStepError(ServingError):
    """A watchdog found this request's replica wedged inside a step and
    failed its in-flight work."""


class EngineClosedError(RuntimeError):
    """The cause attached to requests queued or in flight when their
    engine is closed: a blocked client re-raises with it instead of
    hanging."""


__all__ = ["ServingError", "DeadlineExceededError", "OverloadedError",
           "InfeasibleDeadlineError", "PoolExhaustedError", "HungStepError",
           "EngineClosedError"]
