"""Deterministic fault injection for the training resilience plane.

Counterpart: ``paddle_tpu/framework/train_faults.py``, copied (it
imports nothing of JAX). A resilience contract is only worth what
exercises it, so the faults the plane defends against are injected at
EXACT step indices and every failure path runs in tests instead of by
luck. The faults a long preemptible run actually meets:

- ``crash_at_step`` — raise `InjectedCrash` at the top of a train
  step, before any state for that step is produced: what a preemption
  without notice / OOM-kill looks like to the loop. The loop does NOT
  catch it (a killed process catches nothing); a fresh
  `ResilientTrainLoop` over the same directory must resume to the
  uninterrupted run's loss trajectory.
- ``nan_loss_at_step`` — poison the host-observed loss with NaN: a
  stand-in for data-born divergence (a corrupt batch, an fp16
  overflow the scaler missed). Drives the anomaly detector's
  rollback-and-skip path.
- ``nan_param_at_step`` — overwrite ONE named layer's parameter with
  NaN before the step dispatches (``param="fc2.weight"``; default:
  the loop's last float parameter): the nan-loss fault with a known
  source layer, which exercises the per-layer anomaly attribution —
  the loss goes genuinely non-finite on the device, every layer's
  grads are poisoned by backprop, but only the source layer's
  param-norm telemetry is non-finite, so the postmortem must name it.
- ``torn_checkpoint_write`` — the commit thread dies mid-write: a
  partial ``.tmp`` with no commit marker is left behind and the
  checkpoint is never swapped in. Restore-from-latest-VALID must skip
  it (and `_recover_interrupted_swap` must never adopt it).
- ``corrupt_shard`` — flip bytes in one committed array file after
  the swap: silent storage corruption. The per-checkpoint integrity
  manifest (CRC per file) must reject it at restore and fall back to
  the previous checkpoint.
- ``slow_io`` — a bounded ``sleep_s`` stall inside the checkpoint
  commit: a slow/contended filesystem. With async snapshots the train
  step must not inherit the stall.

Usage::

    inj = TrainFaultInjector()
    inj.add("crash_at_step", at_step=7)
    inj.add("corrupt_shard", at_step=4)
    loop = ResilientTrainLoop(step, data, directory=d, fault_injector=inj)

Specs are one-shot by default (``times=1``) and matched on
``(kind, at_step)`` — ``at_step=None`` matches any step. Every firing
is recorded on ``injector.fired`` for test assertions. Loops without
an injector pay one ``is None`` check per hook.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field


class InjectedCrash(RuntimeError):
    """The exception ``crash_at_step`` raises — a stand-in for a
    process kill (preemption, OOM-kill, segfault). The loop never
    catches it; recovery is the NEXT loop's restore path."""


@dataclass
class TrainFaultSpec:
    kind: str
    at_step: int | None = None   # 0-based global train-step index
    times: int = 1               # firings left
    kw: dict = field(default_factory=dict)


class TrainFaultInjector:
    """Deterministic, thread-safe fault schedule shared by the loop
    and its `CheckpointManager` (``fault_injector=``)."""

    KINDS = ("crash_at_step", "nan_loss_at_step", "nan_param_at_step",
             "torn_checkpoint_write", "corrupt_shard", "slow_io")

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: list[TrainFaultSpec] = []
        #: (kind, step, detail) per firing, in order — what tests assert
        self.fired: list = []

    def add(self, kind, at_step=None, times=1, **kw) -> "TrainFaultInjector":
        """Schedule one fault; chainable. ``kw`` carries the
        kind-specific payload (``sleep_s`` for slow_io)."""
        if kind not in self.KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} — one of {self.KINDS}")
        with self._lock:
            self._specs.append(TrainFaultSpec(
                kind, int(at_step) if at_step is not None else None,
                int(times), kw))
        return self

    def _take(self, kind, step):
        """Pop (decrement) the first matching armed spec, or None."""
        with self._lock:
            for spec in self._specs:
                if spec.kind != kind or spec.times <= 0:
                    continue
                if spec.at_step is not None and spec.at_step != step:
                    continue
                spec.times -= 1
                return spec
        return None

    def _note(self, kind, step, **detail):
        with self._lock:
            self.fired.append((kind, step, detail))

    # -- hooks the loop / checkpoint manager call -------------------------
    def on_step_start(self, step: int):
        """Called at the top of every train step, before the dispatch.
        May raise `InjectedCrash` (crash_at_step) — the simulated
        kill."""
        spec = self._take("crash_at_step", step)
        if spec is not None:
            self._note("crash_at_step", step)
            raise InjectedCrash(f"injected crash at train step {step}")

    def poison_loss(self, step: int) -> bool:
        """True = replace this step's host-observed loss with NaN."""
        spec = self._take("nan_loss_at_step", step)
        if spec is None:
            return False
        self._note("nan_loss_at_step", step)
        return True

    def poison_param(self, step: int, default: str | None = None):
        """Name of the parameter this step must poison with NaN
        (``nan_param_at_step``), or None when no spec matches. A spec
        without an explicit ``param=`` resolves to ``default`` (the
        loop passes its last float parameter)."""
        spec = self._take("nan_param_at_step", step)
        if spec is None:
            return None
        name = spec.kw.get("param") or default
        self._note("nan_param_at_step", step, param=name)
        return name

    def torn_write(self, step: int) -> bool:
        """True = this checkpoint commit must die mid-write, leaving a
        partial ``.tmp`` with no commit marker and NOT swapping it in."""
        spec = self._take("torn_checkpoint_write", step)
        if spec is None:
            return False
        self._note("torn_checkpoint_write", step)
        return True

    def corrupt_shard(self, step: int) -> bool:
        """True = flip bytes in one array shard of this checkpoint
        AFTER it commits (silent storage corruption)."""
        spec = self._take("corrupt_shard", step)
        if spec is None:
            return False
        self._note("corrupt_shard", step)
        return True

    def io_delay_s(self, step: int) -> float:
        """Seconds this checkpoint commit must stall (slow_io); 0 when
        no spec matches."""
        spec = self._take("slow_io", step)
        if spec is None:
            return 0.0
        sleep_s = float(spec.kw.get("sleep_s", 0.5))
        self._note("slow_io", step, sleep_s=sleep_s)
        return sleep_s

    def pending(self) -> int:
        """Armed one-shot firings left."""
        with self._lock:
            return sum(s.times for s in self._specs if s.times > 0)


__all__ = ["TrainFaultInjector", "TrainFaultSpec", "InjectedCrash"]
