"""Engine counters and the `EngineStats` snapshot.

Counterpart: ``paddle_tpu/serving/metrics.py``, reduced to what this
slice's engine counts. Times are host wall-clock seconds around work that
ends in a device sync (the token reaches the host), so they measure the
whole step, host and device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class EngineStats:
    submitted: int
    prefill_steps: int
    decode_steps: int
    completed: int
    cancelled: int
    queue_depth: int
    active_slots: int
    tokens_generated: int
    kv_page_size: int
    kv_pages_total: int
    kv_pages_in_use: int
    kv_pages_free: int
    kv_pages_exhausted: int
    kv_slot_pages: tuple
    ttft_p50: float | None
    decode_step_p50: float | None
    #: the process-wide `kernels.kernel_launch_counts` entry (launches
    #: since its last reset, by every engine), not a per-engine count
    paged_attention_launches: int


@dataclass
class EngineMetrics:
    submitted: int = 0
    prefill_steps: int = 0
    decode_steps: int = 0
    completed: int = 0
    cancelled: int = 0
    tokens_generated: int = 0
    #: admissions deferred because the page pool was exhausted
    kv_pages_exhausted: int = 0
    ttft_s: list = field(default_factory=list)
    decode_step_s: list = field(default_factory=list)

    def snapshot(self, **gauges) -> EngineStats:
        def p50(xs):
            return float(np.median(xs)) if xs else None

        return EngineStats(
            submitted=self.submitted, prefill_steps=self.prefill_steps,
            decode_steps=self.decode_steps, completed=self.completed,
            cancelled=self.cancelled,
            tokens_generated=self.tokens_generated,
            kv_pages_exhausted=self.kv_pages_exhausted,
            ttft_p50=p50(self.ttft_s),
            decode_step_p50=p50(self.decode_step_s), **gauges)


__all__ = ["EngineStats", "EngineMetrics"]
