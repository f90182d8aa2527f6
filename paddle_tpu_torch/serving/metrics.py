"""Engine counters and the `EngineStats` snapshot.

Counterpart: ``paddle_tpu/serving/metrics.py``, reduced to what the
port's engine counts (the speculative counters of :95-119 and the pool
bytes of :62-70 included). Times are host wall-clock seconds around work that
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
    #: the process-wide `kernels.kernel_launch_counts` entries of the
    #: paged kernel, float and quantized pools together (launches since
    #: their last reset, by every engine), not a per-engine count
    paged_attention_launches: int
    #: None, "int8" or "fp8": the pool's page storage
    kv_quant: str | None
    #: the pool's device bytes at the stored dtype, sentinel included
    kv_pool_bytes: int
    #: device bytes per cached token (all layers, K and V, scales)
    kv_bytes_per_token: float
    #: the verify window's draft length (0 = speculation off)
    spec_k: int
    #: drafted tokens proposed to the verify window, greedy and sampled
    spec_draft_tokens: int
    #: drafted tokens the target accepted
    spec_accepted_tokens: int
    #: accepted / drafted (None before any draft)
    spec_accept_rate: float | None
    spec_drafted_greedy: int
    spec_drafted_sampled: int
    spec_accepted_greedy: int
    spec_accepted_sampled: int


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
    #: (drafted, accepted) per verify lane kind: "greedy" lanes accept by
    #: argmax agreement, "sampled" ones by modified rejection
    spec: dict = field(default_factory=lambda: {"greedy": [0, 0],
                                                "sampled": [0, 0]})

    def note_spec(self, mode: str, drafted: int, accepted: int):
        """One drafting slot's verify window."""
        self.spec[mode][0] += int(drafted)
        self.spec[mode][1] += int(accepted)

    def snapshot(self, **gauges) -> EngineStats:
        def p50(xs):
            return float(np.median(xs)) if xs else None

        (dg, ag), (ds, as_) = self.spec["greedy"], self.spec["sampled"]
        drafted, accepted = dg + ds, ag + as_
        return EngineStats(
            spec_draft_tokens=drafted, spec_accepted_tokens=accepted,
            spec_accept_rate=accepted / drafted if drafted else None,
            spec_drafted_greedy=dg, spec_drafted_sampled=ds,
            spec_accepted_greedy=ag, spec_accepted_sampled=as_,
            submitted=self.submitted, prefill_steps=self.prefill_steps,
            decode_steps=self.decode_steps, completed=self.completed,
            cancelled=self.cancelled,
            tokens_generated=self.tokens_generated,
            kv_pages_exhausted=self.kv_pages_exhausted,
            ttft_p50=p50(self.ttft_s),
            decode_step_p50=p50(self.decode_step_s), **gauges)


__all__ = ["EngineStats", "EngineMetrics"]
