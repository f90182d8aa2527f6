"""Engine counters and the `EngineStats` snapshot.

Counterpart: ``paddle_tpu/serving/metrics.py``, reduced to what the
port's engine counts (the speculative counters of :95-119, the pool
bytes of :62-70 and the trace counts of :309-338 included). Times are
host wall-clock seconds around work that ends in a device sync (the
token reaches the host), so they measure the whole step, host and
device. A step's first call on a card captures its CUDA graph; the
seconds that took are ``capture_s``, beside the TTFT and step times
that include them.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

from ..observability.sentinel import get_sentinel

#: default engine ids, ``engine0``, ``engine1``, ... in creation order
_engine_ids = itertools.count()


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
    #: prefill steps built: one per prompt bucket used (on a card, one
    #: CUDA graph capture each)
    prefill_traces: int
    #: decode (verify) steps built: 1 for the engine's one window
    decode_traces: int
    #: host seconds spent capturing this engine's graphs (warm-up and
    #: capture; 0.0 on the CPU)
    capture_s: float


@dataclass
class EngineMetrics:
    #: the engine's name in the sentinel's step names
    engine_id: str = field(
        default_factory=lambda: f"engine{next(_engine_ids)}")
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
    prefill_traces: int = 0
    decode_traces: int = 0

    def note_trace(self, kind: str, tag: str | None = None,
                   count: bool = True):
        """One build of a step (``paddle_tpu/serving/metrics.py:
        314-338``): on a card one CUDA graph capture, on the CPU the
        first run of a bucket's step. Counted in ``decode_traces`` for
        ``kind == "decode"``, else in ``prefill_traces`` (not with
        ``count=False``), and reported to the recompile sentinel as
        ``serving.{kind}[{engine_id}]``, with ``[{tag}]`` after it where
        a tag names one of a deliberate family (the prefill's bucket,
        ``b{bucket}``): armed, a second build of one name raises
        `observability.RecompileError`. The signature is the
        reference's: there ``count=False`` registers the rungs of its
        adaptive verify ladder, built up front as one decode family,
        without counting them, so that ``decode_traces == 1`` keeps
        meaning one live decode path; the port's engine has one verify
        width and always counts."""
        if count:
            if kind == "decode":
                self.decode_traces += 1
            else:
                self.prefill_traces += 1
        get_sentinel().note_trace(self.step_name(kind, tag))

    def step_name(self, kind: str, tag: str | None = None) -> str:
        """The sentinel's name of one of this engine's steps."""
        name = f"serving.{kind}[{self.engine_id}]"
        return name + f"[{tag}]" if tag else name

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
            prefill_traces=self.prefill_traces,
            decode_traces=self.decode_traces,
            ttft_p50=p50(self.ttft_s),
            decode_step_p50=p50(self.decode_step_s), **gauges)


__all__ = ["EngineStats", "EngineMetrics"]
