"""Engine counters, histograms and the `EngineStats` snapshot.

Counterpart: ``paddle_tpu/serving/metrics.py``, reduced to what the
port's engine counts: the speculative counters of :95-119, the pool
bytes of :62-70, the prefix-cache and chunked-prefill counters of
:71-77 and :145-155, the deadline and shed counters of :81-88, the
``spec_k`` gauge and its history of :107-117, and the trace counts of
:309-338. The latency and size distributions go to the registry's
fixed-bucket histograms under the reference's names (:245-310):
``serving_prefill_seconds``, ``serving_decode_step_seconds``,
``serving_queue_wait_seconds``, ``serving_ttft_seconds``,
``serving_spec_accept_tokens``, ``serving_prefill_chunk_tokens`` and
``serving_prefill_chunk_piggyback_ratio``, each labeled by engine, and
so do the prefix-cache, chunk, shed and deadline counters and the
``serving_spec_k`` and ``serving_queue_depth`` gauges (:414-500).
`EngineStats` keeps its exact p50s from the host's own lists of TTFTs
and decode-step times beside the histograms' TTFT p50 and p99
(`observability.bucket_quantile`, to within a bucket). Times are host
wall-clock seconds around work that ends in a device sync (the token
reaches the host), so they measure the whole step, host and device. A
step's first call on a card captures its CUDA graph; the seconds that
took are ``capture_s``, beside the TTFT and step times that include
them.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

from ..observability.registry import get_registry
from ..observability.sentinel import get_sentinel

#: default engine ids, ``engine0``, ``engine1``, ... in creation order
_engine_ids = itertools.count()


@dataclass(frozen=True)
class EngineStats:
    #: "slots" (dense slot caches) or "paged" (the page pool)
    kv_mode: str
    submitted: int
    prefill_steps: int
    decode_steps: int
    completed: int
    cancelled: int
    queue_depth: int
    active_slots: int
    free_slots: int
    tokens_generated: int
    #: the KV cache's device bytes: the slot caches, or the page pool
    #: at its stored dtype with the sentinel page
    kv_cache_bytes: int
    kv_pages_exhausted: int
    ttft_p50: float | None
    decode_step_p50: float | None
    #: the process-wide `kernels.kernel_launch_counts` entries of the
    #: paged kernel, float and quantized pools together (launches since
    #: their last reset, by every engine), not a per-engine count
    paged_attention_launches: int
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
    #: prefill steps built: one per prompt bucket used (and per tail
    #: bucket of the prefix cache, per chunk width of embed); on a card
    #: one CUDA graph capture each
    prefill_traces: int
    #: decode (verify) steps built: 1 for the engine's one window (the
    #: mixed chunk step registers in this family without counting)
    decode_traces: int
    #: host seconds spent capturing this engine's graphs (warm-up and
    #: capture; 0.0 on the CPU)
    capture_s: float
    # -- the page pool (None in slot mode) -------------------------------
    kv_page_size: int | None = None
    kv_pages_total: int | None = None
    kv_pages_in_use: int | None = None
    kv_pages_free: int | None = None
    kv_slot_pages: tuple | None = None
    #: None, "int8" or "fp8": the pool's page storage
    kv_quant: str | None = None
    #: the pool's device bytes at the stored dtype, sentinel included
    kv_pool_bytes: int | None = None
    #: device bytes per cached token (all layers, K and V, scales)
    kv_bytes_per_token: float | None = None
    # -- the prefix cache (Engine(prefix_cache=True); zeros otherwise) ---
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_hit_rate: float | None = None
    #: prompt tokens whose prefill was skipped through cached pages
    prefix_tokens_saved: int = 0
    #: pages the radix tree holds
    prefix_cached_pages: int = 0
    #: cached pages dropped by eviction under pool pressure
    prefix_evicted_pages: int = 0
    # -- chunked prefill (Engine(chunk_tokens=); zeros otherwise) --------
    #: mixed steps run: each absorbs one chunk of a prompt while every
    #: live slot decodes one token
    prefill_chunk_steps: int = 0
    #: 1 while a prompt is mid-chunk, else 0
    prefill_chunk_active: int = 0
    #: the engine's chunk budget (0: chunking off)
    chunk_tokens: int = 0
    #: prompts served through `Engine.embed`
    embed_prompts: int = 0
    # -- deadlines, bounded admission, adaptive k, histograms -------------
    #: the engine's id (the ``engine=`` label of its registry families)
    engine_id: str = ""
    #: requests failed with `DeadlineExceededError` (queued, decoding or
    #: mid-chunk)
    deadline_exceeded: int = 0
    #: requests refused or shed by bounded admission
    shed: int = 0
    #: queue depth x the moving average of an admission's cost: the
    #: delay a request arriving now would wait for its slot
    est_queue_delay_s: float = 0.0
    #: every (decode step, new k) move of the adaptive controller
    spec_k_history: tuple = ()
    #: the TTFT histogram's p50 and p99 (`bucket_quantile`; None before
    #: the first token)
    ttft_hist_p50: float | None = None
    ttft_p99: float | None = None
    # -- costs (``metrics.py:121-128``; None before the first decode) ----
    #: one decode step's operations as the engine stands: the model's
    #: products plus the attention's columns (`Engine._decode_step_flops`)
    decode_exec_flops: float | None = None
    #: ``decode_exec_flops`` times the decode steps over the tokens they
    #: emitted (the prefill's first token rides free); speculation
    #: lowers it
    decode_flops_per_token: float | None = None
    # -- the SLO plane (``Engine(slo=SLO(...))``; zeros or None
    # otherwise, ``metrics.py:129-146``) ----------------------------------
    #: terminated requests meeting every objective
    slo_attained: int = 0
    #: terminated requests that missed one, or failed typed
    slo_violated: int = 0
    #: attained / (attained + violated) since construction (None before
    #: the first)
    slo_attainment: float | None = None
    #: the largest error-budget burn rate over the tracker's windows
    slo_burn_rate: float | None = None
    #: attained requests a second over the tracker's window
    goodput_per_s: float = 0.0


#: the histograms of an engine: attribute -> (name, help, bucket edges
#: or None for the latency default), ``paddle_tpu/serving/metrics.py:
#: 245-288``
_HISTOGRAMS = {
    "h_prefill": ("serving_prefill_seconds", "prefill latency", None),
    "h_decode": ("serving_decode_step_seconds",
                 "iteration-level decode step latency", None),
    "h_queue_wait": ("serving_queue_wait_seconds",
                     "submit -> slot admission wait", None),
    "h_ttft": ("serving_ttft_seconds", "submit -> first token", None),
    "h_spec_accept": ("serving_spec_accept_tokens",
                      "drafted tokens accepted per verify window",
                      (0, 1, 2, 3, 4, 6, 8, 12, 16)),
    "h_chunk_tokens": ("serving_prefill_chunk_tokens",
                       "real prompt tokens absorbed per mixed chunk step",
                       (16, 32, 64, 128, 256, 512, 1024, 2048)),
    "h_chunk_piggyback": ("serving_prefill_chunk_piggyback_ratio",
                          "fraction of decode slots advancing inside each "
                          "mixed chunk step",
                          (0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                           0.875, 1.0)),
}


#: plain counter attributes of `EngineMetrics` published as the
#: reference's registry families (``paddle_tpu/serving/metrics.py:
#: 161-196``), labeled by engine: attribute -> (name, help). The
#: prefix-cache, chunk, deadline and shed families are published where
#: they are counted (`note_prefix`, `note_chunk_step`, ...).
_COUNTERS = {
    "submitted": ("serving_requests_submitted_total",
                  "requests accepted by Engine.submit()"),
    "completed": ("serving_requests_completed_total",
                  "requests that finished (EOS or token budget)"),
    "cancelled": ("serving_requests_cancelled_total",
                  "requests cancelled by the client"),
    "prefill_steps": ("serving_prefill_steps_total",
                      "prefill executions (one admitted request each)"),
    "decode_steps": ("serving_decode_steps_total",
                     "iteration-level decode steps (all slots ride each "
                     "one)"),
    "tokens_generated": ("serving_tokens_emitted_total",
                         "generated tokens delivered to request handles"),
    "kv_pages_exhausted": ("serving_kv_pages_exhausted_total",
                           "admissions deferred because the paged KV pool "
                           "had no free pages"),
    "prefix_lookups": ("serving_prefix_lookups_total",
                       "prefix-cache matches attempted at admission"),
    "prefix_evicted_pages": ("serving_prefix_evicted_pages_total",
                             "cached prefix pages dropped by LRU eviction "
                             "under pool pressure"),
    "embed_prompts": ("serving_embed_prompts_total",
                      "encoder-only prompts embedded through "
                      "Engine.embed()"),
}


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
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_tokens_saved: int = 0
    prefix_evicted_pages: int = 0
    prefill_chunk_steps: int = 0
    prefill_chunk_active: int = 0
    embed_prompts: int = 0
    #: deadline expiries, and requests refused or shed at admission
    deadline_exceeded: int = 0
    shed: int = 0

    def __post_init__(self):
        # the `_COUNTERS` families are published from the fields when
        # the registry is read (`publish`), never on the counting path
        get_registry().add_collector(self.publish)

    def publish(self):
        """Set this engine's children of the `_COUNTERS` families to the
        fields' values (``Counter.reset``: a count only moves up, a
        rewind reads as a process reset). The registry calls it before
        every `snapshot` / `to_prometheus`."""
        for attr, fam in _COUNTERS.items():
            self._family("counter", *fam).reset(getattr(self, attr),
                                                engine=self.engine_id)

    def _family(self, kind, name, help):
        return getattr(get_registry(), kind)(name, help,
                                             labelnames=("engine",))

    def note_prefix(self, matched: int):
        """One prefix-cache admission that matched ``matched`` tokens
        (counted once an admission, not once an attempt)."""
        self.prefix_lookups += 1
        if matched:
            self.prefix_hits += 1
            self.prefix_tokens_saved += int(matched)
            self._family("counter", "serving_prefix_hits_total",
                         "admissions that mapped at least one cached "
                         "prefix page").inc(engine=self.engine_id)
            self._family("counter", "serving_prefix_tokens_saved_total",
                         "prompt tokens whose prefill was skipped via "
                         "cached prefix pages").inc(int(matched),
                                                    engine=self.engine_id)

    def note_chunk_step(self, real_tokens: int, piggyback: int,
                        slots: int):
        """One mixed chunked-prefill + decode step that absorbed
        ``real_tokens`` prompt tokens while ``piggyback`` of the
        ``slots`` decoded."""
        self.prefill_chunk_steps += 1
        self._family("counter", "serving_prefill_chunk_steps_total",
                     "mixed chunked-prefill + decode steps (each absorbs "
                     "one prompt chunk while live decode slots advance)"
                     ).inc(engine=self.engine_id)
        self.observe("h_chunk_tokens", real_tokens)
        self.observe("h_chunk_piggyback", piggyback / max(1, slots))

    def histogram(self, attr: str):
        """The registry histogram ``attr`` of `_HISTOGRAMS`."""
        name, help, buckets = _HISTOGRAMS[attr]
        return get_registry().histogram(name, help, labelnames=("engine",),
                                        buckets=buckets)

    def observe(self, attr: str, value):
        """One observation into this engine's child of ``attr``."""
        self.histogram(attr).observe(value, engine=self.engine_id)

    def quantile(self, attr: str, q: float):
        """``(bucket-estimated q-quantile or None, observations)`` of this
        engine's child of ``attr``."""
        h = self.histogram(attr)
        _, _, count = h.child(engine=self.engine_id)
        return h.quantile(q, engine=self.engine_id), count

    def note_deadline_exceeded(self):
        self.deadline_exceeded += 1
        self._family("counter", "serving_deadline_exceeded_total",
                     "requests failed with DeadlineExceededError (expired "
                     "in queue or mid-decode)").inc(engine=self.engine_id)

    def note_shed(self, policy: str):
        """One request refused or shed by bounded admission under
        ``policy`` (``refuse``, ``shed_newest``, ``shed_closest_deadline``
        or ``infeasible``)."""
        self.shed += 1
        get_registry().counter(
            "serving_shed_total",
            "requests refused or shed by bounded admission",
            labelnames=("engine", "policy")).inc(engine=self.engine_id,
                                                 policy=policy)

    def note_spec_k(self, k: int):
        """Publish the engine's current draft length."""
        self._family("gauge", "serving_spec_k",
                     "current speculative draft length k (adaptive engines "
                     "step it between decode steps; fixed engines pin it)"
                     ).set(int(k), engine=self.engine_id)

    def set_chunk_active(self, flag: bool):
        """Whether a prompt is mid-chunk now."""
        self.prefill_chunk_active = int(bool(flag))
        self._family("gauge", "serving_prefill_chunk_active",
                     "1 while a prompt is being absorbed chunk-by-chunk, "
                     "else 0").set(self.prefill_chunk_active,
                                   engine=self.engine_id)

    def note_trace(self, kind: str, tag: str | None = None,
                   count: bool = True):
        """One build of a step (``paddle_tpu/serving/metrics.py:
        314-338``): on a card one CUDA graph capture, on the CPU the
        first run of a bucket's step. Counted in ``decode_traces`` for
        ``kind == "decode"``, else in ``prefill_traces`` (not with
        ``count=False``), and reported to the recompile sentinel as
        ``serving.{kind}[{engine_id}]``, with ``[{tag}]`` after it where
        a tag names one of a deliberate family (the prefill's bucket,
        ``b{bucket}``; a prefix-cache tail bucket, ``b{bucket}pfx``; an
        embed chunk width, ``embed{width}``; the mixed chunk step,
        ``mix{chunk_tokens}``): armed, a second build of one name raises
        `observability.RecompileError`. ``count=False`` registers a
        second member of the decode family without counting it, so that
        ``decode_traces == 1`` keeps meaning one live decode path: the
        reference's adaptive verify rungs, and the mixed chunk step in
        both packages (``engine.py:1780-1787``)."""
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
        self.observe("h_spec_accept", accepted)

    def snapshot(self, **gauges) -> EngineStats:
        def p50(xs):
            return float(np.median(xs)) if xs else None

        self.publish()
        # the reference's account: one step's operations times the
        # decode steps over every emitted token (each admission's first
        # rides free)
        toks = self.tokens_generated
        per_token = None
        if gauges.get("decode_exec_flops") and toks > 0:
            per_token = (gauges["decode_exec_flops"] * self.decode_steps
                         / toks)
            self._family("gauge", "serving_decode_flops_per_token",
                         "decode steps' operations / tokens they emitted "
                         "— falls as speculation raises tokens per weight "
                         "read").set(per_token, engine=self.engine_id)

        self._family("gauge", "serving_queue_depth",
                     "requests waiting for a slot").set(
                         gauges["queue_depth"], engine=self.engine_id)

        (dg, ag), (ds, as_) = self.spec["greedy"], self.spec["sampled"]
        drafted, accepted = dg + ds, ag + as_
        looked = self.prefix_lookups
        return EngineStats(
            prefix_lookups=looked, prefix_hits=self.prefix_hits,
            prefix_hit_rate=self.prefix_hits / looked if looked else None,
            prefix_tokens_saved=self.prefix_tokens_saved,
            prefix_evicted_pages=self.prefix_evicted_pages,
            prefill_chunk_steps=self.prefill_chunk_steps,
            prefill_chunk_active=self.prefill_chunk_active,
            embed_prompts=self.embed_prompts,
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
            decode_step_p50=p50(self.decode_step_s),
            engine_id=self.engine_id,
            deadline_exceeded=self.deadline_exceeded, shed=self.shed,
            ttft_hist_p50=self.quantile("h_ttft", 0.5)[0],
            ttft_p99=self.quantile("h_ttft", 0.99)[0],
            decode_flops_per_token=per_token, **gauges)


__all__ = ["EngineStats", "EngineMetrics"]
