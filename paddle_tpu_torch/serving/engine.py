"""The continuous-batching serving engine over dense slot caches or the
paged KV pool.

Counterpart: ``paddle_tpu/serving/engine.py`` (the mode choice and its
validations of :222-540, submit/step semantics and background mode of
:757-1160, the deadline, shed and feasibility admission of :1249-1450,
stats of :1160-1208, the page budget, retries and prefix reservation of
:1429-1535, admission of :1536-1700, chunked prefill and `embed` of
:1731-2024, decode of :2252-2291, the speculative step and its adaptive
rungs of :2293-2646, emit/release of :2647-2717). The engine:

- `submit` queues a request and returns a `RequestHandle`;
- `step` fails expired requests first, then admits queued requests FCFS
  into free slots (each prompt prefilled alone), then runs ONE decode
  step in which every slot, active or parked, rides; EOS or the token
  budget frees the slot at once;
- cooperatively, each waiting handle steps the engine itself; after
  `start` (or ``with Engine(...) as eng:``) a daemon thread steps it,
  and handles wait on their own streams. One re-entrant lock
  serializes `step` with `submit`, `cancel`, `stats` and `embed`.

``kv_mode`` picks the KV cache, as the reference does: ``"slots"`` (the
default without a paged feature) holds one dense ``[slots, H, max_len,
D]`` cache a layer (`kv_slots.SlotKVCache`): a prompt, left-padded to
its bucket, is written into the slot's row, and decode attends the whole
row, composed with float32 scores (the reference's slot step runs no
Pallas kernel either). ``"paged"`` (the default with ``prefix_cache``,
``chunk_tokens``, ``kv_quant`` or ``kv_pool_bytes``) holds a page pool
(`paged.PagedKVCache`): each slot reserves its whole page budget at
admission, a request that finds the pool exhausted stays queued at the
head until a release returns pages (or its ``admission_retries`` run
out: `PoolExhaustedError`), and decode attends through the block table
(the Hopper paged-attention kernel on a card). Paged features:

- ``kv_quant="int8"`` or ``"fp8"`` stores the pool as 1-byte pages with
  per-token f32 scales: prefill attends its float local cache and
  quantizes into the pages, every decode or verify write quantizes, and
  the attention kernel dequantizes;
- ``prefix_cache=True`` keeps a radix tree of complete prompt pages
  (`prefix_cache.PrefixCache`): an admission maps the pages its prompt
  shares with an earlier one read-only, reserves only the rest, and
  prefills only the uncached tail through the page view; the layout is
  unpadded (column == position), and the tree's unread pages are
  evicted, oldest first, when an allocation falls short;
- ``chunk_tokens=n`` admits a prompt whose uncached tail is longer than
  ``n`` in chunks of ``n`` tokens, one a step, each fused with the
  decode step of every other slot in one mixed step; nothing behind a
  chunking request admits until it has its slot (FCFS);
- `embed` runs prompts through the same tail prefill and returns the
  final ``ln_f`` hidden state of each, releasing the slot and pages
  before it returns.

Both modes:

- ``weight_quant="int8"`` serves weight-only int8 weights, dequantized
  inside each prefill and decode step (the model's `dequantized` scope);
- ``spec_k=k`` replaces the decode step by a verify step of ``k + 1``
  lanes per slot: a drafter proposes up to ``k`` tokens per slot on the
  host (the n-gram drafter `speculative.NgramDrafter`, or
  ``draft_model=``: an object with ``draft(context, k)`` or a callable,
  `speculative.CallableDrafter`), one pass scores them all, and the
  longest accepted prefix plus one token of the target's own is
  emitted. Greedy requests accept by argmax agreement (token-identical
  to ``spec_k=0``); sampled ones by modified rejection sampling
  (distributed exactly as ``spec_k=0``). ``spec_adaptive=True`` (or an
  `speculative.AdaptiveSpecK`) moves ``k`` between steps, off the live
  accept history, across the rungs of `speculative.spec_k_ladder` up to
  ``spec_k_max``: every rung's verify step is built at the first
  speculative decode, and every slot budgets ``spec_k_max`` more
  columns (``bucket + max_new + spec_k_max <= max_len``, and its pages)
  whatever the current ``k``, so a grow never outruns a reservation;
- ``default_deadline_s`` / ``submit(deadline_s=)`` bound a request's
  lifetime: past it the request fails with `DeadlineExceededError` at
  the next step, queued (no page reserved), decoding (slot and pages
  released, tokens kept on ``handle.partial``) or mid-chunk. The
  deadline clock is ``perf_counter`` plus a fault injector's skew, read
  on the host only;
- ``max_queue`` bounds the queue: ``shed_policy="refuse"`` raises
  `OverloadedError` from `submit`, ``"shed_newest"`` fails the newcomer
  and ``"shed_closest_deadline"`` the request nearest its deadline;
  ``"infeasible"`` also refuses at submit a request whose deadline the
  measured phase times price as unreachable (no-op until each phase
  histogram holds 8 observations);
- ``engine_id`` names the engine in its registry labels and step names;
  ``fault_injector`` (`faults.FaultInjector`) fires ``step_hang`` and
  ``step_error`` at dispatches, ``reserve_fail`` at reservations and
  ``clock_skew`` on the deadline clock;
- every request carries a `timeline.Timeline`, closed with its typed
  cause; ``engine.timelines`` (`timeline.TimelineRing`) keeps the
  terminated ones. `close` fails every queued and in-flight request with
  `errors.EngineClosedError` and returns every page.

Every step is a `jit.capture.CapturedStep` (`compiled`): one a prompt
bucket (dense or paged prefill), one a tail bucket (the prefix cache's
tail prefill), one a chunk width (`embed`), the decode/verify step (one
a rung when adaptive), and the mixed chunk step. On a card each is one
CUDA graph, captured on first use into the engine's one graph memory
pool and then only replayed; on the CPU the same body runs eagerly on
the same static buffers. Each build is counted (``stats().
prefill_traces`` and ``decode_traces``; the mixed step and the adaptive
rungs other than the starting one register in the decode family
without counting) and reported to the recompile sentinel under the
engine's own names (`metrics.EngineMetrics.note_trace`). Token
selection runs after the replay, eagerly.

``dtype`` stores the KV cache (the page pool or the slot caches) in a
float dtype other than the model's (``engine.py:226``, :614-620): the
steps write K/V cast to it, and the paged kernel reads each page in its
own dtype, widened to f32 (B3's float pages under any query dtype).

Observability (A9, the reference's telemetry rounds): the engine emits
the reference's trace spans (``serving.prefill``, ``serving.decode``)
and request-lifecycle async events (``request``, ``slot.admission``,
``slot.decode_token``, ``spec.verify``, ``slot.eviction``,
``deadline.exceeded``, ``shed``, ``prefix.hit``,
``kv_pages.exhausted_requeue``, ``kv_pages.exhausted_fail``) under the
same names and stages, at the same points; with the span buffer off and
no sink attached (`observability.tracing.active()` false) the spans and
events build nothing. ``profiler``: a callable ``(event, info)`` fired
after each prefill, chunk and decode step. ``slo``: an
`observability.SLO`; every terminated request is scored once
(`observability.SLOTracker`, the ``serving_slo_*`` family, ``stats()``'s
``slo_*`` and ``goodput_per_s``); only then are token times kept.
``flight_recorder``: True or an `observability.FlightRecorder`; a real
death dumps one postmortem, a clean `close` none.
``observability_port``: start an `observability.ObservabilityServer` on
127.0.0.1 at that port (0 picks a free one), this engine attached,
stopped by `close`. ``stats()``'s ``decode_exec_flops`` is one decode
step's operations in closed form as the engine stands
(`observability.costs.gpt_decode_flops`: the products, plus the
attention's 4 N H W L D a layer, L the columns the step reads), and
``decode_flops_per_token`` that times the decode steps over the tokens
they emitted, the reference's account; nothing is counted on the step's
path. The engine's counters reach the registry's ``serving_*_total``
families when the registry is read (`metrics.EngineMetrics.publish`).

Arguments of features that later slices bring raise
`NotImplementedError` naming the ROADMAP item: ``role`` and ``kv_pool``
(A10: the cluster, its handoff, requeue and watchdog hooks), ``mesh``
and ``sharding_rule`` (A12).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..jit.capture import graph_pool
from ..observability import costs as _costs
from ..observability import tracing as _tracing
from ..observability.slo import SLOTracker
from ..kernels import kernel_launch_counts
from ..kernels.paged_kv import pages_for
from ..models.generation import select_tokens, select_tokens_window
from .compiled import (build_cached_prefill_fn,
                       build_chunked_prefill_decode_fn,
                       build_embed_prefill_fn, build_paged_prefill_fn,
                       build_paged_verify_step_fn, build_prefill_fn,
                       build_verify_step_fn)
from .errors import (DeadlineExceededError, EngineClosedError,
                     InfeasibleDeadlineError, OverloadedError,
                     PoolExhaustedError)
from .kv_slots import SlotKVCache
from .metrics import EngineMetrics
from .paged import PagedKVCache, pages_in_budget
from .prefix_cache import PrefixCache
from .request import (CANCELLED, DECODING, FINISHED, QUEUED, Request,
                      RequestHandle, SamplingParams)
from .scheduler import SlotScheduler
from .speculative import (AdaptiveSpecK, CallableDrafter, NgramDrafter,
                          longest_accept, normalize_draft, spec_k_ladder)
from .timeline import (PHASE_ADMITTED, PHASE_DECODE, PHASE_PREFILL,
                       TimelineRing)

#: the launch-count names of the paged kernel (float, int8, fp8 pools;
#: float16 queries apart)
_PAGED_KERNELS = ("paged_attention", "paged_attention_int8",
                  "paged_attention_fp8", "paged_attention_f16",
                  "paged_attention_int8_f16", "paged_attention_fp8_f16")

#: Engine arguments of later slices: name -> (the value that means
#: "off", the ROADMAP queue-A feature that brings it)
_LATER = {
    "mesh": (None, "A12 distributed serving"),
    "sharding_rule": (None, "A12 distributed serving"),
    "role": ("both", "A10 disaggregated serving"),
    "kv_pool": (None, "A10 disaggregated serving"),
}
#: the decode step's span when nothing consumes spans (reusable)
_NO_SPAN = contextlib.nullcontext()
#: the shed policies of bounded admission
_SHED_POLICIES = ("refuse", "shed_newest", "shed_closest_deadline",
                  "infeasible")
#: feasibility admission prices service at this quantile of the phase
#: histograms, once each holds this many observations
#: (``paddle_tpu/serving/control.py:69-78``)
FEASIBILITY_QUANTILE = 0.5
FEASIBILITY_MIN_SAMPLES = 8


def _later(feature: str):
    return NotImplementedError(
        f"{feature} comes with a later slice of the port (ROADMAP queue A)")


def _resolve_kv_mode(kv_mode, kv_quant, kv_pool_bytes, kv_pages,
                     prefix_cache, chunk_tokens, spec_k):
    """The engine's KV mode and the validations of ``engine.py:393-450``.
    None picks ``"paged"`` when a paged feature is asked for, else
    ``"slots"``. The reference's None picks paged for ``prefix_cache``
    and ``chunk_tokens`` and refuses ``kv_quant`` and ``kv_pool_bytes``
    without ``kv_mode="paged"``; here those two pick paged as well, as
    they did when the port had no other mode. Given ``"slots"``, every
    paged feature raises ValueError as in the reference."""
    if kv_mode is None:
        kv_mode = ("paged" if (prefix_cache or chunk_tokens is not None
                               or kv_quant is not None
                               or kv_pool_bytes is not None) else "slots")
    if kv_mode not in ("slots", "paged"):
        raise ValueError(
            f"kv_mode must be 'slots' or 'paged', got {kv_mode!r}")
    if prefix_cache and kv_mode != "paged":
        raise ValueError(
            "prefix_cache=True needs the shared page pool: pass "
            "kv_mode='paged' (or leave kv_mode unset)")
    if kv_quant is not None and kv_mode != "paged":
        raise ValueError(
            "kv_quant= quantizes the shared page pool: pass "
            "kv_mode='paged' (or leave kv_mode unset)")
    if kv_pool_bytes is not None:
        if kv_mode != "paged":
            raise ValueError("kv_pool_bytes= requires kv_mode='paged'")
        if kv_pages is not None:
            raise ValueError(
                "pass kv_pages or kv_pool_bytes, not both: "
                "kv_pool_bytes derives the page count from the byte "
                "budget")
    if chunk_tokens is not None:
        if int(chunk_tokens) <= 0:
            raise ValueError(
                f"chunk_tokens must be > 0, got {chunk_tokens}")
        if kv_mode != "paged":
            raise ValueError(
                "chunked prefill writes prompt pages incrementally into "
                "the slot's block table: chunk_tokens= requires "
                "kv_mode='paged' (or leave kv_mode unset)")
        if spec_k:
            raise ValueError(
                "chunk_tokens= and spec_k= both reshape the decode-family "
                "step (mixed chunk+decode vs verify window): enable one "
                "or the other")
    return kv_mode


class Engine:
    """Cooperative continuous-batching engine over dense slot caches or
    a paged KV pool (module docstring).

    ``model``: a `models.gpt.GPTForPretraining`. ``slots``: concurrent
    sequences. ``max_len``: per-slot logical length — every request
    needs ``bucket(prompt) + max_new_tokens <= max_len``.
    ``prefill_buckets``: prompt pad lengths (default ``(max_len // 2,)``).
    ``kv_mode``: ``"slots"``, ``"paged"`` or None, which picks paged
    when ``prefix_cache``, ``chunk_tokens``, ``kv_quant`` or
    ``kv_pool_bytes`` is given and slots otherwise (the reference's None
    refuses the last two without ``"paged"``: `_resolve_kv_mode`).
    ``page_size`` / ``kv_pages``: the pool (default ``slots *
    ceil(max_len / page_size)`` pages, the dense-equivalent size).
    ``top_k``: top-k of every sampled request (0 = off). ``seed``:
    seeds the generator of a sampled request submitted without one.
    ``kv_quant``: None, ``"int8"`` or ``"fp8"`` (1-byte pages with f32
    scales). ``kv_pool_bytes``: size the pool by a byte budget instead
    of ``kv_pages`` (`paged.pages_in_budget`, ``engine.py:414-430``).
    ``prefix_cache``: share complete prompt pages across requests.
    ``chunk_tokens``: admit a longer uncached tail in chunks of this
    many tokens, each in a mixed step with every slot's decode (not
    with ``spec_k``). ``spec_k``: draft tokens per verify step (0 =
    plain decode); ``spec_ngram``: the longest suffix n-gram the n-gram
    drafter matches; ``draft_model``: another drafter (``.draft(context,
    k)`` or a callable ``fn(context, k)``); ``spec_adaptive``: True or
    an `AdaptiveSpecK` moving ``k`` between steps; ``spec_k_max``: the
    largest ``k`` (default ``spec_k``; adaptive: at least the top rung),
    which every admission budgets. ``weight_quant="int8"``: weight-only
    int8 serving, the quantizer of `GenerationMixin.generate`
    (`models.generation.quantize_state_int8`, cached on the model);
    every step dequantizes the weights it runs on inside its graph, as
    the reference's step executable does. ``engine_id``: the engine's
    name (default ``engine<n>``). ``default_deadline_s``: every
    request's deadline unless `submit` gives one. ``max_queue`` /
    ``shed_policy``: bounded admission. ``admission_retries``: failed
    page reservations before `PoolExhaustedError`. ``fault_injector``:
    a `faults.FaultInjector`. ``device``: ``None`` means ``cuda``
    (raises without a GPU); it must be the model's device. ``dtype``:
    the KV cache's float dtype (default the model's; a quantized pool's
    pages stay 1-byte). ``profiler``, ``slo``, ``flight_recorder`` and
    ``observability_port``: the module docstring's observability.
    """

    def __init__(self, model, slots=4, max_len=None, prefill_buckets=None,
                 page_size=16, kv_pages=None, top_k=0, seed=0, device=None,
                 kv_mode=None, kv_quant=None, spec_k=0, spec_ngram=3,
                 kv_pool_bytes=None, weight_quant=None, prefix_cache=False,
                 chunk_tokens=None, draft_model=None, spec_adaptive=False,
                 spec_k_max=None, engine_id=None, default_deadline_s=None,
                 max_queue=None, shed_policy="refuse", admission_retries=64,
                 fault_injector=None, dtype=None, profiler=None, slo=None,
                 flight_recorder=None, observability_port=None, **later):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"Engine() got an unexpected argument "
                                f"{name!r}")
            off, feature = _LATER[name]
            if value != off:
                raise _later(f"Engine({name}=...): {feature}")
        if max_len is None:
            raise ValueError(
                "max_len is required: per-slot KV length "
                "(bucket(prompt) + max_new_tokens must fit in it)")
        if int(spec_k) < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if shed_policy not in _SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be 'refuse', 'shed_newest', "
                f"'shed_closest_deadline' or 'infeasible', "
                f"got {shed_policy!r}")
        if default_deadline_s is not None and default_deadline_s <= 0:
            raise ValueError(
                f"default_deadline_s must be > 0, got {default_deadline_s}")
        self.kv_mode = _resolve_kv_mode(kv_mode, kv_quant, kv_pool_bytes,
                                        kv_pages, prefix_cache,
                                        chunk_tokens, spec_k)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {self.device}: move one of them")
        if kv_pool_bytes is not None:
            kv_pages = pages_in_budget(model, kv_pool_bytes,
                                       page_size=int(page_size),
                                       dtype=dtype, kv_quant=kv_quant)
        #: the quantized weights of ``weight_quant`` (None: as they are)
        self._qweights = model.serving_weights(weight_quant)
        self.model = model.eval()
        self.slots = int(slots)
        self.top_k = int(top_k)
        self._seed = int(seed)
        self._init_spec(int(spec_k), int(spec_ngram), draft_model,
                        spec_adaptive, spec_k_max)
        self._vocab = int(model.config.vocab_size)
        if self.kv_mode == "paged":
            self.kv = PagedKVCache(model, self.slots, int(max_len),
                                   page_size=int(page_size), pages=kv_pages,
                                   dtype=dtype, kv_quant=kv_quant)
        else:
            self.kv = SlotKVCache(model, self.slots, int(max_len),
                                  dtype=dtype)
        buckets = (prefill_buckets if prefill_buckets is not None
                   else (max(1, int(max_len) // 2),))
        self.scheduler = SlotScheduler(self.slots, buckets, int(max_len),
                                       spec_cols=self._spec_k_max)
        self.metrics = (EngineMetrics(engine_id=str(engine_id))
                        if engine_id is not None else EngineMetrics())
        if self._spec_k:
            self.metrics.note_spec_k(self._spec_k)
        #: the radix prefix cache (None without ``prefix_cache``); pool
        #: pressure evicts from it, counted in ``prefix_evicted_pages``
        self.prefix = PrefixCache(self.kv) if prefix_cache else None
        if self.prefix is not None:
            self.kv.reclaim = self._reclaim
        #: the chunk budget (None: prompts admit whole)
        self._chunk_tokens = (int(chunk_tokens) if chunk_tokens is not None
                              else None)
        #: the one request mid-chunk: it holds its slot and its whole page
        #: reservation but is in neither the queue nor ``_slot_req``
        self._chunk_req: Request | None = None
        self._chunk_t0 = 0.0
        #: the request `step` popped for admission and has not slotted
        #: yet (in neither the queue nor a slot: the shutdown sweep
        #: covers it)
        self._admitting: Request | None = None
        # -- deadlines and bounded admission ---------------------------
        self._default_deadline_s = (float(default_deadline_s)
                                    if default_deadline_s is not None
                                    else None)
        self._max_queue = int(max_queue) if max_queue is not None else None
        self._shed_policy = shed_policy
        self._admission_retries = int(admission_retries)
        #: `faults.FaultInjector` or None (one ``is None`` check a hook)
        self._faults = fault_injector
        #: moving average of an admission's seconds (the queue delay
        #: estimate)
        self._ewma_admit_s = None
        #: the terminated requests' timelines
        self.timelines = TimelineRing()
        #: the SLO evaluation of every terminated request (None: no SLO)
        self.slo = (SLOTracker(slo, source_id=self.engine_id)
                    if slo is not None else None)
        #: ``profiler(event, info)`` after each prefill, chunk and decode
        self._profiler = profiler
        #: the dispatch heartbeat: the monotonic start of the step in
        #: flight (None between steps) and the end of the last one that
        #: returned (a postmortem's last good heartbeat)
        self._hb_busy_since = None
        self._hb_last_done = None
        #: the serving role (``"both"``: the disaggregated roles are A10)
        self.role = "both"
        self._tokens = np.zeros((self.slots,), np.int64)
        self._slot_req: list[Request | None] = [None] * self.slots
        self._next_rid = 0
        self._fatal: BaseException | None = None
        self._closed = False
        self._lock = threading.RLock()
        self._thread: threading.Thread | None = None
        self._running = False
        #: the graph memory pool of every step of this engine
        self._graphs = graph_pool(self.device)
        #: the steps, each built on first use: prefill by bucket, tail
        #: prefill by tail bucket, embed by chunk width, the decode/verify
        #: step of each k (``_verify``: the current one), the mixed chunk
        #: step
        self._prefill_fns: dict = {}
        self._cprefill_fns: dict = {}
        self._embed_fns: dict = {}
        self._verify_fns: dict = {}
        self._verify = None
        self._chunk_fn = None
        own_flight = flight_recorder is True
        if own_flight:
            from ..observability.flight_recorder import FlightRecorder
            flight_recorder = FlightRecorder()
        #: the crash flight recorder (None: none); a recorder this engine
        #: built is detached from the tracing sinks when it shuts down
        self._flight = flight_recorder or None
        self._flight_owned = own_flight
        if self._flight is not None:
            self._flight.attach()
        #: the engine's own `ObservabilityServer` (observability_port=),
        #: stopped by `close`
        self.obs_server = None
        if observability_port is not None:
            from ..observability.server import start_observability_server
            self.obs_server = start_observability_server(
                port=observability_port).attach(self)

    def _init_spec(self, spec_k, spec_ngram, draft_model, spec_adaptive,
                   spec_k_max):
        """The drafter, the k ceiling and the adaptive controller
        (``engine.py:344-404``)."""
        #: verify lanes past the pending token (0 = plain decode); an
        #: adaptive engine moves it between steps
        self._spec_k = spec_k
        if not spec_k:
            self._drafter = None
        elif draft_model is None:
            self._drafter = NgramDrafter(max_ngram=spec_ngram)
        elif hasattr(draft_model, "draft"):
            self._drafter = draft_model
        else:
            self._drafter = CallableDrafter(draft_model)
        #: the k every admission budgets for: spec_k, or the top rung
        self._spec_k_max = (int(spec_k_max) if spec_k_max is not None
                            else spec_k)
        if self._spec_k_max < spec_k:
            raise ValueError(f"spec_k_max must be >= spec_k, got "
                             f"{self._spec_k_max} < {spec_k}")
        if spec_k_max is not None and not spec_k:
            raise ValueError("spec_k_max requires spec_k > 0")
        #: the accept-driven k controller (None: k is fixed)
        self._spec_ctrl = None
        if spec_adaptive:
            if not spec_k:
                raise ValueError(
                    "spec_adaptive needs spec_k > 0 (the starting k)")
            self._spec_ctrl = (
                spec_adaptive if isinstance(spec_adaptive, AdaptiveSpecK)
                else AdaptiveSpecK(spec_k_ladder(spec_k, self._spec_k_max),
                                   k0=spec_k))
            if spec_k not in self._spec_ctrl.rungs:
                raise ValueError(
                    f"spec_k={spec_k} not in the controller's rungs "
                    f"{self._spec_ctrl.rungs}")
            self._spec_k_max = max(self._spec_k_max,
                                   max(self._spec_ctrl.rungs))
        #: (decode step, new k) of every rung move
        self._spec_k_history: list = []

    # -- client surface --------------------------------------------------
    @property
    def engine_id(self) -> str:
        """The engine's name: the ``engine=`` label of its registry
        families and the bracket of its step names."""
        return self.metrics.engine_id

    @property
    def alive(self) -> bool:
        """False once the engine died on a step failure or was closed."""
        return self._fatal is None

    @property
    def slo_burn_rate(self) -> float:
        """The SLO tracker's largest burn rate (0.0 without an SLO): the
        signal a load-aware router steers by (``engine.py:742-747``)."""
        return self.slo.burn_rate() if self.slo is not None else 0.0

    def heartbeat(self):
        """The monotonic start of the step in flight, None between
        steps: ``time.monotonic() - heartbeat()`` past a threshold is a
        wedged step (the endpoint's ``/healthz``). Read without the
        lock."""
        return self._hb_busy_since

    @property
    def running(self) -> bool:
        """True while the background loop (`start`) steps the engine."""
        return self._running

    @property
    def saturated(self) -> bool:
        """True while bounded admission would shed or refuse a request
        arriving now (always False without ``max_queue``)."""
        return (self._max_queue is not None
                and self.scheduler.queue_depth >= self._max_queue)

    @property
    def est_queue_delay_s(self) -> float:
        """The submit-to-admission delay of a request arriving now: the
        queue depth times the moving average of an admission's seconds
        (``engine.py:594-600``)."""
        return self.scheduler.queue_depth * (self._ewma_admit_s or 0.0)

    def submit(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
               decode_strategy="greedy_search", temperature=1.0,
               top_k=None, top_p=None, seed=None,
               deadline_s=None) -> RequestHandle:
        """Queue one request; returns its `RequestHandle`. Arguments are
        normalized as the reference's ``_prepare_request`` does
        (temperature 0 means greedy; ``top_k`` of a sampled request must
        equal the engine's). A sampled request draws from its own
        generator, seeded by ``seed`` (default: the engine seed and the
        request id), so it reproduces whatever shares its batch.

        ``deadline_s`` (default: the engine's ``default_deadline_s``;
        ``float("inf")`` opts one request out of it) bounds the
        request's lifetime: past it the request fails with
        `DeadlineExceededError` at the engine's next step. With
        ``max_queue`` set and the queue full, ``shed_policy="refuse"``
        (and ``"infeasible"``) raises `OverloadedError` here; the shed
        policies return a handle that may already be failed with it."""
        with self._lock:
            self._check_alive()
            rid = self._next_rid
            self._next_rid += 1
            req = self._prepare(rid, prompt_ids, max_new_tokens,
                                eos_token_id, decode_strategy, temperature,
                                top_k, top_p, seed,
                                deadline_s if deadline_s is not None
                                else self._default_deadline_s)
            req.bucket = self.scheduler.validate(req)
            if self.kv_mode == "paged":
                # a budget beyond the whole pool could never admit
                need, span = self._page_budget(req)
                if need > self.kv.pages_total:
                    spec = (f" + {self._spec_k_max} speculative verify "
                            "lanes" if self._spec_k else "")
                    raise ValueError(
                        f"request needs {need} KV pages ({span} + "
                        f"{req.max_new_tokens} new tokens{spec} at "
                        f"page_size {self.kv.page_size}) but the pool "
                        f"holds {self.kv.pages_total} — raise kv_pages or "
                        "lower max_new_tokens")
            req.handle = RequestHandle(self, req)
            if self._shed_policy == "infeasible":
                # a doomed deadline is refused whatever the queue holds
                self._check_feasible(req)
            if self.saturated:
                self._shed_admission(req)
                if req.done:
                    return req.handle
            self.scheduler.enqueue(req)
            req.trace = _tracing.TraceContext.new(self.engine_id, req.rid)
            self.metrics.submitted += 1
            _tracing.async_begin("request", req.aid, request_id=req.rid,
                                 hop=req.hop, prompt_len=req.prompt_len,
                                 max_new_tokens=req.max_new_tokens,
                                 replica=self.engine_id)
            return req.handle

    def _prepare(self, rid, prompt_ids, max_new_tokens, eos_token_id,
                 decode_strategy, temperature, top_k, top_p, seed,
                 deadline_s):
        if decode_strategy == "beam_search":
            raise NotImplementedError(
                "the continuous-batching engine serves greedy_search and "
                "sampling; beam search stays on one-shot generate()")
        if decode_strategy not in ("greedy_search", "sampling"):
            raise NotImplementedError(
                f"decode_strategy {decode_strategy!r}: use "
                "'greedy_search' or 'sampling'")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        top_k = self.top_k if top_k is None else int(top_k)
        top_p = 1.0 if top_p is None else float(top_p)
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if temperature == 0.0:
            decode_strategy, temperature = "greedy_search", 1.0
        if decode_strategy == "sampling" and top_k != self.top_k:
            raise ValueError(
                f"sampling request top_k={top_k} != engine top_k="
                f"{self.top_k}: configure top_k on the Engine")
        ids = np.asarray(prompt_ids.cpu() if torch.is_tensor(prompt_ids)
                         else prompt_ids)
        if ids.ndim == 2 and ids.shape[0] == 1:
            ids = ids[0]
        if ids.ndim != 1 or ids.shape[0] < 1:
            raise ValueError(
                f"prompt_ids must be a non-empty 1-D id sequence (or "
                f"[1, len]), got shape {ids.shape}")
        params = SamplingParams(decode_strategy, float(temperature), top_k,
                                top_p)
        req = Request(rid, ids.astype(np.int64), int(max_new_tokens),
                      eos_token_id, params)
        if deadline_s is not None:
            if deadline_s <= 0:
                raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
            req.deadline_s = float(deadline_s)
            # the sweep compares the (possibly skewed) `_now` with it
            req.deadline_t = req.submit_time + req.deadline_s
        if not params.greedy:
            s = int(seed) if seed is not None else self._seed * 1_000_003 + rid
            req.seed = s
            req.generator = torch.Generator(device=self.device).manual_seed(s)
        return req

    def step(self) -> bool:
        """One engine iteration: fail expired requests, admit queued
        requests into free slots, then one decode step over all slots
        (while a prompt is mid-chunk, the mixed step: its next chunk and
        the decode step together). False when fully idle. A failure
        kills the engine: every handle fails with the cause and every
        page returns."""
        self._check_alive()
        if self._flight is not None:
            # the black box's periodic registry snapshot (rate-limited
            # inside: one monotonic read a step)
            self._flight.maybe_snapshot()
        try:
            with self._lock, torch.inference_mode():
                self._check_alive()
                # first: an expired queued request fails before it
                # reserves pages, an expired slot frees its pages for
                # this step's admissions
                did = self._sweep_deadlines()
                while self._chunk_req is None:
                    # one chunking request at a time, and nothing behind
                    # it admits until it has its slot (FCFS)
                    req = self.scheduler.next_admission()
                    if req is None:
                        break
                    self._admitting = req
                    if self.kv_mode == "paged" and not self._admission_ok(
                            req):
                        self._admitting = None
                        if req.done:
                            # its retries ran out: failed typed
                            did = True
                            continue
                        # pool exhausted: back to the queue head until a
                        # release returns pages (no neighbour is touched)
                        self.scheduler.requeue_admission(req)
                        break
                    did = True
                    if (self._chunk_tokens is not None
                            and req.prompt_len - req.prefix_len
                            > self._chunk_tokens):
                        self._begin_chunk(req)
                        self._admitting = None
                        break
                    self._admit(req)
                    self._admitting = None
                if self._chunk_req is not None:
                    self._chunk_step()
                    did = True
                elif self.kv.active.any():
                    self._decode_once()
                    did = True
                return did
        except BaseException as exc:
            # the caches may be half written: the engine cannot go on
            self._die(exc)
            raise

    def run_until_idle(self):
        """Step until the engine is idle."""
        while self.step():
            pass

    # -- background mode -------------------------------------------------
    def start(self):
        """Step the engine on a daemon thread (handles then wait on their
        streams instead of stepping it). Returns the engine."""
        with self._lock:
            self._check_alive()
            if self._running:
                return self
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"serving-engine[{self.engine_id}]")
            self._thread.start()
        return self

    def stop(self):
        """Stop the background loop and join its thread (the engine stays
        usable cooperatively)."""
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _loop(self):
        # a new thread's current CUDA device is 0: make the engine's
        # current, and replay on this thread's stream of it
        dev = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with dev:
            while self._running:
                try:
                    if not self.step():
                        time.sleep(0.001)
                except Exception:
                    # step() already failed every handle (`_die`)
                    return

    def close(self):
        """Idempotent shutdown: stop the background loop, fail every
        queued and in-flight request with `EngineClosedError` and return
        its slot and pages; later calls are refused."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.stop()
        if self.obs_server is not None:
            self.obs_server.stop()
        with self._lock:
            if self._fatal is None:
                self._shutdown_sweep(EngineClosedError(
                    f"engine {self.engine_id} was closed while the request "
                    "was queued or in flight"))

    def embed(self, prompts) -> list:
        """The final ``ln_f`` hidden state ``[hidden]`` float32 (numpy) of
        each prompt (``engine.py:1932-2024``): an all-prefill pass through
        the tail prefill over the slot's own pages, in chunks of
        ``chunk_tokens`` (one graph a chunk width), else in one chunk of
        the prompt's bucket. No token is sampled and nothing decodes;
        the slot and its pages are released before it returns. It takes
        a free slot outside the queue, stepping the engine while none is
        free. Needs ``kv_mode="paged"``."""
        self._check_alive()
        if self.kv_mode != "paged":
            raise RuntimeError(
                "Engine.embed() runs through the paged prefill path: "
                "build the engine with kv_mode='paged' (or chunk_tokens=)")
        out = []
        for prompt_ids in prompts:
            ids = np.asarray(prompt_ids.cpu() if torch.is_tensor(prompt_ids)
                             else prompt_ids)
            if ids.ndim == 2 and ids.shape[0] == 1:
                ids = ids[0]
            if ids.ndim != 1 or ids.shape[0] < 1:
                raise ValueError(
                    f"embed prompts must be non-empty 1-D id sequences "
                    f"(or [1, len]), got shape {ids.shape}")
            with self._lock:
                out.append(self._embed_one(ids.astype(np.int64)))
        return out

    def stats(self):
        """`metrics.EngineStats` snapshot; the pool's page fields only in
        paged mode (``engine.py:1160-1208``)."""
        with self._lock:
            counts = kernel_launch_counts()
            paged = {}
            if self.kv_mode == "paged":
                paged = dict(
                    kv_page_size=self.kv.page_size,
                    kv_pages_total=self.kv.pages_total,
                    kv_pages_in_use=self.kv.pages_in_use,
                    kv_pages_free=self.kv.pages_free,
                    kv_slot_pages=self.kv.slot_page_counts(),
                    kv_quant=self.kv.kv_quant,
                    kv_pool_bytes=self.kv.memory_bytes(),
                    kv_bytes_per_token=(self.kv.bytes_per_page()
                                        / self.kv.page_size))
                if self.prefix is not None:
                    paged["prefix_cached_pages"] = self.prefix.cached_pages
            slo_kw = {}
            if self.slo is not None:
                snap = self.slo.snapshot()
                slo_kw = dict(slo_attained=snap["attained_total"],
                              slo_violated=snap["violated_total"],
                              slo_attainment=snap["attainment"],
                              slo_burn_rate=snap["burn_rate"],
                              goodput_per_s=snap["goodput_per_s"])
            # the decode step's cost on the registry under its step name
            # (``executable_flops{executable=}``; None before the first)
            exec_flops = (self._decode_step_flops()
                          if self._verify is not None else None)
            _costs.record_executable_costs(self._decode_name(), exec_flops)
            return self.metrics.snapshot(
                kv_mode=self.kv_mode,
                queue_depth=self.scheduler.queue_depth,
                active_slots=self.kv.occupancy,
                free_slots=self.scheduler.free_slots,
                kv_cache_bytes=self.kv.memory_bytes(),
                spec_k=self._spec_k,
                spec_k_history=tuple(self._spec_k_history),
                est_queue_delay_s=self.est_queue_delay_s,
                chunk_tokens=self._chunk_tokens or 0,
                capture_s=sum(fn.capture_s for fn in self._steps()),
                paged_attention_launches=sum(counts[k]
                                             for k in _PAGED_KERNELS),
                decode_exec_flops=exec_flops,
                **slo_kw, **paged)

    def _decode_step_flops(self) -> float:
        """One decode/verify step's operations as the engine stands, where
        the reference reads its executable's ``cost_analysis()``
        (`costs.gpt_decode_flops`): the model's products at the current
        window W, plus the attention's ``4 H W L D`` a row and a layer,
        ``L`` the columns the step reads (paged: an active row's cursor
        plus the window, a parked row's whole table, as the kernel's
        uniform fallback reads it; slots: the whole row). Read when
        asked, never on the step's path."""
        w = self._spec_k + 1
        if self.kv_mode == "paged":
            lp = self.kv.logical_len
            cols = np.where(self.kv.active,
                            np.minimum(self.kv.steps + w, lp), lp)
        else:
            cols = np.full((self.slots,), self.kv.max_len)
        return _costs.gpt_decode_flops(self.model.config, w, cols)

    def _decode_name(self) -> str:
        """The current decode/verify step's name (`metrics.step_name`):
        its cost entry's key."""
        if self._spec_ctrl is None:
            return self.metrics.step_name("decode")
        return self.metrics.step_name("decode", f"k{self._spec_k}")

    def _steps(self):
        """Every step this engine built so far."""
        return [*self._prefill_fns.values(), *self._cprefill_fns.values(),
                *self._embed_fns.values(), *self._verify_fns.values(),
                *((self._chunk_fn,) if self._chunk_fn is not None else ())]

    def _pool_kw(self, tag=None, kind="prefill", count=True):
        """The keyword arguments every step builder takes: what the step
        writes, its weights, its graph pool, and its name and trace
        report under ``kind`` and ``tag``."""
        kw = dict(weights=self._qweights, pool=self._graphs,
                  on_trace=functools.partial(self.metrics.note_trace,
                                             tag=tag, count=count),
                  name=self.metrics.step_name(kind, tag))
        if self.kv_mode == "paged":
            kw.update(pools=self.kv.caches, scales=self.kv.scales)
        else:
            kw.update(caches=self.kv.caches)
        return kw

    def _prefill_fn(self, bucket: int):
        """The prefill step of ``bucket`` (built on first use)."""
        fn = self._prefill_fns.get(bucket)
        if fn is None:
            kw = self._pool_kw(f"b{bucket}")
            fn = self._prefill_fns[bucket] = (
                build_paged_prefill_fn(self.model, 1, bucket,
                                       self.kv.page_size,
                                       max_pages=self.kv.max_pages, **kw)
                if self.kv_mode == "paged"
                else build_prefill_fn(self.model, 1, bucket, **kw))
        return fn

    def _cprefill_fn(self, tb: int):
        """The tail prefill step of tail bucket ``tb`` (built on first
        use; ``b{tb}pfx`` to the sentinel)."""
        fn = self._cprefill_fns.get(tb)
        if fn is None:
            fn = self._cprefill_fns[tb] = build_cached_prefill_fn(
                self.model, 1, tb, self.kv.max_pages,
                **self._pool_kw(f"b{tb}pfx"))
        return fn

    def _embed_fn(self, width: int):
        """The embed chunk step of ``width`` tokens (built on first use;
        ``embed{width}`` to the sentinel)."""
        fn = self._embed_fns.get(width)
        if fn is None:
            fn = self._embed_fns[width] = build_embed_prefill_fn(
                self.model, 1, width, self.kv.max_pages,
                **self._pool_kw(f"embed{width}"))
        return fn

    def _verify_fn(self):
        """The current decode (W = 1) or verify (W = k + 1) step; the
        first call builds the family (`_build_verify_fns`)."""
        if self._verify is None:
            self._build_verify_fns()
        return self._verify

    def _build_verify_fns(self):
        """Build the verify steps at the first decode (``engine.py:
        2552-2595``): one for a fixed k, or every rung of an adaptive
        ladder, each rung but the current one run once here on parked
        operands (`_prewarm_verify`) so that a later k move replays a
        step already built. Only the starting rung counts in
        ``decode_traces``; the others register with the sentinel under
        ``k{k}`` without counting, so ``decode_traces == 1`` keeps
        meaning one live decode path."""
        rungs = (self._spec_ctrl.rungs if self._spec_ctrl is not None
                 else (self._spec_k,))
        for k in rungs:
            if self._spec_ctrl is None:
                kw = self._pool_kw(kind="decode")
            else:
                kw = self._pool_kw(f"k{k}", kind="decode",
                                   count=k == self._spec_k)
            self._verify_fns[k] = (
                build_paged_verify_step_fn(
                    self.model, self.slots, k + 1, self.kv.max_pages,
                    self.kv.page_size, **kw)
                if self.kv_mode == "paged"
                else build_verify_step_fn(self.model, self.slots, k + 1,
                                          self.kv.max_len, **kw))
        for k in rungs:
            if k != self._spec_k:
                self._prewarm_verify(k)
        self._verify = self._verify_fns[self._spec_k]

    def _prewarm_verify(self, k: int):
        """Build one rung that is not the current k on parked operands:
        an all-zero window behind each slot's pending token (``engine.py:
        2596-2629``; `CapturedStep.build`: on a card its warm-up runs the
        body once, uncounted, and no replay follows). Safe beside live
        slots: lane 0 writes the pending token's own K/V at its cursor,
        and the other lanes write above every cursor, on the slot's
        reserved pages (budgeted for ``spec_k_max``) or the sentinel page,
        where nothing is read before a real window overwrites it, the
        invariant rollback rests on. Not a step: no step count, fault
        hook, timing or launch count."""
        toks = np.zeros((self.slots, k + 1), np.int64)
        toks[:, 0] = self._tokens
        self._verify_fns[k].build(**self._step_operands(toks))

    def _set_spec_k(self, k: int):
        """Move to rung ``k`` between steps (``engine.py:2631-2646``): the
        current step becomes that rung's; the admission budget stays at
        ``spec_k_max``."""
        self._spec_k = int(k)
        self._verify = self._verify_fns[self._spec_k]
        self._spec_k_history.append((self.metrics.decode_steps,
                                     self._spec_k))
        self.metrics.note_spec_k(self._spec_k)

    def _mixed_fn(self):
        """The mixed chunk + decode step (built on first use; a second
        member of the decode family, ``mix{chunk_tokens}``, not counted
        in ``decode_traces``: ``engine.py:1780-1787``)."""
        if self._chunk_fn is None:
            ct = self._chunk_tokens
            self._chunk_fn = build_chunked_prefill_decode_fn(
                self.model, self.slots, ct, self.kv.max_pages,
                self.kv.page_size,
                **self._pool_kw(f"mix{ct}", kind="decode", count=False))
        return self._chunk_fn

    def _step_operands(self, tokens: np.ndarray, block_table=None) -> dict:
        """The decode/verify step's operands: ``tokens [S, W]`` and the
        cache's host-side slot state, as they stand (paged: the block
        table, or ``block_table`` in its place)."""
        ops = dict(tokens=tokens, steps=self.kv.steps, pads=self.kv.pads,
                   valid_cols=self.kv.valid_cols)
        if self.kv_mode == "paged":
            ops["block_table"] = (self.kv.block_table if block_table is None
                                  else block_table)
        return ops

    # -- internals -------------------------------------------------------
    def _check_alive(self):
        if self._fatal is not None:
            if isinstance(self._fatal, EngineClosedError):
                raise RuntimeError(
                    f"engine {self.engine_id} is closed") from self._fatal
            raise RuntimeError("the serving engine died on a step failure; "
                               "build a new Engine") from self._fatal

    def _die(self, exc: BaseException):
        """A step failed: record the death, fail every request with the
        cause and return every page (`_shutdown_sweep`)."""
        with self._lock:
            if self._fatal is None:
                self._shutdown_sweep(exc)

    def _shutdown_sweep(self, exc: BaseException):
        """The teardown of `_die` and `close` (``engine.py:1070-1143``;
        lock held): fail the queued, admitting, chunking and slotted
        requests with ``exc`` and release every slot and page they hold
        (page accounting is host-side, so it holds after any failure)."""
        self._running = False
        self._fatal = exc
        if self._flight is not None:
            if not isinstance(exc, EngineClosedError):
                # a real death dumps its postmortem before the sweep
                # closes the in-flight state it records; close() writes
                # nothing. Never raises.
                self._flight.dump_engine_death(self, exc)
            if self._flight_owned:
                self._flight.detach()
        queued = [r for r in self.scheduler.queued_requests() if not r.done]
        for req in queued:
            self.scheduler.remove(req)
        for held in (self._admitting, self._chunk_req):
            if held is None:
                continue
            if held.slot is not None:
                self.kv.release(held.slot)
                self.scheduler.release(held.slot)
                held.slot = None
            if not held.done:
                queued.insert(0, held)
        self._admitting = None
        if self._chunk_req is not None:
            self._chunk_req = None
            self.metrics.set_chunk_active(False)
        for req in queued:
            req.state = CANCELLED
            req.handle._close(exc)
            self._end_span(req)
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._slot_req[slot] = None
            self.kv.release(slot)
            self.scheduler.release(slot)
            if not req.done:
                req.state = CANCELLED
                req.handle._close(exc)
                self._end_span(req)

    def _end_span(self, req: Request):
        """Close the request's lifecycle span (opened at submit)."""
        _tracing.async_end("request", req.aid, request_id=req.rid,
                           hop=req.hop, state=req.state,
                           tokens=len(req.emitted))

    def _profile(self, event, **info):
        if self._profiler is not None:
            self._profiler(event, info)

    def _fault(self, phase: str, index: int):
        """The fault injector's dispatch hook (``step_hang``,
        ``step_error``), just before a step's dispatch."""
        if self._faults is not None:
            self._faults.on_dispatch(self, phase, index)

    @contextlib.contextmanager
    def _dispatch(self, phase: str, index: int):
        """One step's dispatch region: the heartbeat busy for all of it
        (a wedged step shows a stale stamp), the fault injector's hook
        first; a dispatch that returned stamps the last good heartbeat
        (``engine.py:1586-1626``)."""
        self._hb_busy_since = time.monotonic()
        try:
            self._fault(phase, index)
            yield
        finally:
            self._hb_busy_since = None
        self._hb_last_done = time.monotonic()

    def _now(self) -> float:
        """The deadline clock: perf_counter plus any injected skew."""
        t = time.perf_counter()
        if self._faults is not None:
            t += self._faults.skew(self)
        return t

    def _sweep_deadlines(self) -> bool:
        """Fail every expired request (``engine.py:1256-1289``): queued
        ones before any page is reserved, decoding ones with their slot
        and pages released (the tokens so far stay on the handle), the
        mid-chunk one through `_abort_chunk`. True when any expired."""
        did = False
        now = self._now()

        def expired(r):
            return (r is not None and r.deadline_t is not None
                    and now > r.deadline_t and not r.done)

        for req in self.scheduler.queued_requests():
            if expired(req):
                self.scheduler.remove(req)
                self._expire(req, "queued")
                did = True
        for req in list(self._slot_req):
            if expired(req):
                self._expire(req, "decoding")
                did = True
        creq = self._chunk_req
        if expired(creq):
            self.metrics.note_deadline_exceeded()
            _tracing.async_instant("deadline.exceeded", creq.aid,
                                   request_id=creq.rid, hop=creq.hop,
                                   where="chunking", tokens=0,
                                   replica=self.engine_id)
            self._abort_chunk(creq, DeadlineExceededError(
                f"request {creq.rid} missed its {creq.deadline_s:.3f}s "
                "deadline mid-chunked-prefill (no tokens emitted)"))
            did = True
        return did

    def _expire(self, req: Request, where: str):
        """The typed deadline failure of a queued or decoding request."""
        req.state = CANCELLED
        self.metrics.note_deadline_exceeded()
        _tracing.async_instant("deadline.exceeded", req.aid,
                               request_id=req.rid, hop=req.hop, where=where,
                               tokens=len(req.emitted),
                               replica=self.engine_id)
        detail = ("while queued (no tokens emitted)" if where == "queued"
                  else f"mid-decode ({len(req.emitted)} tokens emitted, "
                       "readable on handle.partial)")
        self._release(req, DeadlineExceededError(
            f"request {req.rid} missed its {req.deadline_s:.3f}s deadline "
            f"{detail}"))

    def _feasibility_estimate(self, max_new_tokens: int,
                              prompt_tokens: int | None = None):
        """``(seconds, detail)`` to serve a request arriving now
        (``paddle_tpu/serving/control.py:187-238``): the queue delay
        estimate, the backlog's service waves and the request's own
        prefill (on a chunking engine a chunk step per ``chunk_tokens``
        of its ``prompt_tokens``) and ``max_new_tokens`` decode steps,
        priced at the `FEASIBILITY_QUANTILE` of this engine's phase
        histograms. ``(None, detail)`` until each holds
        `FEASIBILITY_MIN_SAMPLES` observations."""
        prefill_q, n_prefill = self.metrics.quantile("h_prefill",
                                                     FEASIBILITY_QUANTILE)
        decode_q, n_decode = self.metrics.quantile("h_decode",
                                                   FEASIBILITY_QUANTILE)
        detail = dict(est_queue_delay_s=self.est_queue_delay_s,
                      prefill_s=prefill_q, decode_step_s=decode_q,
                      quantile=FEASIBILITY_QUANTILE,
                      samples=(n_prefill, n_decode))
        if (prefill_q is None or decode_q is None
                or min(n_prefill, n_decode) < FEASIBILITY_MIN_SAMPLES):
            return None, detail
        if self._chunk_tokens and prompt_tokens:
            detail["prefill_chunks"] = max(
                1, -(-int(prompt_tokens) // self._chunk_tokens))
            detail["prefill_s"] = prefill_q * detail["prefill_chunks"]
        per_req = detail["prefill_s"] + max_new_tokens * decode_q
        detail["backlog_s"] = (self.scheduler.queue_depth
                               / max(1, self.slots) * per_req)
        return (detail["est_queue_delay_s"] + detail["backlog_s"]
                + per_req), detail

    def _check_feasible(self, req: Request):
        """``shed_policy="infeasible"`` (``engine.py:1305-1361``): refuse
        at submit, typed, a request whose finite deadline the estimate
        already exceeds."""
        if req.deadline_t is None or req.deadline_t == float("inf"):
            return
        est, detail = self._feasibility_estimate(req.max_new_tokens,
                                                 req.prompt_len)
        if est is None:
            return
        remaining = req.deadline_t - self._now()
        if est <= remaining:
            return
        self.metrics.note_shed("infeasible")
        _tracing.async_instant("shed", req.aid, request_id=req.rid,
                               hop=req.hop, policy="infeasible",
                               replica=self.engine_id)
        exc = InfeasibleDeadlineError(
            f"request {req.rid} cannot meet its deadline on engine "
            f"{self.engine_id}: estimated {est:.3f}s (queue "
            f"{detail['est_queue_delay_s']:.3f}s + prefill "
            f"{detail['prefill_s']:.3f}s + {req.max_new_tokens} x decode "
            f"{detail['decode_step_s']:.4f}s) vs {remaining:.3f}s remaining "
            "— relax deadline_s or lower max_new_tokens")
        req.state = CANCELLED
        req.handle._close(exc)
        raise exc

    def _shed_admission(self, incoming: Request):
        """The queue is full (``engine.py:1363-1427``): ``refuse`` (and
        ``infeasible``) raises `OverloadedError` from submit;
        ``shed_newest`` fails the incoming request; ``shed_closest_
        deadline`` fails whichever of the queued and incoming requests
        is nearest its deadline (the incoming one when none has a
        deadline). The victim's handle closes with the error."""
        policy = self._shed_policy
        if policy in ("refuse", "infeasible"):
            self.metrics.note_shed("refuse")
            _tracing.async_instant("shed", incoming.aid,
                                   request_id=incoming.rid, hop=incoming.hop,
                                   policy="refuse", replica=self.engine_id)
            exc = OverloadedError(
                f"engine {self.engine_id} queue is full ({self._max_queue} "
                f"deep; shed_policy={policy!r}): retry with backoff or "
                "raise max_queue")
            incoming.state = CANCELLED
            incoming.handle._close(exc)
            raise exc
        victim = incoming
        if policy == "shed_closest_deadline":
            cands = [r for r in self.scheduler.queued_requests()
                     if r.deadline_t is not None and not r.done]
            if incoming.deadline_t is not None:
                cands.append(incoming)
            if cands:
                victim = min(cands, key=lambda r: r.deadline_t)
        self.metrics.note_shed(policy)
        _tracing.async_instant("shed", victim.aid, request_id=victim.rid,
                               hop=victim.hop, policy=policy,
                               replica=self.engine_id)
        victim.state = CANCELLED
        if victim is not incoming:
            self.scheduler.remove(victim)
        victim.handle._close(OverloadedError(
            f"request {victim.rid} shed by engine {self.engine_id} (queue "
            f"full at {self._max_queue}, policy {policy!r})"))
        if victim is not incoming:
            # the incoming request's span never opened (it opens once
            # the request is queued)
            self._end_span(victim)

    def _admission_ok(self, req: Request) -> bool:
        """The paged admission gate of a popped request (``engine.py:
        1451-1484``): its reservation and the retry budget. False: back
        to the queue (the pool is still exhausted or the backoff has
        not passed), unless the budget ran out and the request was
        failed typed (``req.done``, its slot returned)."""
        if (req.retry_free_seen is not None
                and self.kv.pages_free == req.retry_free_seen
                and time.perf_counter() < req.retry_after_t):
            # nothing was released and the backoff has not passed
            return False
        if self._reserve(req):
            return True
        self.metrics.kv_pages_exhausted += 1
        _tracing.async_instant("kv_pages.exhausted_requeue", req.aid,
                               request_id=req.rid, hop=req.hop,
                               pages_free=self.kv.pages_free)
        req.exhaustion_retries += 1
        if req.exhaustion_retries >= self._admission_retries:
            self.scheduler.release(req.slot)
            req.slot = None
            need, _ = self._page_budget(req)
            req.state = CANCELLED
            _tracing.async_instant("kv_pages.exhausted_fail", req.aid,
                                   request_id=req.rid, hop=req.hop,
                                   retries=req.exhaustion_retries,
                                   replica=self.engine_id)
            self._end_span(req)
            req.handle._close(PoolExhaustedError(
                f"request {req.rid} needed {need} KV pages but the pool "
                f"holds {self.kv.pages_total} ({self.kv.pages_free} free "
                f"right now) and all {req.exhaustion_retries} admission "
                "retries found it exhausted — raise kv_pages, lower "
                "max_new_tokens, or raise Engine(admission_retries=)"))
            return False
        req.retry_free_seen = self.kv.pages_free
        # capped exponential: 4 ms, 8 ms, ... 0.5 s; a release ends it
        req.retry_after_t = time.perf_counter() + min(
            0.5, 0.002 * (1 << min(req.exhaustion_retries, 8)))
        return False

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @staticmethod
    def _sampler(req: Request | None):
        if req is None or req.params.greedy:
            return None
        return (req.params.temperature, req.params.top_p, req.generator)

    def _page_budget(self, req: Request):
        """``(pages, label)``: the request's whole page budget
        (``engine.py:1429-1450``). With the prefix cache the prompt is
        laid out unpadded, so the worst case (no match) skips the pad
        columns; both budget the ``spec_k_max`` verify lanes (an adaptive
        engine's top rung, whatever the current k)."""
        if self.prefix is not None:
            return (pages_for(req.prompt_len
                              + max(0, req.max_new_tokens - 1)
                              + self._spec_k_max, self.kv.page_size),
                    f"prompt {req.prompt_len}")
        return (self.kv.pages_needed(req.bucket, req.max_new_tokens,
                                     extra_cols=self._spec_k_max),
                f"bucket {req.bucket}")

    def _reserve(self, req: Request) -> bool:
        """The page reservation of a popped request (``engine.py:
        1500-1535``). With the prefix cache: match the prompt, map the
        cached pages read-only, reserve the private rest (the pool evicts
        from the tree on a shortfall) and pick the tail's bucket. False:
        exhausted (or a ``reserve_fail`` fault), with every reference
        taken here dropped again."""
        if self._faults is not None and self._faults.fail_reserve(self,
                                                                  req):
            return False
        if self.prefix is None:
            return self.kv.try_reserve(req.slot, req.bucket,
                                       req.max_new_tokens,
                                       extra_cols=self._spec_k_max)
        shared, matched = self.prefix.acquire(req.prompt)
        need, _ = self._page_budget(req)
        if not self.kv.try_reserve_shared(req.slot, shared, need):
            self.kv.decref(shared)
            return False
        req.prefix_len = matched
        req.tail_bucket = self.scheduler.bucket_for(req.prompt_len - matched)
        self.metrics.note_prefix(matched)
        if matched:
            _tracing.async_instant("prefix.hit", req.aid, request_id=req.rid,
                                   hop=req.hop, matched=matched,
                                   pages=len(shared))
        return True

    def _reclaim(self, n_pages: int) -> int:
        """The pool's ``reclaim`` hook: evict from the prefix cache."""
        freed = self.prefix.evict(n_pages)
        self.metrics.prefix_evicted_pages += freed
        return freed

    def _admit(self, req: Request):
        """A whole prompt's admission: left-padded to its bucket and
        prefilled into the slot's row (slots) or reserved pages (paged);
        with the prefix cache, `_admit_prefix`."""
        queue_wait = time.perf_counter() - req.submit_time
        self.metrics.observe("h_queue_wait", queue_wait)
        req.timeline.mark(PHASE_ADMITTED, slot=req.slot,
                          engine=self.engine_id)
        _tracing.async_instant("slot.admission", req.aid, request_id=req.rid,
                               hop=req.hop, slot=req.slot, bucket=req.bucket,
                               queue_wait_s=round(queue_wait, 6),
                               replica=self.engine_id, stage=self.role)
        if self.prefix is not None:
            self._admit_prefix(req)
            return
        bucket, slot = req.bucket, req.slot
        pad = bucket - req.prompt_len
        ids = np.zeros((1, bucket), np.int32)
        ids[0, pad:] = req.prompt
        amask = np.zeros((1, bucket), np.int32)
        amask[0, pad:] = 1
        if self.kv_mode == "paged":
            row = dict(page_rows=self.kv.block_table[[slot]])
        else:
            row = dict(slot_idx=np.asarray([slot], np.int32))
        fn = self._prefill_fn(bucket)
        t0 = time.perf_counter()
        req.timeline.mark(PHASE_PREFILL, bucket=bucket)
        with _tracing.request_scope(req.rid, req.trace.trace_id), \
                _tracing.span("serving.prefill", slot=slot, bucket=bucket,
                              replica=self.engine_id, stage="prefill"), \
                self._dispatch("prefill", self.metrics.prefill_steps):
            l32 = fn(ids=ids, amask=amask, **row)
            tok = int(select_tokens(l32, [self._sampler(req)],
                                    self.top_k)[0])
        self.kv.occupy(slot, bucket, req.prompt_len)
        self._finish_admission(req, tok, time.perf_counter() - t0)

    def _admit_prefix(self, req: Request):
        """The prefix-cache admission (``engine.py:1632-1700``): the
        uncached tail, right-padded to its bucket, prefills through the
        page view, attending the mapped prefix pages; the layout is
        unpadded (prompt token ``i`` at column ``i``, pads 0). The
        prompt's complete pages enter the tree before the first token is
        emitted."""
        slot, lc, tb = req.slot, req.prefix_len, req.tail_bucket
        tail = req.prompt[lc:]
        ids = np.zeros((1, tb), np.int32)
        ids[0, :tail.shape[0]] = tail
        fn = self._cprefill_fn(tb)
        t0 = time.perf_counter()
        req.timeline.mark(PHASE_PREFILL, bucket=tb, cached_prefix=lc)
        with _tracing.request_scope(req.rid, req.trace.trace_id), \
                _tracing.span("serving.prefill", slot=slot, bucket=tb,
                              cached_prefix=lc, replica=self.engine_id,
                              stage="prefill"), \
                self._dispatch("prefill", self.metrics.prefill_steps):
            l32 = fn(ids=ids, tail_lens=[tail.shape[0]], col0=[lc],
                     page_rows=self.kv.block_table[[slot]])
            tok = int(select_tokens(l32, [self._sampler(req)],
                                    self.top_k)[0])
        self.kv.occupy(slot, req.prompt_len, req.prompt_len)
        self.prefix.insert(req.prompt, self.kv.slot_row_pages(slot))
        self._finish_admission(req, tok, time.perf_counter() - t0)

    def _finish_admission(self, req: Request, tok: int, dt: float,
                          chunked: bool = False):
        """Slot the prefilled request and emit its first token. ``dt``:
        the admission's seconds (a chunked one's whole chunk phase, its
        chunks already observed one by one)."""
        e = self._ewma_admit_s
        self._ewma_admit_s = dt if e is None else 0.7 * e + 0.3 * dt
        slot = req.slot
        self._slot_req[slot] = req
        self._tokens[slot] = tok
        req.state = DECODING
        req.timeline.mark(PHASE_DECODE, engine=self.engine_id)
        self.metrics.prefill_steps += 1
        if not chunked:
            self.metrics.observe("h_prefill", dt)
        self._emit(req, tok)
        self._profile("prefill", request_id=req.rid,
                      bucket=(self._chunk_tokens if chunked else req.bucket),
                      slot=slot, duration_s=dt, occupancy=self.kv.occupancy)

    def _begin_chunk(self, req: Request):
        """A chunked admission begins (``engine.py:1731-1760``; its pages
        are reserved): host bookkeeping only. The prompt takes the
        unpadded layout whether or not the prefix cache matched, so chunk
        ``i`` lands at columns ``[chunk_pos, chunk_pos + n)`` of the
        slot's own pages."""
        queue_wait = time.perf_counter() - req.submit_time
        self.metrics.observe("h_queue_wait", queue_wait)
        req.chunk_pos = req.prefix_len
        req.prefill_chunks = -(-(req.prompt_len - req.prefix_len)
                               // self._chunk_tokens)
        req.timeline.mark(PHASE_ADMITTED, slot=req.slot,
                          engine=self.engine_id)
        _tracing.async_instant("slot.admission", req.aid, request_id=req.rid,
                               hop=req.hop, slot=req.slot,
                               bucket=self._chunk_tokens,
                               queue_wait_s=round(queue_wait, 6),
                               chunks=req.prefill_chunks,
                               replica=self.engine_id, stage=self.role)
        # one prefill mark for the whole chunked phase
        req.timeline.mark(PHASE_PREFILL, bucket=self._chunk_tokens,
                          cached_prefix=req.prefix_len,
                          prefill_chunks=req.prefill_chunks)
        self._chunk_req = req
        self._chunk_t0 = time.perf_counter()
        self.metrics.set_chunk_active(True)

    def _chunk_step(self):
        """One mixed step (``engine.py:1762-1900``): the chunking
        request's next ``chunk_tokens`` prompt tokens and a decode step
        of every slot, in one captured step. The decode half gets a copy
        of the block table whose chunking row points at the sentinel
        page: the slot is reserved but not occupied (its cursor at 0),
        so its parked lane would otherwise write on the chunk's own first
        page. The final chunk's logits give the request's first token,
        drawn from its generator as a whole admission draws it."""
        req, ct = self._chunk_req, self._chunk_tokens
        slot, pos = req.slot, req.chunk_pos
        chunk = req.prompt[pos:pos + ct]
        n = int(chunk.shape[0])
        ids = np.zeros((1, ct), np.int32)
        ids[0, :n] = chunk
        view = self.kv.block_table.copy()
        view[slot, :] = self.kv.pool.sentinel
        piggyback = sum(r is not None for r in self._slot_req)
        fn = self._mixed_fn()
        t0 = time.perf_counter()
        with _tracing.request_scope(req.rid, req.trace.trace_id), \
                _tracing.span("serving.decode", slot=slot,
                              chunk=int(pos // ct), chunk_len=n,
                              active=piggyback, replica=self.engine_id,
                              stage="decode"), \
                self._dispatch("decode", self.metrics.decode_steps):
            c32, l32 = fn(ids=ids, tail_lens=[n], col0=[pos],
                          page_rows=self.kv.block_table[[slot]],
                          **self._step_operands(self._tokens[:, None], view))
            samplers = [self._sampler(r) for r in self._slot_req]
            out = select_tokens(l32[:, 0], samplers,
                                self.top_k).cpu().numpy()
        dt = time.perf_counter() - t0
        self.metrics.note_chunk_step(n, piggyback, self.slots)
        # each chunk prices the feasibility estimate's prefill waves
        self.metrics.observe("h_prefill", dt)
        if piggyback:
            self.metrics.decode_step_s.append(dt)
            self.metrics.observe("h_decode", dt)
            self.metrics.decode_steps += 1
        # no sink attached: the per-token events build nothing
        tok_evts = [] if _tracing.active() else None
        for s, r in enumerate(self._slot_req):
            if r is None:
                continue
            self.kv.advance(s)
            self._tokens[s] = out[s]
            if tok_evts is not None:
                tok_evts.append(_tracing.async_instant_evt(
                    "slot.decode_token", r.aid, request_id=r.rid,
                    hop=r.hop, slot=s, step=r.counter))
            self._emit(r, int(out[s]))
        if tok_evts:
            _tracing.emit_events(tok_evts)
        req.chunk_pos = pos + n
        final = req.chunk_pos >= req.prompt_len
        self._profile("chunk", request_id=req.rid, slot=slot, tokens=n,
                      piggyback=piggyback, duration_s=dt, final=final)
        if not final:
            return
        tok = int(select_tokens(c32, [self._sampler(req)], self.top_k)[0])
        self.kv.occupy(slot, req.prompt_len, req.prompt_len)
        if self.prefix is not None:
            self.prefix.insert(req.prompt, self.kv.slot_row_pages(slot))
        self._chunk_req = None
        self.metrics.set_chunk_active(False)
        self._finish_admission(req, tok, time.perf_counter() - self._chunk_t0,
                               chunked=True)

    def _abort_chunk(self, req: Request, error=None):
        """The chunking request is cancelled (``error`` None) or expired:
        return its slot and its whole page reservation (it was never
        slotted, so `_release` cannot) and close its handle."""
        self._chunk_req = None
        self.metrics.set_chunk_active(False)
        if req.slot is not None:
            self.kv.release(req.slot)
            self.scheduler.release(req.slot)
            req.slot = None
        req.state = CANCELLED
        req.handle._close(error)
        self._end_span(req)

    def _embed_one(self, ids: np.ndarray) -> np.ndarray:
        n = int(ids.shape[0])
        width = self._chunk_tokens or self.scheduler.bucket_for(n)
        while True:
            slot = self.scheduler.take_slot()
            if slot is not None:
                if self.kv.try_reserve_shared(
                        slot, [], pages_for(n, self.kv.page_size)):
                    break
                self.scheduler.release(slot)
            # every slot busy or the pool exhausted: step until a release
            if not self.step():
                raise ValueError(
                    f"embed({n} tokens) needs "
                    f"{pages_for(n, self.kv.page_size)} KV pages and a "
                    f"slot, but the idle engine's pool holds "
                    f"{self.kv.pages_total}")
        try:
            with torch.inference_mode():
                fn = self._embed_fn(width)
                for pos in range(0, n, width):
                    chunk = ids[pos:pos + width]
                    cids = np.zeros((1, width), np.int32)
                    cids[0, :chunk.shape[0]] = chunk
                    h = fn(ids=cids, tail_lens=[chunk.shape[0]], col0=[pos],
                           page_rows=self.kv.block_table[[slot]])
            self.metrics.embed_prompts += 1
            return h[0].cpu().numpy()
        finally:
            self.kv.release(slot)
            self.scheduler.release(slot)

    def _decode_once(self):
        """One decode step over all slots, active or parked (``engine.py:
        2252-2291``); with ``spec_k > 0`` a speculative verify step
        (:2293-2443): draft up to k tokens per slot on the host, score
        all ``k + 1`` lanes of every slot in one pass, accept the longest
        draft prefix (greedy: argmax agreement; sampled: modified
        rejection, `_accept_sampled`) and emit it plus one token of the
        target's own, one at a time through `_emit`, so an EOS inside
        the accepted window ends the request there. With ``spec_k = 0``
        it is the same step at one lane: no draft, one token a slot.
        Rollback is the cursor alone: a rejected lane's K/V lies past it,
        in the slot's own pages, until the next window overwrites it. The
        ``[S, W, V]`` probabilities stay on the device; only ``[S, W]``
        operands and the rows of rejected lanes come to the host.
        ``decode_step_s`` times the step from drafting to the accept
        decisions. An adaptive engine feeds each drafting slot's window
        to its controller and moves k after the step (`_set_spec_k`)."""
        t0 = time.perf_counter()
        fn = self._verify_fn()
        w = self._spec_k + 1
        toks = np.zeros((self.slots, w), np.int64)
        toks[:, 0] = self._tokens
        n_draft = np.zeros((self.slots,), np.int64)
        qs: list = [None] * self.slots
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            # never draft past the request's token budget
            kd = min(self._spec_k,
                     req.max_new_tokens - len(req.emitted) - 1)
            if kd <= 0:
                continue
            d, q = self._draft_for(req, kd)
            if len(d):
                toks[slot, 1:1 + len(d)] = d
                n_draft[slot] = len(d)
                qs[slot] = q
        samplers = [self._sampler(r) for r in self._slot_req]
        # the span only when something consumes it; the heartbeat inline
        # (`_dispatch`'s, without its generator on the step's path)
        span = (_tracing.span("serving.decode",
                              active=int(self.kv.occupancy),
                              replica=self.engine_id, stage="decode")
                if _tracing.active() else _NO_SPAN)
        self._hb_busy_since = time.monotonic()
        try:
            with span:
                self._fault("decode", self.metrics.decode_steps)
                l32 = fn(**self._step_operands(toks))
                tok, probs = select_tokens_window(l32, samplers, self.top_k,
                                                  n_draft.tolist())
                out = tok.cpu().numpy()
        finally:
            self._hb_busy_since = None
        self._hb_last_done = time.monotonic()
        emits = {}
        sampled = [s for s, smp in enumerate(samplers) if smp is not None]
        drafting = [j for j, s in enumerate(sampled) if n_draft[s]]
        if drafting:
            emits = self._accept_sampled(sampled, drafting, toks, n_draft,
                                         qs, out, probs)
        dt = time.perf_counter() - t0
        self.metrics.decode_step_s.append(dt)
        self.metrics.observe("h_decode", dt)
        self.metrics.decode_steps += 1
        # no sink attached: the per-token events build nothing
        tok_evts = [] if _tracing.active() else None
        n_active = n_tokens = 0
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            n_active += 1
            nd = int(n_draft[slot])
            if slot in emits:
                acc, emit = emits[slot]
            else:
                acc = longest_accept(toks[slot], out[slot], nd)
                emit = [int(out[slot, j]) for j in range(acc + 1)]
            if nd:
                mode = "greedy" if req.params.greedy else "sampled"
                self.metrics.note_spec(mode, nd, acc)
                if self._spec_ctrl is not None:
                    self._spec_ctrl.observe(nd, acc)
                if tok_evts is not None:
                    tok_evts.append(_tracing.async_instant_evt(
                        "spec.verify", req.aid, request_id=req.rid,
                        hop=req.hop, slot=slot, drafted=nd, accepted=acc,
                        mode=mode, replica=self.engine_id))
            for t in emit:
                self.kv.advance(slot)
                self._tokens[slot] = t
                n_tokens += 1
                if tok_evts is not None:
                    tok_evts.append(_tracing.async_instant_evt(
                        "slot.decode_token", req.aid, request_id=req.rid,
                        hop=req.hop, slot=slot, step=req.counter))
                self._emit(req, t)
                if req.done or self._slot_req[slot] is not req:
                    break           # EOS, budget or cancel inside the window
        if tok_evts:
            _tracing.emit_events(tok_evts)
        if self._profiler is not None:
            self._profiler("decode", dict(active=n_active, duration_s=dt,
                                          tokens=n_tokens))
        if self._spec_ctrl is not None:
            k = self._spec_ctrl.decide()
            if k != self._spec_k:
                self._set_spec_k(k)

    def _draft_for(self, req: Request, kd: int):
        """One slot's proposal -> ``(tokens [m <= kd], q)``. A greedy
        request takes the drafter's ``draft`` (argmax acceptance needs no
        q); a sampled one its ``draft_with_q`` proposal where it has one
        (the n-gram drafter), sampled with a generator seeded by the
        request's (seed, counter), so drafts reproduce per request, else
        ``draft``, whose tokens are scored as a point mass unless it
        returns ``(tokens, q)``."""
        ctx = np.concatenate([req.prompt, np.asarray(req.emitted, np.int64)])
        dr = self._drafter
        if not req.params.greedy and hasattr(dr, "draft_with_q"):
            out = dr.draft_with_q(ctx, kd, self._vocab,
                                  seed=self._spec_seed(req, 0))
        else:
            out = dr.draft(ctx, kd)
        return normalize_draft(out, kd)

    @staticmethod
    def _spec_seed(req: Request, tag: int):
        """Seed of one of a sampled request's host streams at its current
        step: tag 0 the drafts, 1 the accept uniforms, 2 the residual
        uniforms, each a function of (seed, counter) alone."""
        return (int(req.seed) % 2 ** 64, int(req.counter), tag)

    @staticmethod
    def _q_at(q, i: int, d: int) -> float:
        """The proposal probability of draft ``i``'s token ``d`` (q None:
        a point mass)."""
        if q is None:
            return 1.0
        if q.ndim == 1:
            return float(q[i])
        return float(q[i, d]) if d < q.shape[1] else 0.0

    def _accept_sampled(self, sampled, drafting, toks, n_draft, qs, out,
                        probs):
        """Modified rejection sampling over the sampled slots that drafted
        (``engine.py:2490-2552``; Chen et al. 2023, Leviathan et al.
        2023, Thm 1) -> ``{slot: (accepted, tokens to emit)}``.

        ``probs [len(sampled), W, V]`` are those slots' filtered softmax
        per lane; ``drafting`` indexes its rows. Lane ``j``'s draft ``d``
        is accepted when ``u * q(d) < p(d)``, ``p`` the previous lane's
        probability of ``d`` and ``u`` an accept uniform of the
        request's (seed, counter). With every draft accepted the bonus is
        the window's own draw at lane ``nd``, from the request's
        generator; at the first rejection it is sampled from the
        normalized residual ``max(0, p - q)`` of the rejected lane (its
        ``[V]`` row comes over in one gather with the other rejections')
        by inverse CDF on a residual uniform."""
        rows = torch.tensor(drafting, device=probs.device)
        lanes = [sampled[j] for j in drafting]
        nxt = self._dev(toks[lanes, 1:])                    # [n, W-1]
        p_tok = probs[rows, :-1].gather(2, nxt[..., None])[..., 0]
        p_tok = p_tok.double().cpu().numpy()                # [n, W-1]
        accs, u_res = {}, {}
        for i, slot in enumerate(lanes):
            req, nd = self._slot_req[slot], int(n_draft[slot])
            u_acc = np.random.default_rng(self._spec_seed(req, 1)).random(nd)
            acc = 0
            while acc < nd:
                qd = self._q_at(qs[slot], acc, int(toks[slot, acc + 1]))
                if u_acc[acc] * qd < p_tok[i, acc]:
                    acc += 1
                else:
                    break
            accs[slot] = acc
            if acc < nd:
                u_res[slot] = (i, np.random.default_rng(
                    self._spec_seed(req, 2)).random())
        resid = {}
        if u_res:
            need = list(u_res)
            ri = torch.tensor([drafting[u_res[s][0]] for s in need],
                              device=probs.device)
            pos = torch.tensor([accs[s] for s in need], device=probs.device)
            prow = probs[ri, pos].double().cpu().numpy()    # [n_rej, V]
            for r, slot in enumerate(need):
                resid[slot] = self._residual_token(
                    qs[slot], accs[slot], int(toks[slot, accs[slot] + 1]),
                    prow[r], u_res[slot][1])
        emits = {}
        for slot in lanes:
            acc, nd = accs[slot], int(n_draft[slot])
            emit = [int(t) for t in toks[slot, 1:acc + 1]]
            emit.append(int(out[slot, nd]) if acc == nd else resid[slot])
            emits[slot] = (acc, emit)
        return emits

    @staticmethod
    def _residual_token(q, pos: int, d: int, p, u: float) -> int:
        """The token after a rejection at draft ``pos`` (token ``d``):
        inverse CDF of the normalized residual ``max(0, p - q)`` at
        uniform ``u``. A dense ``q [m, V]`` subtracts the whole proposal;
        a point mass (q None) removes ``d``; a scalar ``q [m]`` only
        ``d``'s mass. A residual with no mass left (float noise where q
        covers p) samples ``p`` itself, still the target's
        distribution."""
        r = p.copy()
        if q is None:
            r[d] = 0.0
        elif q.ndim == 1:
            r[d] = max(0.0, r[d] - float(q[pos]))
        else:
            m = min(len(p), q.shape[1])
            r[:m] = np.maximum(p[:m] - q[pos, :m], 0.0)
        if float(r.sum()) <= 0.0:
            r = p
        c = np.cumsum(r)
        return int(min(np.searchsorted(c, u * c[-1], side="right"),
                       len(c) - 1))


    def _emit(self, req: Request, tok: int):
        """Deliver one token; finish on EOS, the budget or a cancel."""
        if req.state == CANCELLED or req.cancel_requested:
            req.state = CANCELLED
            self._release(req)
            return
        if self.slo is not None:
            # the SLO's inter-token gaps read these (no SLO: no reader)
            req.token_times.append(time.perf_counter())
        if req.first_token_time is None:
            req.first_token_time = time.perf_counter()
            ttft = req.first_token_time - req.submit_time
            self.metrics.ttft_s.append(ttft)
            self.metrics.observe("h_ttft", ttft)
        req.emitted.append(tok)
        req.counter += 1
        self.metrics.tokens_generated += 1
        req.handle._emit(tok)
        hit_eos = (req.eos_token_id is not None
                   and tok == int(req.eos_token_id))
        if hit_eos or len(req.emitted) >= req.max_new_tokens:
            req.state = FINISHED
            self.metrics.completed += 1
            self._release(req)

    def _release(self, req: Request, error: BaseException | None = None):
        """Free the request's slot and pages and close its handle (with
        ``error``, typed, when it failed)."""
        req.finish_time = time.perf_counter()
        slot = req.slot
        if slot is not None and self._slot_req[slot] is req:
            _tracing.async_instant("slot.eviction", req.aid,
                                   request_id=req.rid, hop=req.hop,
                                   slot=slot, tokens=len(req.emitted),
                                   replica=self.engine_id)
            self._slot_req[slot] = None
            self.kv.release(slot)
            self.scheduler.release(slot)
        self._end_span(req)
        req.handle._close(error)

    def _cancel(self, req: Request):
        req.cancel_requested = True
        with self._lock:
            if req.done:
                return
            self.metrics.cancelled += 1
            if req is self._chunk_req:
                # mid-chunk: still QUEUED, but holding a slot and its pages
                self._abort_chunk(req)
                return
            if req.state == QUEUED:
                self.scheduler.drop_queued(req)
                req.state = CANCELLED
                self._end_span(req)
                req.handle._close()
                return
            req.state = CANCELLED
            self._release(req)


__all__ = ["Engine", "EngineClosedError"]
