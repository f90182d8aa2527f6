"""The continuous-batching serving engine over dense slot caches or the
paged KV pool.

Counterpart: ``paddle_tpu/serving/engine.py`` (the mode choice and its
validations of :393-450, submit/step semantics of :757-927, stats of
:1160-1208, the page budget and prefix reservation of :1429-1535,
admission of :1536-1700, chunked prefill and `embed` of :1731-2024,
decode of :2252-2291, the speculative step of :2293-2552, emit/release
of :2647-2717). The port has the cooperative engine:

- `submit` queues a request and returns a `RequestHandle`;
- `step` admits queued requests FCFS into free slots (each prompt
  prefilled alone), then runs ONE decode step in which every slot,
  active or parked, rides; EOS or the token budget frees the slot at
  once.

``kv_mode`` picks the KV cache, as the reference does: ``"slots"`` (the
default without a paged feature) holds one dense ``[slots, H, max_len,
D]`` cache a layer (`kv_slots.SlotKVCache`): a prompt, left-padded to
its bucket, is written into the slot's row, and decode attends the whole
row, composed with float32 scores (the reference's slot step runs no
Pallas kernel either). ``"paged"`` (the default with ``prefix_cache``,
``chunk_tokens``, ``kv_quant`` or ``kv_pool_bytes``) holds a page pool
(`paged.PagedKVCache`): each slot reserves its whole page budget at
admission, a request that finds the pool exhausted stays queued at the
head until a release returns pages, and decode attends through the
block table (the Hopper paged-attention kernel on a card). Paged
features:

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
  lanes per slot: an n-gram drafter (`speculative.NgramDrafter`,
  suffix n-grams up to ``spec_ngram`` tokens) proposes up to ``k``
  tokens per slot on the host, one pass scores them all, and the
  longest accepted prefix plus one token of the target's own is
  emitted. Greedy requests accept by argmax agreement (token-identical
  to ``spec_k=0``); sampled ones by modified rejection sampling
  (distributed exactly as ``spec_k=0``). Every slot budgets ``k`` more
  columns (``bucket + max_new + k <= max_len``, and its pages).

Every step is a `jit.capture.CapturedStep` (`compiled`): one a prompt
bucket (dense or paged prefill), one a tail bucket (the prefix cache's
tail prefill), one a chunk width (`embed`), the decode/verify step, and
the mixed chunk step. On a card each is one CUDA graph, captured on
first use into the engine's one graph memory pool and then only
replayed; on the CPU the same body runs eagerly on the same static
buffers. Each build is counted (``stats().prefill_traces`` and
``decode_traces``; the mixed step registers in the decode family
without counting) and reported to the recompile sentinel under the
engine's own names (`metrics.EngineMetrics.note_trace`). Token
selection runs after the replay, eagerly. Arguments of features that
later slices bring raise `NotImplementedError` naming the feature.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..device import resolve_device
from ..jit.capture import graph_pool
from ..kernels import kernel_launch_counts
from ..kernels.paged_kv import pages_for
from ..models.generation import select_tokens, select_tokens_window
from .compiled import (build_cached_prefill_fn,
                       build_chunked_prefill_decode_fn,
                       build_embed_prefill_fn, build_paged_prefill_fn,
                       build_paged_verify_step_fn, build_prefill_fn,
                       build_verify_step_fn)
from .kv_slots import SlotKVCache
from .metrics import EngineMetrics
from .paged import PagedKVCache, pages_in_budget
from .prefix_cache import PrefixCache
from .request import (CANCELLED, DECODING, FINISHED, QUEUED, Request,
                      RequestHandle, SamplingParams)
from .scheduler import SlotScheduler
from .speculative import NgramDrafter, longest_accept, normalize_draft

#: the launch-count names of the paged kernel (float, int8, fp8 pools)
_PAGED_KERNELS = ("paged_attention", "paged_attention_int8",
                  "paged_attention_fp8")

#: Engine arguments of later slices: name -> (the value that means
#: "off", the ROADMAP queue-A feature that brings it)
_LATER = {
    "draft_model": (None, "A8 draft-model speculation"),
    "spec_adaptive": (False, "A8 adaptive spec_k"),
    "spec_k_max": (None, "A8 adaptive spec_k"),
    "mesh": (None, "A12 distributed serving"),
    "sharding_rule": (None, "A12 distributed serving"),
    "role": ("both", "A10 disaggregated serving"),
    "kv_pool": (None, "A10 disaggregated serving"),
    "engine_id": (None, "A10 serving fleet (replica identity)"),
    "fault_injector": (None, "A10 serving fleet (fault injection)"),
    "default_deadline_s": (None, "A8.6 deadlines and bounded admission"),
    "max_queue": (None, "A8.6 deadlines and bounded admission"),
    "shed_policy": ("refuse", "A8.6 deadlines and bounded admission"),
    "admission_retries": (64, "A8.6 deadlines and bounded admission"),
    "profiler": (None, "A9 observability (profiler)"),
    "observability_port": (None, "A9 observability (server endpoints)"),
    "flight_recorder": (None, "A9 observability (flight recorder)"),
    "slo": (None, "A9 observability (SLO tracking)"),
    "dtype": (None, "A2 scaffold (serving dtype)"),
}


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
    plain decode); ``spec_ngram``: the longest suffix n-gram the drafter
    matches. ``weight_quant="int8"``: weight-only int8 serving, the
    quantizer of `GenerationMixin.generate`
    (`models.generation.quantize_state_int8`, cached on the model);
    every step dequantizes the weights it runs on inside its graph, as
    the reference's step executable does. ``device``: ``None`` means
    ``cuda`` (raises without a GPU); it must be the model's device.
    """

    def __init__(self, model, slots=4, max_len=None, prefill_buckets=None,
                 page_size=16, kv_pages=None, top_k=0, seed=0, device=None,
                 kv_mode=None, kv_quant=None, spec_k=0, spec_ngram=3,
                 kv_pool_bytes=None, weight_quant=None, prefix_cache=False,
                 chunk_tokens=None, **later):
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
                                       kv_quant=kv_quant)
        #: the quantized weights of ``weight_quant`` (None: as they are)
        self._qweights = model.serving_weights(weight_quant)
        self.model = model.eval()
        self.slots = int(slots)
        self.top_k = int(top_k)
        self._seed = int(seed)
        #: verify lanes past the pending token (0 = plain decode)
        self.spec_k = int(spec_k)
        self._drafter = (NgramDrafter(max_ngram=int(spec_ngram))
                         if self.spec_k else None)
        self._vocab = int(model.config.vocab_size)
        if self.kv_mode == "paged":
            self.kv = PagedKVCache(model, self.slots, int(max_len),
                                   page_size=int(page_size), pages=kv_pages,
                                   kv_quant=kv_quant)
        else:
            self.kv = SlotKVCache(model, self.slots, int(max_len))
        buckets = (prefill_buckets if prefill_buckets is not None
                   else (max(1, int(max_len) // 2),))
        self.scheduler = SlotScheduler(self.slots, buckets, int(max_len),
                                       spec_cols=self.spec_k)
        self.metrics = EngineMetrics()
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
        self._tokens = np.zeros((self.slots,), np.int64)
        self._slot_req: list[Request | None] = [None] * self.slots
        self._next_rid = 0
        self._fatal: BaseException | None = None
        #: the graph memory pool of every step of this engine
        self._graphs = graph_pool(self.device)
        #: the steps, each built on first use: prefill by bucket, tail
        #: prefill by tail bucket, embed by chunk width, the decode/verify
        #: step, the mixed chunk step
        self._prefill_fns: dict = {}
        self._cprefill_fns: dict = {}
        self._embed_fns: dict = {}
        self._verify = None
        self._chunk_fn = None

    # -- client surface --------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
               decode_strategy="greedy_search", temperature=1.0,
               top_k=None, top_p=None, seed=None,
               deadline_s=None) -> RequestHandle:
        """Queue one request; returns its `RequestHandle`. Arguments are
        normalized as the reference's ``_prepare_request`` does
        (temperature 0 means greedy; ``top_k`` of a sampled request must
        equal the engine's). A sampled request draws from its own
        generator, seeded by ``seed`` (default: the engine seed and the
        request id), so it reproduces whatever shares its batch."""
        self._check_alive()
        if deadline_s is not None:
            raise _later("submit(deadline_s=...): A8 deadlines and "
                         "bounded admission")
        rid = self._next_rid
        self._next_rid += 1
        req = self._prepare(rid, prompt_ids, max_new_tokens, eos_token_id,
                            decode_strategy, temperature, top_k, top_p, seed)
        req.bucket = self.scheduler.validate(req)
        if self.kv_mode == "paged":
            # a budget beyond the whole pool could never admit
            need, span = self._page_budget(req)
            if need > self.kv.pages_total:
                spec = (f" + {self.spec_k} speculative verify lanes"
                        if self.spec_k else "")
                raise ValueError(
                    f"request needs {need} KV pages ({span} + "
                    f"{req.max_new_tokens} new tokens{spec} at page_size "
                    f"{self.kv.page_size}) but the pool holds "
                    f"{self.kv.pages_total} — raise kv_pages or lower "
                    "max_new_tokens")
        req.handle = RequestHandle(self, req)
        self.scheduler.enqueue(req)
        self.metrics.submitted += 1
        return req.handle

    def _prepare(self, rid, prompt_ids, max_new_tokens, eos_token_id,
                 decode_strategy, temperature, top_k, top_p, seed):
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
        if not params.greedy:
            s = int(seed) if seed is not None else self._seed * 1_000_003 + rid
            req.seed = s
            req.generator = torch.Generator(device=self.device).manual_seed(s)
        return req

    def step(self) -> bool:
        """One engine iteration: admit queued requests into free slots,
        then one decode step over all slots (while a prompt is mid-chunk,
        the mixed step: its next chunk and the decode step together).
        False when fully idle."""
        self._check_alive()
        try:
            with torch.inference_mode():
                did = False
                while self._chunk_req is None:
                    # one chunking request at a time, and nothing behind
                    # it admits until it has its slot (FCFS)
                    req = self.scheduler.next_admission()
                    if req is None:
                        break
                    if self.kv_mode == "paged" and not self._reserve(req):
                        # pool exhausted: back to the queue head until a
                        # release returns pages (no neighbour is touched)
                        self.metrics.kv_pages_exhausted += 1
                        self.scheduler.requeue_admission(req)
                        break
                    did = True
                    if (self._chunk_tokens is not None
                            and req.prompt_len - req.prefix_len
                            > self._chunk_tokens):
                        self._begin_chunk(req)
                        break
                    self._admit(req)
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

    def start(self):
        raise _later("Engine.start() (a background step thread): A8 "
                     "background serving")

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
            out.append(self._embed_one(ids.astype(np.int64)))
        return out

    def stats(self):
        """`metrics.EngineStats` snapshot; the pool's page fields only in
        paged mode (``engine.py:1160-1208``)."""
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
        return self.metrics.snapshot(
            kv_mode=self.kv_mode,
            queue_depth=self.scheduler.queue_depth,
            active_slots=self.kv.occupancy,
            free_slots=self.scheduler.free_slots,
            kv_cache_bytes=self.kv.memory_bytes(),
            spec_k=self.spec_k,
            chunk_tokens=self._chunk_tokens or 0,
            capture_s=sum(fn.capture_s for fn in self._steps()),
            paged_attention_launches=sum(counts[k] for k in _PAGED_KERNELS),
            **paged)

    def _steps(self):
        """Every step this engine built so far."""
        return [*self._prefill_fns.values(), *self._cprefill_fns.values(),
                *self._embed_fns.values(),
                *(fn for fn in (self._verify, self._chunk_fn)
                  if fn is not None)]

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
        """The decode (W = 1) or verify (W = spec_k + 1) step (built on
        first use)."""
        if self._verify is None:
            kw = self._pool_kw(kind="decode")
            self._verify = (
                build_paged_verify_step_fn(
                    self.model, self.slots, self.spec_k + 1,
                    self.kv.max_pages, self.kv.page_size, **kw)
                if self.kv_mode == "paged"
                else build_verify_step_fn(self.model, self.slots,
                                          self.spec_k + 1, self.kv.max_len,
                                          **kw))
        return self._verify

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
            raise RuntimeError("the serving engine died on a step failure; "
                               "build a new Engine") from self._fatal

    def _die(self, exc: BaseException):
        """Fail every queued, chunking and in-flight request with the
        cause."""
        self._fatal = exc
        for req in (self.scheduler.queued_requests() + tuple(self._slot_req)
                    + (self._chunk_req,)):
            if req is not None and not req.done:
                req.state = CANCELLED
                req.handle._close(exc)

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
        columns; both budget the ``spec_k`` verify lanes."""
        if self.prefix is not None:
            return (pages_for(req.prompt_len
                              + max(0, req.max_new_tokens - 1)
                              + self.spec_k, self.kv.page_size),
                    f"prompt {req.prompt_len}")
        return (self.kv.pages_needed(req.bucket, req.max_new_tokens,
                                     extra_cols=self.spec_k),
                f"bucket {req.bucket}")

    def _reserve(self, req: Request) -> bool:
        """The page reservation of a popped request (``engine.py:
        1500-1535``). With the prefix cache: match the prompt, map the
        cached pages read-only, reserve the private rest (the pool evicts
        from the tree on a shortfall) and pick the tail's bucket. False:
        exhausted, with every reference taken here dropped again."""
        if self.prefix is None:
            return self.kv.try_reserve(req.slot, req.bucket,
                                       req.max_new_tokens,
                                       extra_cols=self.spec_k)
        shared, matched = self.prefix.acquire(req.prompt)
        need, _ = self._page_budget(req)
        if not self.kv.try_reserve_shared(req.slot, shared, need):
            self.kv.decref(shared)
            return False
        req.prefix_len = matched
        req.tail_bucket = self.scheduler.bucket_for(req.prompt_len - matched)
        self.metrics.note_prefix(matched)
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
        l32 = self._prefill_fn(bucket)(ids=ids, amask=amask, **row)
        tok = int(select_tokens(l32, [self._sampler(req)], self.top_k)[0])
        self.kv.occupy(slot, bucket, req.prompt_len)
        self._finish_admission(req, tok)

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
        l32 = self._cprefill_fn(tb)(
            ids=ids, tail_lens=[tail.shape[0]], col0=[lc],
            page_rows=self.kv.block_table[[slot]])
        tok = int(select_tokens(l32, [self._sampler(req)], self.top_k)[0])
        self.kv.occupy(slot, req.prompt_len, req.prompt_len)
        self.prefix.insert(req.prompt, self.kv.slot_row_pages(slot))
        self._finish_admission(req, tok)

    def _finish_admission(self, req: Request, tok: int):
        """Slot the prefilled request and emit its first token."""
        slot = req.slot
        self._slot_req[slot] = req
        self._tokens[slot] = tok
        req.state = DECODING
        self.metrics.prefill_steps += 1
        self._emit(req, tok)

    def _begin_chunk(self, req: Request):
        """A chunked admission begins (``engine.py:1731-1760``; its pages
        are reserved): host bookkeeping only. The prompt takes the
        unpadded layout whether or not the prefix cache matched, so chunk
        ``i`` lands at columns ``[chunk_pos, chunk_pos + n)`` of the
        slot's own pages."""
        req.chunk_pos = req.prefix_len
        req.prefill_chunks = -(-(req.prompt_len - req.prefix_len)
                               // self._chunk_tokens)
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
        t0 = time.perf_counter()
        c32, l32 = self._mixed_fn()(
            ids=ids, tail_lens=[n], col0=[pos],
            page_rows=self.kv.block_table[[slot]],
            **self._step_operands(self._tokens[:, None], view))
        samplers = [self._sampler(r) for r in self._slot_req]
        out = select_tokens(l32[:, 0], samplers, self.top_k).cpu().numpy()
        self.metrics.note_chunk_step()
        if piggyback:
            self.metrics.decode_step_s.append(time.perf_counter() - t0)
            self.metrics.decode_steps += 1
        for s, r in enumerate(self._slot_req):
            if r is None:
                continue
            self.kv.advance(s)
            self._tokens[s] = out[s]
            self._emit(r, int(out[s]))
        req.chunk_pos = pos + n
        if req.chunk_pos < req.prompt_len:
            return
        tok = int(select_tokens(c32, [self._sampler(req)], self.top_k)[0])
        self.kv.occupy(slot, req.prompt_len, req.prompt_len)
        if self.prefix is not None:
            self.prefix.insert(req.prompt, self.kv.slot_row_pages(slot))
        self._chunk_req = None
        self.metrics.set_chunk_active(False)
        self._finish_admission(req, tok)

    def _abort_chunk(self, req: Request):
        """The chunking request is cancelled: return its slot and its
        whole page reservation (it was never slotted, so `_release`
        cannot) and close its handle."""
        self._chunk_req = None
        self.metrics.set_chunk_active(False)
        self.kv.release(req.slot)
        self.scheduler.release(req.slot)
        req.slot = None
        req.state = CANCELLED
        req.handle._close()

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
        decisions."""
        t0 = time.perf_counter()
        w = self.spec_k + 1
        toks = np.zeros((self.slots, w), np.int64)
        toks[:, 0] = self._tokens
        n_draft = np.zeros((self.slots,), np.int64)
        qs: list = [None] * self.slots
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            # never draft past the request's token budget
            kd = min(self.spec_k, req.max_new_tokens - len(req.emitted) - 1)
            if kd <= 0:
                continue
            d, q = self._draft_for(req, kd)
            if len(d):
                toks[slot, 1:1 + len(d)] = d
                n_draft[slot] = len(d)
                qs[slot] = q
        samplers = [self._sampler(r) for r in self._slot_req]
        l32 = self._verify_fn()(**self._step_operands(toks))
        tok, probs = select_tokens_window(l32, samplers, self.top_k,
                                          n_draft.tolist())
        out = tok.cpu().numpy()
        emits = {}
        sampled = [s for s, smp in enumerate(samplers) if smp is not None]
        drafting = [j for j, s in enumerate(sampled) if n_draft[s]]
        if drafting:
            emits = self._accept_sampled(sampled, drafting, toks, n_draft,
                                         qs, out, probs)
        self.metrics.decode_step_s.append(time.perf_counter() - t0)
        self.metrics.decode_steps += 1
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            nd = int(n_draft[slot])
            if slot in emits:
                acc, emit = emits[slot]
            else:
                acc = longest_accept(toks[slot], out[slot], nd)
                emit = [int(out[slot, j]) for j in range(acc + 1)]
            if nd:
                self.metrics.note_spec(
                    "greedy" if req.params.greedy else "sampled", nd, acc)
            for t in emit:
                self.kv.advance(slot)
                self._tokens[slot] = t
                self._emit(req, t)
                if req.done or self._slot_req[slot] is not req:
                    break           # EOS, budget or cancel inside the window

    def _draft_for(self, req: Request, kd: int):
        """One slot's proposal -> ``(tokens [m <= kd], q)``. A greedy
        request takes the drafter's most recent continuation (argmax
        acceptance needs no q); a sampled one its `draft_with_q`
        proposal, sampled with a generator seeded by the request's
        (seed, counter), so drafts reproduce per request."""
        ctx = np.concatenate([req.prompt, np.asarray(req.emitted, np.int64)])
        if req.params.greedy:
            out = self._drafter.draft(ctx, kd)
        else:
            out = self._drafter.draft_with_q(ctx, kd, self._vocab,
                                             seed=self._spec_seed(req, 0))
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
        if not req.emitted:
            self.metrics.ttft_s.append(time.perf_counter() - req.submit_time)
        req.emitted.append(tok)
        req.counter += 1
        self.metrics.tokens_generated += 1
        hit_eos = (req.eos_token_id is not None
                   and tok == int(req.eos_token_id))
        if hit_eos or len(req.emitted) >= req.max_new_tokens:
            req.state = FINISHED
            self.metrics.completed += 1
            self._release(req)

    def _release(self, req: Request):
        slot = req.slot
        if slot is not None and self._slot_req[slot] is req:
            self._slot_req[slot] = None
            self.kv.release(slot)
            self.scheduler.release(slot)
        req.handle._close()

    def _cancel(self, req: Request):
        req.cancel_requested = True
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
            req.handle._close()
            return
        req.state = CANCELLED
        self._release(req)


__all__ = ["Engine"]
