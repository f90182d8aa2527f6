"""The continuous-batching serving engine over the paged KV pool.

Counterpart: ``paddle_tpu/serving/engine.py`` (``Engine(kv_mode="paged")``;
submit/step semantics of :757-927, admission of :1536-1630, decode of
:2252-2291, emit/release of :2647-2717). This slice ports the
cooperative paged engine:

- `submit` queues a request and returns a `RequestHandle`;
- `step` admits queued requests FCFS into free slots — each prompt is
  left-padded to its bucket, prefilled alone, and scattered into the
  slot's reserved pages — then runs ONE decode step in which every slot,
  active or parked, rides (parked slots write to the sentinel page);
- a request that finds the pool exhausted stays queued at the head
  until a release returns pages; EOS or the token budget frees the slot
  and its pages at once.

On a card the decode step's attention is the Hopper paged-attention
kernel (`kernels.paged_attention`); on the CPU its plain version.
Arguments of features that later slices bring raise
`NotImplementedError` naming the feature.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import kernel_launch_counts
from .compiled import paged_decode_step, paged_prefill_step
from .metrics import EngineMetrics
from .paged import PagedKVCache
from .request import (CANCELLED, DECODING, FINISHED, QUEUED, Request,
                      RequestHandle, SamplingParams)
from .scheduler import SlotScheduler

#: Engine arguments of later slices: name -> (the value that means
#: "off", the ROADMAP queue-A feature that brings it)
_LATER = {
    "prefix_cache": (False, "A8 prefix cache"),
    "spec_k": (0, "A8 speculative decoding"),
    "chunk_tokens": (None, "A8 chunked prefill"),
    "kv_quant": (None, "A8 quantized KV pages (with kernel B3 int8/fp8)"),
    "weight_quant": (None, "A7 int8 weight quantization"),
    "mesh": (None, "A12 distributed serving"),
    "role": ("both", "A10 disaggregated serving"),
    "kv_pool": (None, "A10 disaggregated serving"),
    "default_deadline_s": (None, "A8 deadlines and bounded admission"),
    "max_queue": (None, "A8 deadlines and bounded admission"),
}


def _later(feature: str):
    return NotImplementedError(
        f"{feature} comes with a later slice of the port (ROADMAP queue A)")


class Engine:
    """Cooperative continuous-batching engine over a paged KV pool.

    ``model``: a `models.gpt.GPTForPretraining`. ``slots``: concurrent
    sequences. ``max_len``: per-slot logical length — every request
    needs ``bucket(prompt) + max_new_tokens <= max_len``.
    ``prefill_buckets``: prompt pad lengths (default ``(max_len // 2,)``).
    ``page_size`` / ``kv_pages``: the pool (default ``slots *
    ceil(max_len / page_size)`` pages, the dense-equivalent size).
    ``top_k``: top-k of every sampled request (0 = off). ``seed``:
    seeds the generator of a sampled request submitted without one.
    ``device``: ``None`` means ``cuda`` (raises without a GPU); it must
    be the model's device.
    """

    def __init__(self, model, slots=4, max_len=None, prefill_buckets=None,
                 page_size=16, kv_pages=None, top_k=0, seed=0, device=None,
                 kv_mode="paged", **later):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"Engine() got an unexpected argument "
                                f"{name!r}")
            off, feature = _LATER[name]
            if value != off:
                raise _later(f"Engine({name}=...): {feature}")
        if kv_mode != "paged":
            raise _later(f"Engine(kv_mode={kv_mode!r}): A8 dense slot "
                         "cache")
        if max_len is None:
            raise ValueError(
                "max_len is required: per-slot KV length "
                "(bucket(prompt) + max_new_tokens must fit in it)")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {self.device}: move one of them")
        self.model = model.eval()
        self.slots = int(slots)
        self.top_k = int(top_k)
        self._seed = int(seed)
        self.kv = PagedKVCache(model, self.slots, int(max_len),
                               page_size=int(page_size), pages=kv_pages)
        buckets = (prefill_buckets if prefill_buckets is not None
                   else (max(1, int(max_len) // 2),))
        self.scheduler = SlotScheduler(self.slots, buckets, int(max_len))
        self.metrics = EngineMetrics()
        self._tokens = np.zeros((self.slots,), np.int64)
        self._slot_req: list[Request | None] = [None] * self.slots
        self._next_rid = 0
        self._fatal: BaseException | None = None

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
        bucket = self.scheduler.validate(req)
        need = self.kv.pages_needed(bucket, req.max_new_tokens)
        if need > self.kv.pages_total:
            raise ValueError(
                f"request needs {need} KV pages (bucket {bucket} + "
                f"{req.max_new_tokens} new tokens at page_size "
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
            req.generator = torch.Generator(device=self.device).manual_seed(s)
        return req

    def step(self) -> bool:
        """One engine iteration: admit queued requests into free slots,
        then one decode step over all slots. False when fully idle."""
        self._check_alive()
        try:
            with torch.inference_mode():
                did = False
                while True:
                    req = self.scheduler.next_admission()
                    if req is None:
                        break
                    if not self.kv.try_reserve(req.slot, req.bucket,
                                               req.max_new_tokens):
                        # pool exhausted: back to the queue head until a
                        # release returns pages (no neighbour is touched)
                        self.metrics.kv_pages_exhausted += 1
                        self.scheduler.requeue_admission(req)
                        break
                    self._admit(req)
                    did = True
                if self.kv.active.any():
                    self._decode_once()
                    did = True
                return did
        except BaseException as exc:
            # the pools may be half written: the engine cannot go on
            self._die(exc)
            raise

    def start(self):
        raise _later("Engine.start() (a background step thread): A8 "
                     "background serving")

    def stats(self):
        """`metrics.EngineStats` snapshot."""
        return self.metrics.snapshot(
            queue_depth=self.scheduler.queue_depth,
            active_slots=self.kv.occupancy,
            kv_page_size=self.kv.page_size,
            kv_pages_total=self.kv.pages_total,
            kv_pages_in_use=self.kv.pages_in_use,
            kv_pages_free=self.kv.pages_free,
            kv_slot_pages=self.kv.slot_page_counts(),
            paged_attention_launches=kernel_launch_counts()[
                "paged_attention"])

    # -- internals -------------------------------------------------------
    def _check_alive(self):
        if self._fatal is not None:
            raise RuntimeError("the serving engine died on a step failure; "
                               "build a new Engine") from self._fatal

    def _die(self, exc: BaseException):
        """Fail every queued and in-flight request with the cause."""
        self._fatal = exc
        for req in self.scheduler.queued_requests() + tuple(self._slot_req):
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

    def _admit(self, req: Request):
        bucket, slot = req.bucket, req.slot
        pad = bucket - req.prompt_len
        ids = np.zeros((1, bucket), np.int64)
        ids[0, pad:] = req.prompt
        amask = np.zeros((1, bucket), np.int32)
        amask[0, pad:] = 1
        tok = paged_prefill_step(
            self.model, self.kv.caches, self._dev(ids), self._dev(amask),
            self._dev(self.kv.block_table[[slot]]), self.kv.page_size,
            [self._sampler(req)], self.top_k)
        tok = int(tok[0])
        self.kv.occupy(slot, bucket, req.prompt_len)
        self._slot_req[slot] = req
        self._tokens[slot] = tok
        req.state = DECODING
        self.metrics.prefill_steps += 1
        self._emit(req, tok)

    def _decode_once(self):
        samplers = [self._sampler(r) for r in self._slot_req]
        t0 = time.perf_counter()
        tok = paged_decode_step(
            self.model, self.kv.caches, self._dev(self._tokens),
            self._dev(self.kv.steps), self._dev(self.kv.pads),
            self._dev(self.kv.valid_cols), self._dev(self.kv.block_table),
            samplers, self.top_k).cpu().numpy()
        self.metrics.decode_step_s.append(time.perf_counter() - t0)
        self.metrics.decode_steps += 1
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self.kv.advance(slot)
            self._tokens[slot] = tok[slot]
            self._emit(req, int(tok[slot]))

    def _emit(self, req: Request, tok: int):
        """Deliver one token; finish on EOS, the budget or a cancel."""
        if req.state == CANCELLED or req.cancel_requested:
            req.state = CANCELLED
            self._release(req)
            return
        if not req.emitted:
            self.metrics.ttft_s.append(time.perf_counter() - req.submit_time)
        req.emitted.append(tok)
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
        if req.state == QUEUED:
            self.scheduler.drop_queued(req)
            req.state = CANCELLED
            req.handle._close()
            return
        req.state = CANCELLED
        self._release(req)


__all__ = ["Engine"]
