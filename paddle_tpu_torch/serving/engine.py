"""The continuous-batching serving engine over the paged KV pool.

Counterpart: ``paddle_tpu/serving/engine.py`` (``Engine(kv_mode="paged")``;
submit/step semantics of :757-927, the page budget of :1429-1530,
admission of :1536-1630, decode of :2252-2291, the speculative step of
:2293-2552, emit/release of :2647-2717). The port has the cooperative
paged engine:

- `submit` queues a request and returns a `RequestHandle`;
- `step` admits queued requests FCFS into free slots — each prompt is
  left-padded to its bucket, prefilled alone, and scattered into the
  slot's reserved pages — then runs ONE decode step in which every slot,
  active or parked, rides (parked slots write to the sentinel page);
- a request that finds the pool exhausted stays queued at the head
  until a release returns pages; EOS or the token budget frees the slot
  and its pages at once;
- ``kv_quant="int8"`` or ``"fp8"`` stores the pool as 1-byte pages with
  per-token f32 scales: prefill attends its float local cache and
  quantizes into the pages, every decode or verify write quantizes, and
  the attention kernel dequantizes;
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

On a card the attention of every decode and verify step is the Hopper
paged-attention kernel (`kernels.paged_attention`, at ``W = 1`` or ``k
+ 1`` queries per slot, reading float or 1-byte pages); on the CPU its
plain version. Every prefill step (one per prompt bucket) and the
decode/verify step (one for the engine's ``W``) is a
`jit.capture.CapturedStep` (`compiled.build_paged_prefill_fn`,
`compiled.build_paged_verify_step_fn`): on a card one CUDA graph each,
captured on first use into the engine's one graph memory pool and then
only replayed; on the CPU the same body runs eagerly on the same static
buffers. Each build is counted (``stats().prefill_traces`` and
``decode_traces``) and reported to the recompile sentinel under the
engine's own names (`metrics.EngineMetrics.note_trace`). Token selection
runs after the replay, eagerly. Arguments of features that later slices
bring raise `NotImplementedError` naming the feature.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..device import resolve_device
from ..jit.capture import graph_pool
from ..kernels import kernel_launch_counts
from ..models.generation import select_tokens, select_tokens_window
from .compiled import build_paged_prefill_fn, build_paged_verify_step_fn
from .metrics import EngineMetrics
from .paged import PagedKVCache, pages_in_budget
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
    "prefix_cache": (False, "A8 prefix cache"),
    "draft_model": (None, "A8 draft-model speculation"),
    "spec_adaptive": (False, "A8 adaptive spec_k"),
    "spec_k_max": (None, "A8 adaptive spec_k"),
    "chunk_tokens": (None, "A8 chunked prefill"),
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
    ``kv_quant``: None, ``"int8"`` or ``"fp8"`` (1-byte pages with f32
    scales). ``kv_pool_bytes``: size the pool by a byte budget instead
    of ``kv_pages`` (`paged.pages_in_budget`, ``engine.py:414-430``).
    ``spec_k``: draft tokens per verify step (0 = plain decode);
    ``spec_ngram``: the longest suffix n-gram the drafter matches.
    ``weight_quant="int8"``: weight-only int8 serving, the quantizer of
    `GenerationMixin.generate` (`models.generation.quantize_state_int8`,
    cached on the model); every prefill and decode step dequantizes the
    weights it runs on inside its graph, as the reference's step
    executable does. ``kv_mode``: None or
    ``"paged"``, the one mode the port has (the reference's None picks
    slots without a paged feature: ROADMAP A8.2). ``device``: ``None``
    means ``cuda`` (raises without a GPU); it must be the model's
    device.
    """

    def __init__(self, model, slots=4, max_len=None, prefill_buckets=None,
                 page_size=16, kv_pages=None, top_k=0, seed=0, device=None,
                 kv_mode=None, kv_quant=None, spec_k=0, spec_ngram=3,
                 kv_pool_bytes=None, weight_quant=None, **later):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"Engine() got an unexpected argument "
                                f"{name!r}")
            off, feature = _LATER[name]
            if value != off:
                raise _later(f"Engine({name}=...): {feature}")
        if kv_mode not in (None, "paged"):
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
        if int(spec_k) < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if kv_pool_bytes is not None:
            if kv_pages is not None:
                raise ValueError(
                    "pass kv_pages or kv_pool_bytes, not both: "
                    "kv_pool_bytes derives the page count from the byte "
                    "budget")
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
        self.kv = PagedKVCache(model, self.slots, int(max_len),
                               page_size=int(page_size), pages=kv_pages,
                               kv_quant=kv_quant)
        buckets = (prefill_buckets if prefill_buckets is not None
                   else (max(1, int(max_len) // 2),))
        self.scheduler = SlotScheduler(self.slots, buckets, int(max_len),
                                       spec_cols=self.spec_k)
        self.metrics = EngineMetrics()
        self._tokens = np.zeros((self.slots,), np.int64)
        self._slot_req: list[Request | None] = [None] * self.slots
        self._next_rid = 0
        self._fatal: BaseException | None = None
        #: the graph memory pool of every step of this engine
        self._graphs = graph_pool(self.device)
        #: bucket -> its prefill step; the decode/verify step (built on
        #: first use)
        self._prefill_fns: dict = {}
        self._verify = None

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
        need = self.kv.pages_needed(bucket, req.max_new_tokens,
                                    extra_cols=self.spec_k)
        if need > self.kv.pages_total:
            spec = (f" + {self.spec_k} speculative verify lanes"
                    if self.spec_k else "")
            raise ValueError(
                f"request needs {need} KV pages (bucket {bucket} + "
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
                                               req.max_new_tokens,
                                               extra_cols=self.spec_k):
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
        counts = kernel_launch_counts()
        return self.metrics.snapshot(
            queue_depth=self.scheduler.queue_depth,
            active_slots=self.kv.occupancy,
            kv_page_size=self.kv.page_size,
            kv_pages_total=self.kv.pages_total,
            kv_pages_in_use=self.kv.pages_in_use,
            kv_pages_free=self.kv.pages_free,
            kv_slot_pages=self.kv.slot_page_counts(),
            kv_quant=self.kv.kv_quant,
            kv_pool_bytes=self.kv.memory_bytes(),
            kv_bytes_per_token=self.kv.bytes_per_page() / self.kv.page_size,
            spec_k=self.spec_k,
            capture_s=sum(fn.capture_s for fn in self._steps()),
            paged_attention_launches=sum(counts[k] for k in _PAGED_KERNELS))

    def _steps(self):
        """Every step this engine built so far."""
        return [*self._prefill_fns.values(),
                *([self._verify] if self._verify is not None else [])]

    def _prefill_fn(self, bucket: int):
        """The prefill step of ``bucket`` (built on first use)."""
        fn = self._prefill_fns.get(bucket)
        if fn is None:
            tag = f"b{bucket}"
            fn = self._prefill_fns[bucket] = build_paged_prefill_fn(
                self.model, 1, bucket, self.kv.page_size,
                pools=self.kv.caches, max_pages=self.kv.max_pages,
                scales=self.kv.scales, weights=self._qweights,
                on_trace=functools.partial(self.metrics.note_trace, tag=tag),
                pool=self._graphs,
                name=self.metrics.step_name("prefill", tag))
        return fn

    def _verify_fn(self):
        """The decode (W = 1) or verify (W = spec_k + 1) step (built on
        first use)."""
        if self._verify is None:
            self._verify = build_paged_verify_step_fn(
                self.model, self.slots, self.spec_k + 1, self.kv.max_pages,
                self.kv.page_size, pools=self.kv.caches,
                scales=self.kv.scales, weights=self._qweights,
                on_trace=self.metrics.note_trace, pool=self._graphs,
                name=self.metrics.step_name("decode"))
        return self._verify

    def _step_operands(self, tokens: np.ndarray) -> dict:
        """The verify step's operands: ``tokens [S, W]`` and the pool's
        host-side slot state, as they stand."""
        return dict(tokens=tokens, steps=self.kv.steps, pads=self.kv.pads,
                    valid_cols=self.kv.valid_cols,
                    block_table=self.kv.block_table)

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
        ids = np.zeros((1, bucket), np.int32)
        ids[0, pad:] = req.prompt
        amask = np.zeros((1, bucket), np.int32)
        amask[0, pad:] = 1
        l32 = self._prefill_fn(bucket)(
            ids=ids, amask=amask, page_rows=self.kv.block_table[[slot]])
        tok = int(select_tokens(l32, [self._sampler(req)], self.top_k)[0])
        self.kv.occupy(slot, bucket, req.prompt_len)
        self._slot_req[slot] = req
        self._tokens[slot] = tok
        req.state = DECODING
        self.metrics.prefill_steps += 1
        self._emit(req, tok)

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
        if req.state == QUEUED:
            self.scheduler.drop_queued(req)
            req.state = CANCELLED
            req.handle._close()
            return
        req.state = CANCELLED
        self._release(req)


__all__ = ["Engine"]
