"""Generation: `GenerationMixin.generate` (greedy, sampling and beam
search over a static or paged KV cache, weight-only int8) and the token
selection of the serving step.

Counterparts: ``paddle_tpu/models/generation.py`` (the filters :32-67,
`sample_token` and the int8 quantizer :57-179, `GenerationMixin`
:182-1191) and ``paddle_tpu/serving/compiled.py:69-166`` (per-slot
selection, and its speculative window form `_select_tokens_window` with
the lane-wise probabilities of `_verify_probs_window`). The filters keep
the reference's value-threshold semantics (tokens tying the threshold
all survive).

The reference compiles a whole generation into one XLA program and
caches 32 of them by shape (:386-417). Here `generate` is a host loop:
the prompt pass runs once a call, eagerly; each decode step (the model
forward to float32 logits) is one replay of a `jit.capture.CapturedStep`
(on a card a CUDA graph, captured on the first call at its shape, into
one graph memory pool per model), over static caches and page pools that
the step owns. The built loops are cached on the model in an LRU of 32,
keyed as the reference keys its programs (and by the weights' storage),
so a second call at one shape replays without a capture. Unlike the
reference's cache of executables, a built loop holds device memory (its
caches, pools and, with int8 weights, its dequantized weights), so the
cache also keeps at most `GENERATE_CACHE_BYTES` of them, the loop used
last always kept. Token
selection, the beam frontier, the gather beam's reorder and the paged
beam's block-table reorder and copy-on-write run eagerly between
replays. The EOS early exit reads one flag from the device a step.
Random draws come from an explicit `torch.Generator` (per request in
the engine, per call here, seeded from ``seed``); they are not JAX's
PRNG streams, so sampled tokens match the reference in distribution
only. Greedy and beam tokens match it token for token.
"""
from __future__ import annotations

import collections
import contextlib
import itertools

import numpy as np
import torch

from ..core.random import current_generator
from ..jit.capture import CapturedStep, graph_pool
from ..kernels.paged_kv import copy_pages
from ..observability.sentinel import get_sentinel

#: built generate loops kept per model (``generation.py:386-417``)
GENERATE_CACHE_SIZE = 32
#: device bytes the built loops of one model may hold together (their
#: static caches, page pools, step buffers and dequantized weights); the
#: loop used last is kept whatever its size
GENERATE_CACHE_BYTES = 8 << 30
#: default model names in generate's step names, in first-use order
_model_ids = itertools.count()


def filter_top_k(logits, k: int):
    """Keep the ``k`` largest logits per row (k clamped to the vocab)."""
    kth = torch.topk(logits, min(int(k), logits.shape[-1]), dim=-1)[0][
        ..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def filter_top_p(logits, p):
    """Nucleus filtering: keep the smallest set of tokens whose
    cumulative probability reaches ``p`` (the first always survives).
    ``p`` is a float or a tensor broadcastable to ``[..., 1]``."""
    sort = torch.sort(logits, dim=-1, descending=True)[0]
    probs = torch.softmax(sort, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    thr = torch.where(keep, sort, torch.full_like(sort, float("inf"))).amin(
        dim=-1, keepdim=True)
    return logits.masked_fill(logits < thr, float("-inf"))


def _sampled_probs(l32, samplers, top_k):
    """``(rows, probs)``: the sampled rows of ``l32 [S, ..., V]`` and
    their filtered softmax ``[len(rows), ..., V]`` (``/ temperature``,
    then top-k, then top-p, per row), or ``([], None)``."""
    rows = [s for s, smp in enumerate(samplers) if smp is not None]
    if not rows:
        return rows, None
    dev = l32.device
    idx = torch.tensor(rows, device=dev)
    lanes = l32[idx]
    v = lanes.shape[-1]
    per = lanes[0].numel() // v                  # lanes per row
    temps = torch.tensor([samplers[s][0] for s in rows], device=dev)
    top_ps = torch.tensor([samplers[s][1] for s in rows], device=dev)
    lt = lanes.reshape(-1, v) / temps.repeat_interleave(per)[:, None]
    if top_k and top_k > 0:
        lt = filter_top_k(lt, top_k)
    lt = filter_top_p(lt, top_ps.repeat_interleave(per)[:, None])
    return rows, torch.softmax(lt, dim=-1).reshape(lanes.shape)


def select_tokens(l32, samplers, top_k: int = 0):
    """logits ``[S, V]`` float32 -> ``[S]`` int64 next tokens.

    ``samplers[s]`` is None for a greedy row, else ``(temperature,
    top_p, generator)``; ``top_k`` (0 = off) applies to every sampled
    row, as the engine configures it."""
    tok, _ = select_tokens_window(l32[:, None], samplers, top_k,
                                  [0] * l32.shape[0])
    return tok[:, 0]


def select_tokens_window(l32, samplers, top_k, lanes):
    """logits ``[S, W, V]`` float32 of a verify window -> ``(tok [S, W]
    int64, probs)``.

    Every lane of a greedy row takes its argmax. A sampled row draws ONE
    token, at lane ``lanes[s]`` (its draft count: the lane whose draw is
    the bonus token when every draft is accepted), from its own
    generator, exactly as `select_tokens` draws a decode step's token;
    its other lanes hold the argmax and are not read. ``probs [n, W, V]``
    are the sampled rows' filtered softmax per lane, in slot order (None
    without a sampled row): the modified rejection test reads them."""
    tok = l32.argmax(dim=-1)
    rows, probs = _sampled_probs(l32, samplers, top_k)
    for j, s in enumerate(rows):
        tok[s, lanes[s]] = torch.multinomial(
            probs[j, lanes[s]], 1, generator=samplers[s][2])[0]
    return tok, probs





def sample_token(logits, generator, decode_strategy, temperature, top_k,
                 top_p):
    """logits ``[B, V]`` float32 -> ``[B]`` int64 token ids
    (``generation.py:57-67``): the argmax for ``greedy_search``, else one
    draw per row from ``generator`` after ``/ temperature``, top-k and
    top-p."""
    if decode_strategy == "greedy_search":
        return logits.argmax(dim=-1)
    if temperature != 1.0:
        logits = logits / temperature
    if top_k and top_k > 0:
        logits = filter_top_k(logits, int(top_k))
    if top_p is not None and top_p < 1.0:
        logits = filter_top_p(logits, float(top_p))
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


def quantize_weight_int8(w, axis=0):
    """Symmetric per-channel int8 (``generation.py:70-79``): the abs-max
    over ``axis`` (the contracted dim, kept) / 127 is the f32 scale (1
    where the channel is all zero), the values are rounded half to even
    and clipped to +-127. Returns ``(int8 w, f32 scale)``; ``q * scale``
    dequantizes by broadcast."""
    a = w.float().abs().amax(dim=axis, keepdim=True)
    scale = torch.where(a > 0, a / 127.0, torch.ones_like(a))
    q = torch.clamp(torch.round(w.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_state_int8(names, vals):
    """Weight-only int8 over a list of state leaves (``generation.py:
    82-98``): every 2-D float weight becomes ``(q, scale, dtype)`` (its
    original dtype, which dequantization restores); other leaves pass
    through. Embeddings contract over their last axis (rows are the
    channels), a `Linear`'s ``[in, out]`` weight over the first."""
    out = []
    for n, v in zip(names, vals):
        if v.dim() == 2 and v.is_floating_point():
            q, s = quantize_weight_int8(v, axis=1 if "embedding" in n else 0)
            out.append((q, s, v.dtype))
        else:
            out.append(v)
    return out


def dequantize_leaf(v):
    """Inverse of `quantize_state_int8` for one leaf (``generation.py:
    101-107``): ``(q * scale)`` in f32, cast to the weight's dtype; an
    unquantized leaf as it is."""
    if isinstance(v, tuple):
        q, s, dtype = v
        return torch.mul(q, s).to(dtype)
    return v


def _normalize_gen_args(decode_strategy, temperature, top_k, top_p,
                        eos_token_id, pad_token_id, max_new, num_beams=1):
    """The reference's argument checks and rewrites (``generation.py:
    110-135``): returns ``(decode_strategy, temperature, top_k, top_p,
    pad)``; temperature 0 means greedy, ``pad`` defaults to the EOS id."""
    if decode_strategy not in ("greedy_search", "sampling", "beam_search"):
        raise NotImplementedError(
            f"decode_strategy '{decode_strategy}': use 'greedy_search', "
            "'sampling' or 'beam_search'")
    if decode_strategy == "beam_search" and int(num_beams) < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if max_new < 1:
        raise ValueError("max_new_tokens must be >= 1")
    pad = pad_token_id if pad_token_id is not None else eos_token_id
    top_p = 1.0 if top_p is None else float(top_p)
    top_k = 0 if top_k is None else int(top_k)
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (0 disables), got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature == 0.0:
        decode_strategy, temperature = "greedy_search", 1.0
    return decode_strategy, float(temperature), top_k, top_p, pad


def _as_long(x, device=None):
    """Token ids or a mask (tensor, numpy array or nested list) as an
    int64 tensor."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(device=device if device is not None else t.device,
                dtype=torch.long)


def pad_to_bucket(input_ids, buckets, pad_token_id=0, attention_mask=None):
    """LEFT-pad a prompt batch to the smallest bucket >= its length
    (``generation.py:138-179``). Returns ``(ids, attention_mask)`` as
    int64 tensors; at an exact bucket hit the ids pass through.
    ``attention_mask`` carries per-row lengths of an already left-padded
    batch and is extended with the bucket padding."""
    ids = _as_long(input_ids)
    b, s = ids.shape
    fits = sorted(int(x) for x in buckets if int(x) >= s)
    if not fits:
        raise ValueError(
            f"prompt length {s} exceeds every bucket {sorted(buckets)} — "
            "add a larger bucket or truncate the prompt")
    tgt = fits[0]
    if attention_mask is None:
        mask = torch.ones((b, s), dtype=torch.long, device=ids.device)
    else:
        mask = _as_long(attention_mask, ids.device)
        if tuple(mask.shape) != (b, s):
            raise ValueError(f"attention_mask shape {tuple(mask.shape)} "
                             f"!= ids shape {(b, s)}")
    if tgt == s:
        return ids, mask
    pad_cols = tgt - s
    return (torch.cat([ids.new_full((b, pad_cols), int(pad_token_id)), ids],
                      dim=1),
            torch.cat([mask.new_zeros((b, pad_cols)), mask], dim=1))


def _top_k(x, k):
    """``jax.lax.top_k`` over the last axis, ties included: the ``k``
    largest values in descending order, equal values by ascending index
    (a stable descending sort; `torch.topk` promises no order of ties,
    and a finished beam's row of ``-1e30`` ties with itself)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@contextlib.contextmanager
def swapped_parameters(model, values: dict):
    """Run ``model`` with ``values`` (parameter name -> tensor) in place
    of its parameters of those names, restoring them on exit: the port's
    counterpart of the reference's ``_StateSwap``."""
    saved = []
    try:
        for name, val in values.items():
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            saved.append((mod, attr, mod._parameters[attr]))
            mod._parameters[attr] = val
        yield model
    finally:
        for mod, attr, p in reversed(saved):
            mod._parameters[attr] = p


class _Beams:
    """The beam frontier of a batch and its per-step selection, shared by
    the gather and the paged beam loops (``generation.py:783-856``,
    ``:988-1040``): ``scores [B, K]`` cumulative log-probs, ``done``,
    ``lengths`` and the output buffer ``out [B, K, max_new]``. Finished
    beams persist: their only continuation is ``feed_tok`` at zero score
    delta, and they write ``fill`` to the output."""

    def __init__(self, logits0, k, max_new, eos, fill, feed_tok):
        logp0 = torch.log_softmax(logits0.float(), dim=-1)    # [B, V]
        b, v = logp0.shape
        if eos is not None and not 0 <= int(eos) < v:
            raise ValueError(f"eos_token_id {eos} is outside the vocab "
                             f"({v}) — beams must be able to feed it")
        dev = logp0.device
        self.k, self.v, self.eos, self.fill = k, v, eos, fill
        self.scores, self.cur = _top_k(logp0, k)               # [B, K]
        self.done = (self.cur == eos if eos is not None
                     else torch.zeros((b, k), dtype=torch.bool, device=dev))
        self.lengths = torch.ones((b, k), dtype=torch.long, device=dev)
        self.out = torch.full((b, k, max_new), fill, dtype=torch.long,
                              device=dev)
        self.out[:, :, 0] = self.cur
        self.onlypad = torch.full((v,), -1e30, device=dev)
        self.onlypad[feed_tok] = 0.0
        self.rows = torch.arange(b, device=dev)[:, None] * k

    def all_done(self) -> bool:
        """Every beam finished (a device read; never true without EOS)."""
        return self.eos is not None and bool(self.done.all())

    def select(self, l32, i):
        """One step: float32 logits ``[B*K, V]`` of the current tokens ->
        the new frontier, output column ``i`` written. Returns the flat
        parent ``[B*K]`` of each new beam (rows of the previous step's
        ``[B*K]`` layout)."""
        b, k, v = self.scores.shape[0], self.k, self.v
        logp = torch.log_softmax(l32, dim=-1).reshape(b, k, v)
        logp = torch.where(self.done[:, :, None], self.onlypad, logp)
        cand = (self.scores[:, :, None] + logp).reshape(b, k * v)
        self.scores, idx = _top_k(cand, k)
        parent = idx // v
        tok = idx % v
        was_done = self.done.gather(1, parent)
        self.done = (was_done if self.eos is None
                     else was_done | (tok == self.eos))
        self.lengths = (self.lengths.gather(1, parent)
                        + (~was_done).long())
        self.out = self.out.gather(
            1, parent[:, :, None].expand(-1, -1, self.out.shape[2]))
        self.out[:, :, i] = torch.where(was_done, self.fill, tok)
        self.cur = tok
        return (self.rows + parent).reshape(-1)

    def best(self, length_penalty):
        """``[B, max_new]``: each row's best beam, ranked by score over
        the GNMT penalty ``((5 + len) / 6) ** length_penalty`` (0 = the
        plain sum), the first of equals."""
        norm = self.scores
        if length_penalty:
            norm = norm / ((5.0 + self.lengths.float()) / 6.0
                           ) ** length_penalty
        best = norm.argmax(dim=1)
        return self.out[torch.arange(self.out.shape[0],
                                     device=best.device), best]


class GenerationMixin:
    """`generate` for models with the static-cache and paged-beam
    protocols (``generation.py:182-1191``):

    - ``gen_static_cache(batch, max_len)`` -> per-layer ``(k, v)``
      ``[batch, heads, max_len, head_dim]``;
    - ``prefill(ids, caches, pad_mask=None)`` -> ``(last logits [B, 1,
      V], caches)``;
    - ``decode_step(tok [B, 1], step, caches, pads=, valid_cols=)`` ->
      ``(logits [B, 1, V], caches)``;
    - ``gen_page_pool``, ``gen_page_scales`` and ``decode_beam_paged``
      for the paged beam.

    Caches, pools and scales are written in place."""

    # -- weight-only int8 (``generation.py:220-274``) -------------------
    def serving_weights(self, weight_quant):
        """The weights a serving call runs on: None for the parameters as
        they are, or for ``weight_quant="int8"`` the name -> ``(q, scale,
        dtype)`` of every 2-D float parameter (`quantize_state_int8`),
        quantized once and cached on the model until a parameter is
        replaced or changed in place. `generate` and the serving `Engine`
        share it, so their rules cannot drift."""
        if weight_quant is None:
            return None
        if weight_quant != "int8":
            raise ValueError(f"weight_quant: only 'int8' is supported, got "
                             f"{weight_quant!r}")
        params = dict(self.named_parameters())
        key = tuple((id(p), p._version) for p in params.values())
        cached = getattr(self, "_quantized_weights", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        with torch.no_grad():
            leaves = quantize_state_int8(list(params), list(params.values()))
        quant = {n: v for n, v in zip(params, leaves)
                 if isinstance(v, tuple)}
        # the entry pins the originals: an id() is unique only while its
        # tensor lives
        object.__setattr__(self, "_quantized_weights",
                           (key, quant, list(params.values())))
        return quant

    @contextlib.contextmanager
    def dequantized(self, quant):
        """Scope in which the model runs on the dequantized ``quant``
        weights (`serving_weights`; None: on its own, unchanged). Each
        entry dequantizes every quantized weight once."""
        if quant is None:
            yield self
            return
        with torch.no_grad():
            values = {n: dequantize_leaf(v) for n, v in quant.items()}
        with swapped_parameters(self, values):
            yield self

    def quantize_for_serving(self, release=True):
        """Quantize every 2-D float weight to int8 for ``generate(...,
        weight_quant="int8")`` (``generation.py:537-575``). Releasing the
        full-precision weights (``release=True``, the reference's
        default) is ROADMAP A14; ``release=False`` caches the quantized
        weights and returns the model."""
        if release:
            raise NotImplementedError(
                "quantize_for_serving(release=True) comes with a later "
                "slice of the port (ROADMAP A14); pass release=False")
        self.serving_weights("int8")
        return self

    def export_generate(self, *args, **kwargs):
        raise NotImplementedError(
            "export_generate (a deployable bundle) comes with a later slice "
            "of the port (ROADMAP A14)")

    # -- generate (``generation.py:276-479``) ---------------------------
    def generate(self, input_ids, max_new_tokens=32,
                 decode_strategy="greedy_search", temperature=1.0, top_k=0,
                 top_p=1.0, eos_token_id=None, pad_token_id=None, seed=None,
                 mesh=None, sharding_rule=None, weight_quant=None,
                 attention_mask=None, num_beams=1, length_penalty=0.0,
                 stream_callback=None, beam_kv="paged"):
        """Generate ``max_new_tokens`` ids after ``input_ids [batch,
        seq]``; returns the continuation as int64 ``[batch,
        max_new_tokens]`` on the model's device. Rows that hit
        ``eos_token_id`` are filled with ``pad_token_id`` (default: the
        EOS id), and the loop ends once every row has finished.

        ``decode_strategy``: ``"greedy_search"``, ``"sampling"``
        (temperature / top-k / top-p, drawn from a generator seeded with
        ``seed``, else the port's default generator) or
        ``"beam_search"`` (``num_beams`` frontier; finished beams persist
        at a frozen score; the final ranking divides by ``((5 + len) /
        6) ** length_penalty``; returns each row's best beam).
        ``beam_kv``: ``"paged"`` keeps the prompt K/V once per row and
        each beam's tail in pages read by the paged-attention kernel,
        reordered by copy-on-write of the partial page; ``"gather"``
        tiles the cache K-fold and gathers it by parent every step (the
        reference's A/B oracle; the same tokens).
        ``attention_mask [batch, seq]``: LEFT-padded prompts (zeros then
        ones per row). ``weight_quant="int8"``: weight-only int8,
        dequantized once, when the loop is built, into weights the loop
        owns and its prompt pass and decode steps read.
        ``stream_callback``: called with each step's output column
        (int64 numpy ``[batch]``), not with beam search. ``mesh`` and
        ``sharding_rule`` are ROADMAP A12.

        The loop built for these arguments (its static caches, its
        decode step's graph and, with int8 weights, their dequantized
        copy) stays on the model after the call: the most recently used
        loops, at most `GENERATE_CACHE_SIZE` of them and at most
        `GENERATE_CACHE_BYTES` of device memory together, the loop used
        last kept whatever its size (`generate_cache_bytes` reads what
        they hold, `clear_generate_cache` frees it)."""
        if mesh is not None or sharding_rule is not None:
            raise NotImplementedError(
                "generate(mesh=..., sharding_rule=...) comes with a later "
                "slice of the port (ROADMAP A12 distributed serving)")
        dev = self.device
        ids = _as_long(input_ids, dev)
        if ids.dim() != 2:
            raise ValueError(f"input_ids must be [batch, seq], got "
                             f"{tuple(ids.shape)}")
        b, prompt_len = ids.shape
        max_new = int(max_new_tokens)
        decode_strategy, temperature, top_k, top_p, pad = _normalize_gen_args(
            decode_strategy, temperature, top_k, top_p, eos_token_id,
            pad_token_id, max_new, num_beams)
        amask = None
        if attention_mask is not None:
            amask = _as_long(attention_mask, dev)
            if tuple(amask.shape) != (b, prompt_len):
                raise ValueError(
                    f"attention_mask shape {tuple(amask.shape)} != "
                    f"input_ids shape {(b, prompt_len)}")
            am = amask.cpu().numpy() != 0
            if not am.any(axis=1).all():
                raise ValueError("attention_mask has an all-pad row")
            if not (np.sort(am, axis=1) == am).all():
                raise ValueError(
                    "attention_mask must be LEFT-padded (zeros then ones "
                    "per row); right-padded prompts put pad tokens in the "
                    "sampling slot")
            amask = None if am.all() else amask
        beam = decode_strategy == "beam_search"
        if stream_callback is not None and beam:
            raise ValueError(
                "stream_callback is not supported with beam_search: the "
                "beam frontier reorders every step, so there is no stable "
                "per-step token emission to stream")
        quant = self.serving_weights(weight_quant)
        generator = (torch.Generator(device=dev).manual_seed(int(seed))
                     if seed is not None else current_generator(dev))
        masked = amask is not None
        if beam:
            key = ("beam", b, prompt_len, max_new, int(num_beams),
                   float(length_penalty), eos_token_id, pad, weight_quant,
                   masked, str(beam_kv))
        else:
            key = (b, prompt_len, max_new, decode_strategy, temperature,
                   top_k, top_p, eos_token_id, pad, weight_quant, masked)
        # the weights a built loop's graphs read: the quantized set (kept
        # alive by the entry, so its id is not reused) and the storage of
        # every parameter
        key += (id(quant), tuple(p.data_ptr() for p in self.parameters()))
        if beam:
            fn = self._cached_generate_fn(key, lambda: self._build_beam_fn(
                b, prompt_len, max_new, int(num_beams), eos_token_id, pad,
                float(length_penalty), with_mask=masked,
                kv_impl=str(beam_kv), weights=quant))
        else:
            fn = self._cached_generate_fn(key, lambda: self._build_generate_fn(
                b, prompt_len, max_new, decode_strategy, temperature, top_k,
                top_p, eos_token_id, pad, with_mask=masked, weights=quant))
        was_training = self.training
        self.eval()
        try:
            with torch.inference_mode():
                if beam:
                    return fn(ids, amask)
                return fn(ids, amask, generator, stream_callback)
        finally:
            if was_training:
                self.train()

    # -- the built loops and their cache --------------------------------
    def _generate_graphs(self):
        """``(LRU of built loops, graph memory pool, model name)``: what
        `generate` keeps on the model, made on first use."""
        own = self.__dict__.get("_generate_graphs_")
        if own is None:
            own = (collections.OrderedDict(), graph_pool(self.device),
                   f"model{next(_model_ids)}")
            object.__setattr__(self, "_generate_graphs_", own)
        return own

    def _cached_generate_fn(self, key, build):
        """The loop built for ``key``, built on a miss; then the least
        recently used loops are dropped, with their graphs and buffers,
        while more than `GENERATE_CACHE_SIZE` are kept or they hold more
        than `GENERATE_CACHE_BYTES` (never the loop just used)."""
        cache = self._generate_graphs()[0]
        fn = cache.get(key)
        if fn is not None:
            cache.move_to_end(key)
            return fn
        fn = cache[key] = build()
        while len(cache) > 1 and (
                len(cache) > GENERATE_CACHE_SIZE
                or self.generate_cache_bytes() > GENERATE_CACHE_BYTES):
            cache.popitem(last=False)
        return fn

    def generate_cache_bytes(self) -> int:
        """Device bytes the built loops of `generate` hold: every tensor
        they own (caches, page pools, block tables, step buffers,
        dequantized weights), each storage once. The graphs' memory pool
        is not counted: it holds the steps' intermediates, which the
        model's later captures into the same pool reuse."""
        seen, total = set(), 0
        for fn in self._generate_graphs()[0].values():
            for t in fn.held:
                st = t.untyped_storage()
                if st.data_ptr() not in seen:
                    seen.add(st.data_ptr())
                    total += st.nbytes()
        return total

    def clear_generate_cache(self):
        """Drop every built loop of `generate` (their graphs, caches and
        page pools): the device memory they hold returns to the caching
        allocator."""
        self._generate_graphs()[0].clear()

    def _decode_step_fn(self, kind, tag, body, *, staged, inputs, fixed):
        """A loop's decode step: a `CapturedStep` named
        ``generate.{kind}[{model}][{tag}]`` in the model's graph pool,
        each build reported to the recompile sentinel under that name
        and no signature, as the `Engine` reports its steps: armed, a
        rebuild (after an eviction, or for new weights) raises."""
        _, pool, model = self._generate_graphs()
        name = f"generate.{kind}[{model}][{tag}]"
        return CapturedStep(name, body, self.device, pool=pool,
                            on_trace=lambda: get_sentinel().note_trace(name),
                            staged=staged, inputs=inputs, fixed=fixed)

    def _loop_weights(self, weights):
        """The parameter values a loop built for ``weights`` runs on:
        ``{}`` (the parameters as they are) for None, else the quantized
        weights dequantized once into tensors the loop owns, at fixed
        addresses its graph reads (the loop's key holds the quantized
        set, so these never go stale)."""
        if weights is None:
            return {}
        with torch.no_grad():
            return {n: dequantize_leaf(v) for n, v in weights.items()}

    @staticmethod
    def _holds(run, decode, weights, *groups):
        """Set ``run.decode``, ``run.weights`` (the quantized set the loop
        was built for, kept alive: its id is in the loop's key) and
        ``run.held``: every device tensor the loop owns (``groups`` of
        tensors, nested per layer, or dicts of them) and its step's
        static buffers."""
        held = list(decode.static.values())
        stack = list(groups)
        while stack:
            g = stack.pop()
            if torch.is_tensor(g):
                held.append(g)
            elif isinstance(g, dict):
                stack.extend(g.values())
            elif g is not None:
                stack.extend(g)
        run.decode, run.weights, run.held = decode, weights, held

    def _build_generate_fn(self, b, prompt_len, max_new, decode_strategy,
                           temperature, top_k, top_p, eos_token_id, pad,
                           with_mask=False, weights=None):
        """Greedy or sampled generation (``generation.py:1098-1191``) as a
        host loop: ``run(ids, amask=None, generator=None,
        stream_callback=None) -> [B, max_new]``. One prefill into the
        loop's static caches of ``prompt_len + max_new`` columns, then a
        token a decode step (``run.decode``, a `CapturedStep` of ``(cur
        [B, 1], step)``, and with a mask ``pads`` and ``valid_cols``, set
        once a call). A finished row writes ``pad`` to the output and
        feeds EOS (always in the vocab) to the model. ``weights``: the
        quantized weights of ``weight_quant`` (`serving_weights`),
        dequantized once into the loop's own copy (`_loop_weights`),
        which the prefill and every step read."""
        total_len = prompt_len + max_new
        eos = eos_token_id
        fill = pad if (eos is not None and pad is not None) else 0
        caches = self.gen_static_cache(b, total_len)
        wvals = self._loop_weights(weights)
        inputs = {"cur": ((b, 1), torch.long)}
        if with_mask:
            inputs.update(pads=((b,), torch.long),
                          valid_cols=((b, total_len), torch.long))

        def body(cur, step, pads=None, valid_cols=None):
            with swapped_parameters(self, wvals):
                logits, _ = self.decode_step(cur, step, caches, pads=pads,
                                             valid_cols=valid_cols)
            return logits[:, -1].float()

        decode = self._decode_step_fn(
            f"decode.{decode_strategy}", f"b{b}x{prompt_len}+{max_new}"
            f"{'m' if with_mask else ''}{'q' if weights else ''}",
            body, staged={"step": ()}, inputs=inputs,
            fixed=[t for pair in caches for t in pair])

        def pick(l32, generator):
            return sample_token(l32, generator, decode_strategy, temperature,
                                top_k, top_p)

        def run(ids, amask=None, generator=None, stream_callback=None):
            if with_mask and amask is None:
                raise ValueError("this generate fn was built for a masked "
                                 "batch but was called without one")
            if amask is not None:
                decode.set(pads=prompt_len - amask.sum(dim=1),
                           valid_cols=torch.cat(
                               [amask, amask.new_ones((b, max_new))], dim=1))
            with swapped_parameters(self, wvals):
                logits, _ = self.prefill(ids, caches, pad_mask=amask)
            cur = pick(logits[:, -1].float(), generator)
            done = cur == eos if eos is not None else None
            out = torch.full((b, max_new), fill, dtype=torch.long,
                             device=ids.device)
            out[:, 0] = cur
            if stream_callback is not None:
                stream_callback(out[:, 0].cpu().numpy())
            for i in range(1, max_new):
                if done is not None and bool(done.all()):
                    break
                nxt = pick(decode(cur=cur[:, None], step=prompt_len + i - 1),
                           generator)
                if done is None:
                    out[:, i] = cur = nxt
                else:
                    out[:, i] = torch.where(done, pad, nxt)
                    cur = torch.where(done, eos, nxt)
                    done = done | (nxt == eos)
                if stream_callback is not None:
                    stream_callback(out[:, i].cpu().numpy())
            return out

        self._holds(run, decode, weights, caches, wvals)
        return run

    def _build_beam_fn(self, b, prompt_len, max_new, num_beams,
                       eos_token_id, pad, length_penalty, with_mask=False,
                       kv_impl="paged", page_size=16, kv_quant=None,
                       weights=None):
        """Beam search (``generation.py:692-870``): ``run(ids,
        amask=None) -> [B, max_new]``. ``kv_impl="paged"`` is
        `_build_beam_fn_paged`; ``"gather"`` the exact-reorder oracle:
        one prefill on the ``B`` prompts, tiled K-fold into the loop's
        static ``[B*K, H, S, D]`` caches, a decode step a token
        (``run.decode``, a `CapturedStep` of ``(cur [B*K, 1], step)``),
        and after it the whole cache gathered by parent, in place (the
        step reads the caches at fixed addresses). ``kv_quant``
        (``"int8"``/``"fp8"`` tail pages) needs the paged layout;
        ``weights`` as in `_build_generate_fn`."""
        if kv_impl == "paged":
            return self._build_beam_fn_paged(
                b, prompt_len, max_new, num_beams, eos_token_id, pad,
                length_penalty, with_mask, int(page_size), kv_quant=kv_quant,
                weights=weights)
        if kv_quant is not None:
            raise ValueError(
                "kv_quant= quantizes the generated-tail PAGE pool: it needs "
                "kv_impl='paged' (the gather oracle stores dense rows)")
        if kv_impl != "gather":
            raise ValueError(
                f"kv_impl must be 'paged' or 'gather', got {kv_impl!r}")
        total_len = prompt_len + max_new
        k = num_beams
        n = b * k
        eos = eos_token_id
        fill = pad if (eos is not None and pad is not None) else 0
        feed_tok = eos if eos is not None else 0
        caches = self.gen_static_cache(n, total_len)
        wvals = self._loop_weights(weights)
        inputs = {"cur": ((n, 1), torch.long)}
        if with_mask:
            inputs.update(pads=((n,), torch.long),
                          valid_cols=((n, total_len), torch.long))

        def body(cur, step, pads=None, valid_cols=None):
            with swapped_parameters(self, wvals):
                logits, _ = self.decode_step(cur, step, caches, pads=pads,
                                             valid_cols=valid_cols)
            return logits[:, -1].float()

        decode = self._decode_step_fn(
            "beam_gather", f"b{b}x{prompt_len}+{max_new}k{k}"
            f"{'m' if with_mask else ''}{'q' if weights else ''}",
            body, staged={"step": ()}, inputs=inputs,
            fixed=[t for pair in caches for t in pair])

        def run(ids, amask=None):
            if with_mask and amask is None:
                raise ValueError("this beam fn was built for a masked batch "
                                 "but was called without one")
            if amask is not None:
                valid_cols = torch.cat([amask, amask.new_ones((b, max_new))],
                                       dim=1)
                decode.set(pads=(prompt_len - amask.sum(dim=1)
                                 ).repeat_interleave(k),
                           valid_cols=valid_cols.repeat_interleave(k, dim=0))
            ctx = self.gen_static_cache(b, prompt_len)
            with swapped_parameters(self, wvals):
                logits, _ = self.prefill(ids, ctx, pad_mask=amask)
            for (kc, vc), (pk, pv) in zip(caches, ctx):
                kc[:, :, :prompt_len] = pk.repeat_interleave(k, dim=0)
                vc[:, :, :prompt_len] = pv.repeat_interleave(k, dim=0)
            del ctx
            beams = _Beams(logits[:, -1], k, max_new, eos, fill, feed_tok)
            for i in range(1, max_new):
                if beams.all_done():
                    break
                parent = beams.select(
                    decode(cur=beams.cur.reshape(n, 1),
                           step=prompt_len + i - 1), i)
                if i + 1 < max_new:
                    for kc, vc in caches:
                        kc.copy_(kc.index_select(0, parent))
                        vc.copy_(vc.index_select(0, parent))
            return beams.best(length_penalty)

        self._holds(run, decode, weights, caches, wvals)
        return run

    def _build_beam_fn_paged(self, b, prompt_len, max_new, num_beams,
                             eos_token_id, pad, length_penalty,
                             with_mask=False, page_size=16, kv_quant=None,
                             weights=None):
        """Paged beam search (``generation.py:872-1096``): ``run(ids,
        amask=None) -> [B, max_new]``.

        The prompt K/V stays in the loop's static prefill caches ``[B,
        H, Sp, D]``, one copy per batch row shared by its K beams and
        never reordered; the generated K/V lives in a page pool
        ``[B*K*Pg, H, ps, D]`` (1-byte pages with f32 scales for
        ``kv_quant``) through a block table ``[B*K, Pg]``. Beam ``n``
        owns pages ``n*Pg + g``, and a page is written only while it is
        its owner's current partial page, so a completed page is
        immutable and any descendant's table may point at it. Each step
        is one decode step (``run.decode``, a `CapturedStep` of ``(cur
        [B*K, 1], step, gen_col)``, and with a mask ``pads`` and
        ``pad_mask``, set once a call), then, eagerly: the table's rows
        gathered by parent, in place; a copy-on-write of the current
        partial page from the parent's into the child's own slot (every
        read against the pool before the copy, data and scale rows
        together, `paged_kv.copy_pages`); the next page pointed at the
        child's own slot. The tail is read by the paged-attention kernel
        (`kernels.paged_attention.paged_tail_segment`)."""
        if kv_quant not in (None, "int8", "fp8"):
            raise ValueError(f"kv_quant must be None, 'int8' or 'fp8', "
                             f"got {kv_quant!r}")
        total_len = prompt_len + max_new
        k = num_beams
        n = b * k
        ps = int(page_size)
        # gen columns 0..max_new-2 are written (token 0 comes from the
        # prefill); Pg >= 1 keeps the shapes non-degenerate at max_new 1
        pg = max(1, -(-max(0, max_new - 1) // ps))
        eos = eos_token_id
        fill = pad if (eos is not None and pad is not None) else 0
        feed_tok = eos if eos is not None else 0
        page_dtype = {None: None, "int8": "int8",
                      "fp8": "float8_e4m3fn"}[kv_quant]
        dev = self.device
        # a 0-batch probe checks the whole horizon against the position
        # table without allocating it
        self.gen_static_cache(0, total_len)
        ctx = self.gen_static_cache(b, prompt_len)
        pools = self.gen_page_pool(n * pg, ps, dtype=page_dtype)
        scales = (self.gen_page_scales(n * pg, ps) if kv_quant is not None
                  else None)
        own = (torch.arange(n, device=dev)[:, None] * pg
               + torch.arange(pg, device=dev)[None, :]).to(torch.int32)
        bt = own.clone()
        wvals = self._loop_weights(weights)
        inputs = {"cur": ((n, 1), torch.long)}
        if with_mask:
            inputs.update(pads=((n,), torch.long),
                          pad_mask=((b, prompt_len), torch.long))

        def body(cur, step, gen_col, pads=None, pad_mask=None):
            with swapped_parameters(self, wvals):
                logits = self.decode_beam_paged(
                    cur, step, ctx, pools, bt, gen_col, pads=pads,
                    pad_mask=pad_mask, scales=scales)
            return logits[:, -1].float()

        fixed = [t for pairs in (ctx, pools, scales or ()) for pair in pairs
                 for t in pair] + [bt]
        decode = self._decode_step_fn(
            "beam_paged", f"b{b}x{prompt_len}+{max_new}k{k}ps{ps}"
            f"{kv_quant or ''}{'m' if with_mask else ''}"
            f"{'q' if weights else ''}", body,
            staged={"step": (), "gen_col": ()}, inputs=inputs, fixed=fixed)

        def run(ids, amask=None):
            if with_mask and amask is None:
                raise ValueError("this beam fn was built for a masked batch "
                                 "but was called without one")
            if amask is not None:
                decode.set(pads=(prompt_len - amask.sum(dim=1)
                                 ).repeat_interleave(k), pad_mask=amask)
            with swapped_parameters(self, wvals):
                logits, _ = self.prefill(ids, ctx, pad_mask=amask)
            beams = _Beams(logits[:, -1], k, max_new, eos, fill, feed_tok)
            bt.copy_(own)
            for i in range(1, max_new):
                if beams.all_done():
                    break
                j = i - 1                        # the gen column written
                parent = beams.select(
                    decode(cur=beams.cur.reshape(n, 1),
                           step=prompt_len + i - 1, gen_col=j), i)
                g, g2 = j // ps, i // ps
                bt.copy_(bt.index_select(0, parent))
                src, dst = bt[:, g].long(), own[:, g].long()
                for li, (pk, pv) in enumerate(pools):
                    ks, vs = (None, None) if scales is None else scales[li]
                    copy_pages(pk, dst, src, ks)
                    copy_pages(pv, dst, src, vs)
                bt[:, g] = own[:, g]
                if g2 < pg:     # the last step's next page is past the table
                    bt[:, g2] = own[:, g2]
            return beams.best(length_penalty)

        self._holds(run, decode, weights, ctx, pools, scales, own, bt, wvals)
        return run


def load_generate(path):
    raise NotImplementedError(
        "load_generate (a deployable bundle) comes with a later slice of the "
        "port (ROADMAP A14)")


__all__ = ["filter_top_k", "filter_top_p", "select_tokens",
           "select_tokens_window", "sample_token", "quantize_weight_int8",
           "quantize_state_int8", "dequantize_leaf", "pad_to_bucket",
           "swapped_parameters", "GenerationMixin", "load_generate"]
