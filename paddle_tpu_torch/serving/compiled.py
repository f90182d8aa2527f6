"""The per-step functions of the serving engine, one captured step per
shape bucket.

Counterpart: ``paddle_tpu/serving/compiled.py``:

- dense slot caches: `build_prefill_fn` (:167-212) and
  `build_verify_step_fn` (:514-560; its decode step, :215-244, is the
  verify step at one lane);
- paged pools: `build_paged_prefill_fn` (:247-304),
  `build_paged_verify_step_fn` (:563-616; its decode step, :355-395, is
  the verify step at one lane), `build_cached_prefill_fn` (the prefix
  cache's tail prefill, :307-352), `build_chunked_prefill_decode_fn`
  (one chunk of a prompt and a decode step of every slot, :398-472) and
  `build_embed_prefill_fn` (one chunk of `Engine.embed`, :475-511).

There each builder returns an executable jitted once per shape bucket;
here each returns a `jit.capture.CapturedStep`: on a card one CUDA
graph, captured on first use and replayed on every later call, on the
CPU the same body run eagerly on the same static buffers.

Each body writes the caches or page pools in place, and the scales
beside them when ``scales`` (the per-layer ``(k_scale, v_scale)`` of a
quantized pool) is given, dequantizes weight-only int8 ``weights``
inside the step (as the reference's step dequantizes inside its
executable, :376), and returns **float32 logits** (the embed step: a
float32 hidden state). Token selection (`models.generation.
select_tokens` / `select_tokens_window`) runs after the replay, eagerly:
a sampled row draws from its request's own `torch.Generator`, which one
graph could not hold. The operands are the int32 arrays the engine
keeps on the host, staged through one pinned buffer in one copy a step.
"""
from __future__ import annotations

from ..jit.capture import CapturedStep
from ..kernels.paged_kv import scatter_prompt_pages, scatter_prompt_pages_q


def _flat(pools, scales):
    """The tensors a step writes in place: every pool (or slot cache),
    then every scale."""
    out = [t for pair in pools for t in pair]
    if scales is not None:
        out += [t for pair in scales for t in pair]
    return out


def build_prefill_fn(model, n, bucket, *, caches, name, pool, on_trace,
                     weights=None):
    """The prompt pass of ``n`` left-padded rows of ``bucket`` tokens into
    the dense slot caches, as a `CapturedStep` of ``(ids [n, bucket],
    amask [n, bucket], slot_idx [n])``, all int32: the prompt K/V is
    computed in a local ``[n, H, bucket, D]`` cache, which the prompt
    attends, and then written into columns ``[0, bucket)`` of the slot
    rows ``slot_idx`` (the later columns are left as they are: decode
    writes them before any read). Returns each row's last logits ``[n,
    V]`` float32. ``name`` is the step's name for the sentinel,
    ``on_trace("prefill")`` is called on each build and reports it
    there, ``pool`` is the owner's graph memory pool."""

    def body(ids, amask, slot_idx):
        with model.dequantized(weights):
            local = model.gen_static_cache(n, bucket)
            logits, local = model.prefill(ids, local, pad_mask=amask)
            rows = slot_idx.long()
            for (kc, vc), (lk, lv) in zip(caches, local):
                kc[rows, :, :bucket] = lk.to(kc.dtype)
                vc[rows, :, :bucket] = lv.to(vc.dtype)
        return logits[:, -1].float()

    return CapturedStep(
        name, body, model.device, pool=pool,
        on_trace=lambda: on_trace("prefill"),
        staged=dict(ids=(n, bucket), amask=(n, bucket), slot_idx=(n,)),
        fixed=_flat(caches, None))


def build_verify_step_fn(model, slots, w, max_len, *, caches, name, pool,
                         on_trace, weights=None):
    """One decode (``w = 1``) or speculative verify (``w = k + 1``) step
    of every slot over the dense slot caches, as a `CapturedStep` of
    ``(tokens [slots, w], steps [slots], pads [slots], valid_cols [slots,
    max_len])``, all int32: lane ``j`` writes at column ``steps[s] + j``
    and every lane is scored in one pass. Returns the logits ``[slots,
    w, V]`` float32. ``name``, ``pool`` and ``on_trace`` (called with
    ``"decode"``) as in `build_prefill_fn`."""

    def body(tokens, steps, pads, valid_cols):
        with model.dequantized(weights):
            logits = model.verify_slots(tokens, steps, caches, pads=pads,
                                        valid_cols=valid_cols)
        return logits.float()

    return CapturedStep(
        name, body, model.device, pool=pool,
        on_trace=lambda: on_trace("decode"),
        staged=dict(tokens=(slots, w), steps=(slots,), pads=(slots,),
                    valid_cols=(slots, max_len)),
        fixed=_flat(caches, None))


def build_paged_prefill_fn(model, n, bucket, page_size, *, pools,
                           max_pages, name, pool, on_trace, scales=None,
                           weights=None):
    """The prompt pass of ``n`` left-padded rows of ``bucket`` tokens as
    a `CapturedStep` of ``(ids [n, bucket], amask [n, bucket], page_rows
    [n, max_pages])``, all int32 (``amask`` marks the real tokens,
    ``page_rows`` are the rows' block-table rows): the prompt K/V is
    computed in a local float ``[n, H, bucket, D]`` cache, which the
    prompt attends, and then scattered into each row's reserved pages
    (``bucket`` need not be a multiple of ``page_size``), quantized on
    the way into a quantized pool. Returns each row's last logits ``[n,
    V]`` float32. ``name`` is the step's name for the sentinel,
    ``on_trace("prefill")`` is called on each build and reports it
    there, ``pool`` is the owner's graph memory pool."""

    def body(ids, amask, page_rows):
        with model.dequantized(weights):
            local = model.gen_static_cache(n, bucket)
            logits, local = model.prefill(ids, local, pad_mask=amask)
            for i, ((pk, pv), (lk, lv)) in enumerate(zip(pools, local)):
                if scales is None:
                    scatter_prompt_pages(pk, page_rows, lk, page_size)
                    scatter_prompt_pages(pv, page_rows, lv, page_size)
                else:
                    ks, vs = scales[i]
                    scatter_prompt_pages_q(pk, ks, page_rows, lk, page_size)
                    scatter_prompt_pages_q(pv, vs, page_rows, lv, page_size)
        return logits[:, -1].float()

    return CapturedStep(
        name, body, model.device, pool=pool,
        on_trace=lambda: on_trace("prefill"),
        staged=dict(ids=(n, bucket), amask=(n, bucket),
                    page_rows=(n, max_pages)),
        fixed=_flat(pools, scales))


def build_paged_verify_step_fn(model, slots, w, max_pages, page_size, *,
                               pools, name, pool, on_trace, scales=None,
                               weights=None):
    """One decode (``w = 1``) or speculative verify (``w = k + 1``) step
    of every slot, active or parked, as a `CapturedStep` of ``(tokens
    [slots, w], steps [slots], pads [slots], valid_cols [slots,
    max_pages * page_size], block_table [slots, max_pages])``, all int32:
    ``tokens`` holds each slot's pending token and its drafts
    (zero-padded); lane ``j`` writes at column ``steps[s] + j`` and every
    lane is scored in one pass, the paged-attention kernel at ``w``
    queries per row. Returns the logits ``[slots, w, V]`` float32.
    ``name``, ``pool`` and ``on_trace`` (called with ``"decode"``) as
    in `build_paged_prefill_fn`."""

    def body(tokens, steps, pads, valid_cols, block_table):
        with model.dequantized(weights):
            logits = model.verify_slots_paged(
                tokens, steps, pools, block_table, pads=pads,
                valid_cols=valid_cols, scales=scales)
        return logits.float()

    return CapturedStep(
        name, body, model.device, pool=pool,
        on_trace=lambda: on_trace("decode"),
        staged=dict(tokens=(slots, w), steps=(slots,), pads=(slots,),
                    valid_cols=(slots, max_pages * page_size),
                    block_table=(slots, max_pages)),
        fixed=_flat(pools, scales))


def _tail_staged(n, bucket, max_pages):
    """The staged operands of a tail prefill of ``n`` rows: right-padded
    ids, real tail lengths, first columns, block-table rows."""
    return dict(ids=(n, bucket), tail_lens=(n,), col0=(n,),
                page_rows=(n, max_pages))


def build_cached_prefill_fn(model, n, bucket, max_pages, *, pools, name,
                            pool, on_trace, scales=None, weights=None):
    """The tail prefill of prefix-cache admission as a `CapturedStep` of
    ``(ids [n, bucket], tail_lens [n], col0 [n], page_rows [n,
    max_pages])``, all int32: each row's uncached prompt suffix, right-
    padded, runs through `GPTModel.prefill_paged`: its K/V land in the
    row's own pages at columns ``col0 + j`` and every query attends the
    prefix pages the row maps read-only plus its causal tail. ``col0``
    and ``tail_lens`` are operands, so one graph a tail bucket serves
    every match length, none included. Returns the logits of each row's
    last real tail token ``[n, V]`` float32. ``name``, ``pool`` and
    ``on_trace`` (called with ``"prefill"``) as in
    `build_prefill_fn`."""

    def body(ids, tail_lens, col0, page_rows):
        with model.dequantized(weights):
            logits = model.prefill_paged(ids, pools, page_rows, col0,
                                         tail_lens, scales=scales)
        return logits[:, -1].float()

    return CapturedStep(
        name, body, model.device, pool=pool,
        on_trace=lambda: on_trace("prefill"),
        staged=_tail_staged(n, bucket, max_pages),
        fixed=_flat(pools, scales))


def build_chunked_prefill_decode_fn(model, slots, chunk_tokens, max_pages,
                                    page_size, *, pools, name, pool,
                                    on_trace, scales=None, weights=None):
    """One mixed step: a chunk of one prompt, then a decode step of every
    slot, as a `CapturedStep` of the chunk's ``(ids [1, chunk_tokens],
    tail_lens [1], col0 [1], page_rows [1, max_pages])`` (as in
    `build_cached_prefill_fn`) and the decode step's ``(tokens [slots,
    1], steps, pads, valid_cols, block_table)`` (as in
    `build_paged_verify_step_fn`), all int32. The chunk runs first, so
    the decode half reads pools that already hold it; ``block_table``
    is the decode view, in which the engine points the chunking slot's
    row at the sentinel page (its parked lane then cannot write on the
    pages the chunk fills). The decode half's attention is the paged
    kernel on a card. Returns ``(chunk logits [1, V], decode logits
    [slots, 1, V])`` float32; the engine reads the chunk's only after
    the final chunk. ``on_trace`` is called with ``"decode"``: the
    engine registers the step in the decode family without counting it
    (``count=False``)."""

    def body(ids, tail_lens, col0, page_rows, tokens, steps, pads,
             valid_cols, block_table):
        with model.dequantized(weights):
            chunk = model.prefill_paged(ids, pools, page_rows, col0,
                                        tail_lens, scales=scales)
            logits = model.verify_slots_paged(
                tokens, steps, pools, block_table, pads=pads,
                valid_cols=valid_cols, scales=scales)
        return chunk[:, -1].float(), logits.float()

    return CapturedStep(
        name, body, model.device, pool=pool,
        on_trace=lambda: on_trace("decode"),
        staged=dict(**_tail_staged(1, chunk_tokens, max_pages),
                    tokens=(slots, 1), steps=(slots,), pads=(slots,),
                    valid_cols=(slots, max_pages * page_size),
                    block_table=(slots, max_pages)),
        fixed=_flat(pools, scales))


def build_embed_prefill_fn(model, n, chunk_tokens, max_pages, *, pools,
                           name, pool, on_trace, scales=None,
                           weights=None):
    """One chunk of `Engine.embed`'s all-prefill pass as a `CapturedStep`
    with `build_cached_prefill_fn`'s operands: the chunk's K/V land in
    the row's own pages at columns ``col0 + j``, so a prompt of any
    length runs as a loop of these calls. Returns the ``ln_f`` hidden
    state of each row's last real token ``[n, hidden]`` float32 (no
    logits, no token)."""

    def body(ids, tail_lens, col0, page_rows):
        with model.dequantized(weights):
            hidden = model.gpt.prefill_paged(ids, pools, page_rows, col0,
                                             tail_lens, scales=scales)
        return hidden[:, -1].float()

    return CapturedStep(
        name, body, model.device, pool=pool,
        on_trace=lambda: on_trace("prefill"),
        staged=_tail_staged(n, chunk_tokens, max_pages),
        fixed=_flat(pools, scales))


__all__ = ["build_prefill_fn", "build_verify_step_fn",
           "build_paged_prefill_fn", "build_paged_verify_step_fn",
           "build_cached_prefill_fn", "build_chunked_prefill_decode_fn",
           "build_embed_prefill_fn"]
