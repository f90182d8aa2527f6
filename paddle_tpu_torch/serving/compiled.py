"""The per-step functions of the paged engine, one captured step per
shape bucket.

Counterpart: ``paddle_tpu/serving/compiled.py`` — `build_paged_prefill_fn`
(:247-304), `build_paged_decode_step_fn` (:355-395) and
`build_paged_verify_step_fn` (:563-616). There each builder returns an
executable jitted once per shape bucket; here each returns a
`jit.capture.CapturedStep`: on a card one CUDA graph, captured on first
use and replayed on every later call, on the CPU the same body run
eagerly on the same static buffers. A decode step is the verify step at
one lane per slot.

Each body writes the page pools in place, and the scales beside them
when ``scales`` (the per-layer ``(k_scale, v_scale)`` of a quantized
pool) is given, dequantizes weight-only int8 ``weights`` inside the step
(as the reference's step dequantizes inside its executable, :376), and
returns the **float32 logits**. Token selection (`models.generation.
select_tokens` / `select_tokens_window`) runs after the replay, eagerly:
a sampled row draws from its request's own `torch.Generator`, which one
graph could not hold. The operands are the int32 arrays the engine
keeps on the host, staged through one pinned buffer in one copy a step.
"""
from __future__ import annotations

from ..jit.capture import CapturedStep
from ..kernels.paged_kv import scatter_prompt_pages, scatter_prompt_pages_q


def _flat(pools, scales):
    """The tensors a step writes in place: every pool, then every
    scale."""
    out = [t for pair in pools for t in pair]
    if scales is not None:
        out += [t for pair in scales for t in pair]
    return out


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


__all__ = ["build_paged_prefill_fn", "build_paged_verify_step_fn"]
