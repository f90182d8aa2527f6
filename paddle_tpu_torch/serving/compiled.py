"""The per-step functions of the paged engine.

Counterpart: ``paddle_tpu/serving/compiled.py`` — `build_paged_prefill_fn`
(:247-304), `build_paged_decode_step_fn` (:355-395) and
`build_paged_verify_step_fn` (:563-616). There each is a jitted
executable over static shapes; here each is a plain function that runs
eagerly (graph capture per shape bucket is later work), and a decode
step is the verify step at one lane per slot. Each writes the
page pools in place, and the scales beside them when ``scales`` (the
per-layer ``(k_scale, v_scale)`` of a quantized pool) is given, and
returns the selected tokens as a device tensor.
"""
from __future__ import annotations

from ..kernels.paged_kv import scatter_prompt_pages, scatter_prompt_pages_q
from ..models.generation import select_tokens, select_tokens_window


def paged_prefill_step(model, pools, ids, amask, page_rows, page_size,
                       samplers, top_k=0, scales=None):
    """Prompt pass for ``ids [n, bucket]`` (left-padded; ``amask`` marks
    the real tokens): the prompt K/V is computed in a local float ``[n,
    H, bucket, D]`` cache, which the prompt attends, and then scattered
    into each row's reserved pages (``page_rows [n,
    >=pages_for(bucket)]``; ``bucket`` need not be a multiple of
    ``page_size``), quantized on the way into a quantized pool. Returns
    each row's first token ``[n]``."""
    n, bucket = ids.shape
    local = model.gen_static_cache(n, bucket)
    logits, local = model.prefill(ids, local, pad_mask=amask)
    tok = select_tokens(logits[:, -1].float(), samplers, top_k)
    for i, ((pk, pv), (lk, lv)) in enumerate(zip(pools, local)):
        if scales is None:
            scatter_prompt_pages(pk, page_rows, lk, page_size)
            scatter_prompt_pages(pv, page_rows, lv, page_size)
        else:
            ks, vs = scales[i]
            scatter_prompt_pages_q(pk, ks, page_rows, lk, page_size)
            scatter_prompt_pages_q(pv, vs, page_rows, lv, page_size)
    return tok


def paged_verify_step(model, pools, tokens, steps, pads, valid_cols,
                      block_table, samplers, lanes, top_k=0, scales=None):
    """One decode or speculative verify step for every slot, active or
    parked: ``tokens [S, W]`` holds each slot's pending token and its
    drafts (zero-padded; W = 1 without speculation); lane ``j`` writes at
    column ``steps[s] + j`` and every lane is scored in one pass, the
    paged-attention kernel at W queries per row. Returns
    ``(tok [S, W], probs)`` from `select_tokens_window` (``lanes[s]``:
    the lane a sampled row draws at); both stay on the device."""
    logits = model.verify_slots_paged(tokens, steps, pools, block_table,
                                      pads=pads, valid_cols=valid_cols,
                                      scales=scales)
    return select_tokens_window(logits.float(), samplers, top_k, lanes)


__all__ = ["paged_prefill_step", "paged_verify_step"]
