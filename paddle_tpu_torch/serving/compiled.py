"""The per-step functions of the paged engine.

Counterpart: ``paddle_tpu/serving/compiled.py`` — `build_paged_prefill_fn`
(:247-304) and `build_paged_decode_step_fn` (:355-395). There each is a
jitted executable over static shapes; here each is a plain function that
runs eagerly (graph capture per shape bucket is later work). Both write
the page pools in place and return the selected tokens as a device
tensor.
"""
from __future__ import annotations

from ..kernels.paged_kv import scatter_prompt_pages
from ..models.generation import select_tokens


def paged_prefill_step(model, pools, ids, amask, page_rows, page_size,
                       samplers, top_k=0):
    """Prompt pass for ``ids [n, bucket]`` (left-padded; ``amask`` marks
    the real tokens): the prompt K/V is computed in a local ``[n, H,
    bucket, D]`` cache and scattered into each row's reserved pages
    (``page_rows [n, >=pages_for(bucket)]``; ``bucket`` need not be a
    multiple of ``page_size``). Returns each row's first token ``[n]``."""
    n, bucket = ids.shape
    local = model.gen_static_cache(n, bucket)
    logits, local = model.prefill(ids, local, pad_mask=amask)
    tok = select_tokens(logits[:, -1].float(), samplers, top_k)
    for (pk, pv), (lk, lv) in zip(pools, local):
        scatter_prompt_pages(pk, page_rows, lk, page_size)
        scatter_prompt_pages(pv, page_rows, lv, page_size)
    return tok


def paged_decode_step(model, pools, tokens, steps, pads, valid_cols,
                      block_table, samplers, top_k=0):
    """One decode step for every slot, active or parked: row ``s`` writes
    at logical column ``steps[s]`` through its block-table row and
    attends its own window. Returns the next token of every row ``[S]``;
    the engine reads only the active rows."""
    logits = model.decode_slots_paged(tokens[:, None], steps, pools,
                                      block_table, pads=pads,
                                      valid_cols=valid_cols)
    return select_tokens(logits[:, -1].float(), samplers, top_k)


__all__ = ["paged_prefill_step", "paged_decode_step"]
