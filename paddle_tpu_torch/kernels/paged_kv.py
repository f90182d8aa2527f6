"""Paged KV-cache primitives: page arithmetic, the dense gather and the
page writers.

Counterpart: ``paddle_tpu/kernels/paged_kv.py:43-134``. There these are
XLA compositions (gather/scatter), not Pallas kernels, so here they stay
plain torch indexing. The JAX versions return new pools; the writers
here update the pool IN PLACE (``index_put_``), which saves a copy of a
pool that holds the whole serving KV cache.

A pool is ``[P, H, ps, D]`` (one per layer and per K/V); a block table
``[N, Pmax]`` int maps row ``n``'s logical page ``i`` to physical page
``block_table[n, i]``, so logical column ``c`` lives at
``pool[block_table[n, c // ps], :, c % ps]``.
"""
from __future__ import annotations

import torch


def pages_for(n_cols: int, page_size: int) -> int:
    """ceil(n_cols / page_size): pages needed to hold ``n_cols`` tokens."""
    return -(-int(n_cols) // int(page_size))


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor):
    """The dense logical view of each row: pool ``[P, H, ps, D]``,
    block_table ``[N, Pmax]`` -> ``[N, H, Pmax*ps, D]``. Used by the
    plain version of the paged-attention kernel only."""
    v = pool[block_table.long()]                 # [N, Pmax, H, ps, D]
    v = v.permute(0, 2, 1, 3, 4)                 # [N, H, Pmax, ps, D]
    n, h = v.shape[0], v.shape[1]
    return v.reshape(n, h, -1, pool.shape[-1])


def write_token_pages(pool: torch.Tensor, pages: torch.Tensor,
                      offsets: torch.Tensor, val: torch.Tensor):
    """Write one token per row into its own page, in place: pages and
    offsets ``[N]`` (physical page and in-page column per row), val
    ``[N, H, D]``. Returns ``pool``."""
    pool[pages.long(), :, offsets.long()] = val.to(pool.dtype)
    return pool


def scatter_prompt_pages(pool: torch.Tensor, page_rows: torch.Tensor,
                         local: torch.Tensor, page_size: int):
    """Write a prefilled local cache into its reserved pages, in place.

    local ``[n, H, bucket, D]``; page_rows ``[n, >=Pb]`` with
    ``Pb = pages_for(bucket, ps)`` (a whole block-table row works; only
    the first Pb entries are used). ``bucket`` need not be a multiple of
    ``page_size``: the tail of the last page is padded with zeros, and
    those columns are never read before a decode step overwrites them
    (every read is masked by the row's own cursor). Returns ``pool``.
    """
    n, h, bucket, d = local.shape
    pb = pages_for(bucket, page_size)
    pad = pb * page_size - bucket
    if pad:
        local = torch.cat([local, local.new_zeros((n, h, pad, d))], dim=2)
    tiles = local.reshape(n, h, pb, page_size, d).permute(0, 2, 1, 3, 4)
    flat = tiles.reshape(n * pb, h, page_size, d)
    pool[page_rows[:, :pb].reshape(-1).long()] = flat.to(pool.dtype)
    return pool


__all__ = ["pages_for", "gather_pages", "write_token_pages",
           "scatter_prompt_pages"]
