"""Paged KV cache for the serving engine.

Counterpart: ``paddle_tpu/serving/paged.py``, without refcounted sharing
(the prefix cache and disaggregated handoffs are later slices).

- `PagePool`: the physical layer. Per-layer device pools ``[pages + 1,
  heads, page_size, head_dim]`` (from the model's ``gen_page_pool``)
  and the free list. The last page is the SENTINEL: parked (inactive)
  slots still ride every decode step, and their block-table rows all
  name the sentinel, so their writes land where no tenant ever reads.
- `PagedKVCache`: the engine's view. A fixed-shape int32 block table
  ``[slots, max_pages]`` maps each slot's logical pages to pool pages,
  next to the host mirrors the decode step reads (``steps``, ``pads``,
  ``valid_cols``, ``active``).

A request's whole page budget, ``ceil((bucket + max_new - 1) / ps)``,
is reserved at admission (`try_reserve`), so the pool can only run out
at admission, where the request simply stays queued; `release` returns
the pages.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..kernels.paged_kv import pages_for


class PagePool:
    """Per-layer device page pools plus the host free list."""

    def __init__(self, model, pages: int, page_size: int):
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.pages_total = int(pages)
        if self.pages_total < 1:
            raise ValueError(f"kv_pages must be >= 1, got {pages}")
        #: per-layer (k_pool, v_pool), written in place by the steps
        self.caches = model.gen_page_pool(self.pages_total + 1,
                                          self.page_size)
        self.sentinel = self.pages_total       # parked-slot write target
        self._free = deque(range(self.pages_total))

    def alloc(self, n: int):
        """Take ``n`` pages off the free list; None (list untouched) when
        fewer are free."""
        if int(n) > len(self._free):
            return None
        return [self._free.popleft() for _ in range(int(n))]

    def free(self, pages):
        self._free.extend(pages)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.pages_total - self.pages_free


class PagedKVCache:
    """Per-engine view over a `PagePool` plus host-side slot state."""

    def __init__(self, model, slots: int, max_len: int, page_size: int = 16,
                 pages: int | None = None):
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.max_pages = pages_for(self.max_len, int(page_size))
        # the position-table check gen_static_cache applies (allocates
        # nothing at batch 0)
        model.gen_static_cache(0, self.max_len)
        self.pool = PagePool(
            model, self.slots * self.max_pages if pages is None else pages,
            page_size)
        self.page_size = self.pool.page_size
        self.logical_len = self.max_pages * self.page_size
        sentinel = self.pool.sentinel
        self.block_table = np.full((self.slots, self.max_pages), sentinel,
                                   np.int32)
        self.steps = np.zeros((self.slots,), np.int32)
        self.pads = np.zeros((self.slots,), np.int32)
        self.valid_cols = np.zeros((self.slots, self.logical_len), np.int32)
        self.active = np.zeros((self.slots,), bool)
        self._slot_pages: list[list[int]] = [[] for _ in range(self.slots)]

    @property
    def caches(self):
        return self.pool.caches

    @property
    def pages_total(self) -> int:
        return self.pool.pages_total

    @property
    def pages_free(self) -> int:
        return self.pool.pages_free

    @property
    def pages_in_use(self) -> int:
        return self.pool.pages_in_use

    def pages_needed(self, bucket_len: int, max_new_tokens: int) -> int:
        """Columns a request can write: the prompt ``[0, bucket)`` plus
        ``max_new - 1`` decode writes (prefill gives the first token)."""
        return pages_for(int(bucket_len) + max(0, int(max_new_tokens) - 1),
                         self.page_size)

    def try_reserve(self, slot: int, bucket_len: int,
                    max_new_tokens: int) -> bool:
        """Reserve the slot's whole page budget into its block-table row;
        False = pool exhausted (the caller requeues the request)."""
        need = self.pages_needed(bucket_len, max_new_tokens)
        got = self.pool.alloc(need)
        if got is None:
            return False
        self._slot_pages[slot] = got
        self.block_table[slot] = self.pool.sentinel
        self.block_table[slot, :need] = got
        return True

    def occupy(self, slot: int, bucket_len: int, prompt_len: int):
        """Claim ``slot`` (pages reserved): the prompt sits right-aligned
        in ``[0, bucket)``, the next write column is ``bucket``."""
        pad = bucket_len - prompt_len
        self.steps[slot] = bucket_len
        self.pads[slot] = pad
        self.valid_cols[slot, :pad] = 0
        self.valid_cols[slot, pad:] = 1
        self.active[slot] = True

    def release(self, slot: int):
        """Free the slot's pages and park its row on the sentinel page."""
        self.active[slot] = False
        self.steps[slot] = 0
        self.valid_cols[slot, :] = 0
        self.pool.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.block_table[slot] = self.pool.sentinel

    def advance(self, slot: int):
        self.steps[slot] += 1

    @property
    def occupancy(self) -> int:
        return int(self.active.sum())

    def slot_page_counts(self) -> tuple:
        return tuple(len(p) for p in self._slot_pages)


__all__ = ["PagePool", "PagedKVCache"]
