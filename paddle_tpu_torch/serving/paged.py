"""Paged KV cache for the serving engine.

Counterpart: ``paddle_tpu/serving/paged.py``, without refcounted sharing
(the prefix cache and disaggregated handoffs are later slices).

- `PagePool`: the physical layer. Per-layer device pools ``[pages + 1,
  heads, page_size, head_dim]`` (from the model's ``gen_page_pool``)
  and the free list. The last page is the SENTINEL: parked (inactive)
  slots still ride every decode step, and their block-table rows all
  name the sentinel, so their writes land where no tenant ever reads.
  With ``kv_quant="int8"`` or ``"fp8"`` the pages are 1-byte (int8 or
  float8_e4m3fn) and per-layer f32 scale arrays ``[pages + 1, heads,
  page_size]`` (the model's ``gen_page_scales``) ride beside them:
  about ``dtype_bytes / (1 + 4 / head_dim)`` times the pages per byte
  (`bytes_per_page`, `pages_in_budget`).
- `PagedKVCache`: the engine's view. A fixed-shape int32 block table
  ``[slots, max_pages]`` maps each slot's logical pages to pool pages,
  next to the host mirrors the decode step reads (``steps``, ``pads``,
  ``valid_cols``, ``active``).

A request's whole page budget, ``ceil((bucket + max_new - 1 + k) /
ps)`` with ``k`` the speculative verify lanes (`pages_needed`), is
reserved at admission (`try_reserve`), so the pool can only run out at
admission, where the request simply stays queued; `release` returns the
pages.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..kernels.paged_kv import pages_for


#: kv_quant mode -> the dtype of its 1-byte pages
_QUANT_PAGE_DTYPES = {"int8": "int8", "fp8": "float8_e4m3fn"}


class PagePool:
    """Per-layer device page pools (and scales on a quantized pool) plus
    the host free list."""

    def __init__(self, model, pages: int, page_size: int, kv_quant=None):
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.pages_total = int(pages)
        if self.pages_total < 1:
            raise ValueError(f"kv_pages must be >= 1, got {pages}")
        if kv_quant not in (None, *_QUANT_PAGE_DTYPES):
            raise ValueError(f"kv_quant must be None, 'int8' or 'fp8', "
                             f"got {kv_quant!r}")
        #: None (pages in the model dtype), "int8" or "fp8"
        self.kv_quant = kv_quant
        #: per-layer (k_pool, v_pool), written in place by the steps
        self.caches = model.gen_page_pool(
            self.pages_total + 1, self.page_size,
            dtype=_QUANT_PAGE_DTYPES.get(kv_quant))
        #: per-layer (k_scale, v_scale) [pages + 1, H, ps] f32 of a
        #: quantized pool, written beside the pages; None otherwise
        self.scales = (model.gen_page_scales(self.pages_total + 1,
                                             self.page_size)
                       if kv_quant else None)
        self.num_layers = len(self.caches)
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

    def bytes_per_page(self) -> int:
        """Device bytes one page costs across all layers, K and V: ``layers
        x 2 x heads x page_size x (head_dim x page bytes + 4 scale bytes
        on a quantized pool)``."""
        k0 = self.caches[0][0]
        per_tok_head = int(k0.shape[3]) * k0.element_size()
        if self.scales is not None:
            per_tok_head += self.scales[0][0].element_size()
        return (self.num_layers * 2 * int(k0.shape[1]) * self.page_size
                * per_tok_head)

    def memory_bytes(self) -> int:
        """(pages + the sentinel) x `bytes_per_page`: the pool's device
        bytes at the stored dtype."""
        return (self.pages_total + 1) * self.bytes_per_page()


def pages_in_budget(model, byte_budget: int, page_size: int = 16,
                    kv_quant=None) -> int:
    """Pool pages (the sentinel not counted) that fit ``byte_budget``
    device bytes in the given storage mode: the inverse of
    `PagePool.bytes_per_page`, read off a one-page probe pool (so the
    model's ``gen_page_pool`` owns the layout). At one budget,
    ``kv_quant="int8"`` or ``"fp8"`` gives about ``dtype_bytes / (1 + 4 /
    head_dim)`` times the pages."""
    probe = PagePool(model, 1, int(page_size), kv_quant=kv_quant)
    return max(1, int(byte_budget) // probe.bytes_per_page() - 1)


class PagedKVCache:
    """Per-engine view over a `PagePool` plus host-side slot state."""

    def __init__(self, model, slots: int, max_len: int, page_size: int = 16,
                 pages: int | None = None, kv_quant=None):
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.max_pages = pages_for(self.max_len, int(page_size))
        # the position-table check gen_static_cache applies (allocates
        # nothing at batch 0)
        model.gen_static_cache(0, self.max_len)
        self.pool = PagePool(
            model, self.slots * self.max_pages if pages is None else pages,
            page_size, kv_quant=kv_quant)
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
    def scales(self):
        """Per-layer (k_scale, v_scale) of a quantized pool, else None."""
        return self.pool.scales

    @property
    def kv_quant(self):
        return self.pool.kv_quant

    def bytes_per_page(self) -> int:
        return self.pool.bytes_per_page()

    def memory_bytes(self) -> int:
        return self.pool.memory_bytes()

    @property
    def pages_total(self) -> int:
        return self.pool.pages_total

    @property
    def pages_free(self) -> int:
        return self.pool.pages_free

    @property
    def pages_in_use(self) -> int:
        return self.pool.pages_in_use

    def pages_needed(self, bucket_len: int, max_new_tokens: int,
                     extra_cols: int = 0) -> int:
        """Columns a request can write: the prompt ``[0, bucket)`` plus
        ``max_new - 1`` decode writes (prefill gives the first token),
        plus ``extra_cols`` in-flight verify lanes (``Engine(spec_k=k)``
        writes ``k`` columns past the cursor every step, the last one
        included, so the budget owns them and no verify write spills
        onto the shared sentinel page)."""
        cols = (int(bucket_len) + max(0, int(max_new_tokens) - 1)
                + max(0, int(extra_cols)))
        return pages_for(cols, self.page_size)

    def try_reserve(self, slot: int, bucket_len: int,
                    max_new_tokens: int, extra_cols: int = 0) -> bool:
        """Reserve the slot's whole page budget into its block-table row;
        False = pool exhausted (the caller requeues the request)."""
        need = self.pages_needed(bucket_len, max_new_tokens, extra_cols)
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
        """Move the slot's cursor one column on. A speculative step calls
        it once per emitted token; the rejected lanes' K/V past the
        cursor stays masked until the next window overwrites it, so a
        rollback is this cursor edit alone."""
        self.steps[slot] += 1

    @property
    def occupancy(self) -> int:
        return int(self.active.sum())

    def slot_page_counts(self) -> tuple:
        return tuple(len(p) for p in self._slot_pages)


__all__ = ["PagePool", "PagedKVCache", "pages_in_budget"]
