"""The dense slot KV cache: one ``[slots, heads, max_len, head_dim]``
cache per layer.

Counterpart: ``paddle_tpu/serving/kv_slots.py``. The engine's default
when no paged feature is asked for (``Engine(kv_mode="slots")``). The
caches come from the model's ``gen_static_cache`` and never change
shape: admission writes a prompt's K/V into a free slot row (the steps
write in place), decode writes one column per slot, and recycling only
marks the row free. Stale K/V is never readable: every attention view is
masked by the slot's own ``steps`` and ``valid_cols``, and a new
tenant's prefill overwrites the columns it will read.
"""
from __future__ import annotations

import numpy as np


class SlotKVCache:
    """The per-layer slot caches plus the per-slot host state the steps
    read (``steps``, ``pads``, ``valid_cols``, ``active``)."""

    def __init__(self, model, slots: int, max_len: int, dtype=None):
        self.slots = int(slots)
        self.max_len = int(max_len)
        # gen_static_cache checks max_len against the position table and
        # takes the weight dtype, as generate() does, unless ``dtype``
        # names another (``Engine(dtype=)``, ``kv_slots.py:32-38``)
        self.caches = model.gen_static_cache(self.slots, self.max_len,
                                             dtype=dtype)
        self.num_layers = len(self.caches)
        self.steps = np.zeros((self.slots,), np.int32)     # next write col
        self.pads = np.zeros((self.slots,), np.int32)      # left-pad count
        self.valid_cols = np.zeros((self.slots, self.max_len), np.int32)
        self.active = np.zeros((self.slots,), bool)

    def occupy(self, slot: int, bucket_len: int, prompt_len: int):
        """Claim ``slot`` for a prompt left-padded to ``bucket_len``: the
        real tokens sit right-aligned in ``[0, bucket_len)``, the first
        decode write is column ``bucket_len``."""
        pad = bucket_len - prompt_len
        self.steps[slot] = bucket_len
        self.pads[slot] = pad
        self.valid_cols[slot, :pad] = 0
        self.valid_cols[slot, pad:] = 1
        self.active[slot] = True

    def release(self, slot: int):
        """Free the slot. Its cursor parks at 0: a free slot still rides
        every decode step, and column 0 is overwritten by the next
        tenant's prefill before it can be read."""
        self.active[slot] = False
        self.steps[slot] = 0
        self.valid_cols[slot, :] = 0

    def advance(self, slot: int):
        self.steps[slot] += 1

    @property
    def occupancy(self) -> int:
        return int(self.active.sum())

    def memory_bytes(self) -> int:
        """slots x layers x 2 x heads x max_len x head_dim x itemsize."""
        k0 = self.caches[0][0]
        return (self.slots * self.num_layers * 2 * int(k0.shape[1])
                * self.max_len * int(k0.shape[3]) * k0.element_size())


__all__ = ["SlotKVCache"]
