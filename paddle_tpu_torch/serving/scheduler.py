"""Iteration-level (continuous) scheduler: queue -> free slots.

Counterpart: ``paddle_tpu/serving/scheduler.py``, without the timeline
marks. Every engine iteration first admits
queued requests into free slots (bucketed prefill), then runs one decode
step for all slots; finished slots recycle at once. Admission is FCFS:
it pops in arrival order and stops at the first request with no free
slot, or (paged pool exhausted) puts that request back at the head.
Requests are validated at submit (prompt fits a bucket, bucket +
max_new, plus the ``spec_k`` verify lanes every step writes past the
cursor, fits the cache), so admission cannot fail on shape later.
"""
from __future__ import annotations

from collections import deque

from .request import CANCELLED, QUEUED, Request


class SlotScheduler:
    def __init__(self, slots: int, buckets, max_len: int,
                 spec_cols: int = 0):
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets:
            raise ValueError("prefill_buckets must be non-empty")
        if self.buckets[-1] > max_len:
            raise ValueError(
                f"largest prefill bucket {self.buckets[-1]} exceeds the "
                f"cache max_len {max_len}")
        self.max_len = int(max_len)
        #: columns every slot may write past its token budget: the
        #: speculative verify window (Engine(spec_k=k) writes k lanes
        #: past the cursor on every step, the last one included)
        self.spec_cols = int(spec_cols)
        self._free = deque(range(slots))
        self._queue: deque[Request] = deque()

    # -- submit side ----------------------------------------------------
    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds every prefill bucket "
            f"{self.buckets} — add a larger bucket or truncate")

    def validate(self, req: Request) -> int:
        bucket = self.bucket_for(req.prompt_len)
        need = bucket + req.max_new_tokens + self.spec_cols
        if need > self.max_len:
            spec = (f" + {self.spec_cols} speculative verify lanes "
                    f"(spec_k)" if self.spec_cols else "")
            raise ValueError(
                f"prompt bucket {bucket} + max_new_tokens "
                f"{req.max_new_tokens}{spec} = {need} exceeds the "
                f"engine's max_len {self.max_len}")
        return bucket

    def enqueue(self, req: Request):
        req.bucket = self.validate(req)
        self._queue.append(req)

    # -- iteration side -------------------------------------------------
    def next_admission(self):
        """Pop the queue head with a free slot assigned (``req.slot``), or
        None; requests cancelled while queued are dropped."""
        while self._queue:
            if self._queue[0].state == CANCELLED:
                self._queue.popleft()
                continue
            if not self._free:
                return None
            req = self._queue.popleft()
            req.slot = self._free.popleft()
            return req
        return None

    def release(self, slot: int):
        self._free.append(slot)

    def requeue_admission(self, req: Request):
        """Undo `next_admission` (the page pool is exhausted): the
        request returns to the queue HEAD and its slot to the free list,
        so FCFS holds and a large request is not starved."""
        if req.slot is not None:
            self._free.appendleft(req.slot)
            req.slot = None
        self._queue.appendleft(req)

    def drop_queued(self, req: Request) -> bool:
        """Remove a still-queued request (cancelled before admission)."""
        if req.state == QUEUED and req in self._queue:
            self._queue.remove(req)
            return True
        return False

    def queued_requests(self) -> tuple:
        """Snapshot of the queue in FCFS order."""
        return tuple(self._queue)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)


__all__ = ["SlotScheduler"]
