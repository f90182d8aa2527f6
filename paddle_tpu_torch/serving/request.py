"""Request records and streaming handles for the serving engine.

Counterpart: ``paddle_tpu/serving/request.py`` (the prefix-cache and
chunked-prefill fields of :75-83, the deadline fields of :84-98, the
timeline of :115-119 and both waiting modes of :263-345), without the
distributed trace context (ROADMAP A9). A request lives through QUEUED
-> DECODING -> (FINISHED | CANCELLED); its `timeline.Timeline` records
where the time went. The `RequestHandle` that `Engine.submit` returns
is the client surface: `tokens()` streams the generated ids,
`result()` returns the whole continuation, `cancel()` frees the
request's slot and pages. Handles are thread-safe: the engine streams
tokens into the handle's queue, and a handle that waits for one blocks
on that queue (with a bounded wait) while its engine runs a background
loop (`Engine.start`), or steps the engine itself while it does not
(the cooperative mode).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

from .errors import ServingError

#: request lifecycle states
QUEUED = "queued"
DECODING = "decoding"
FINISHED = "finished"
CANCELLED = "cancelled"

_SENTINEL = object()


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode parameters: ``strategy`` is 'greedy_search' or
    'sampling'; temperature and top_p are per request, ``top_k`` must
    match the engine's (it configures every sampled row alike)."""
    strategy: str = "greedy_search"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    @property
    def greedy(self) -> bool:
        return self.strategy == "greedy_search"


@dataclass
class Request:
    """Engine-internal record of one submit."""
    rid: int
    prompt: "object"                 # np.ndarray [len] int64
    max_new_tokens: int
    eos_token_id: int | None
    params: SamplingParams
    state: str = QUEUED
    slot: int | None = None
    bucket: int | None = None
    #: set by cancel() and never cleared
    cancel_requested: bool = False
    handle: "RequestHandle | None" = None
    #: `torch.Generator` of a sampled request (None when greedy): one
    #: draw per decode or verify step
    generator: "object" = None
    #: the sampled request's seed (None when greedy); the speculative
    #: drafts and accept uniforms derive from (seed, counter)
    seed: int | None = None
    #: tokens sampled so far (the sampling step index)
    counter: int = 0
    #: prompt tokens mapped from the prefix cache at admission (a
    #: multiple of the page size; 0 without a match)
    prefix_len: int = 0
    #: the prefill bucket of the uncached tail (prefix-cache admission)
    tail_bucket: int | None = None
    #: the next prompt column a chunked admission absorbs
    chunk_pos: int = 0
    #: the mixed steps a chunked admission takes
    prefill_chunks: int = 0
    #: the deadline (`submit(deadline_s=)` or the engine's default):
    #: ``deadline_s`` the client's budget, ``deadline_t`` the
    #: perf_counter instant it expires (None: no deadline)
    deadline_s: float | None = None
    deadline_t: float | None = None
    #: the paged admission's retry state: failed reservations so far,
    #: the pool's free count at the last one (a retry before it changes
    #: is pointless) and the earliest instant of the next attempt
    exhaustion_retries: int = 0
    retry_free_seen: int | None = None
    retry_after_t: float = 0.0
    emitted: list = field(default_factory=list)
    #: the perf_counter instant of each emitted token (the SLO's
    #: inter-token latency)
    token_times: list = field(default_factory=list)
    submit_time: float = field(default_factory=time.perf_counter)
    first_token_time: float | None = None
    finish_time: float | None = None
    #: the phase `timeline.Timeline`, started at submit
    timeline: "object" = None
    #: the distributed trace context (`observability.tracing.
    #: TraceContext`), minted by the engine at submit
    trace: "object" = None

    def __post_init__(self):
        if self.timeline is None:
            from .timeline import Timeline
            self.timeline = Timeline(t0=self.submit_time)

    @property
    def aid(self):
        """The id of the request's async trace lane: its trace id once
        minted, else the rid (``request.py:134-138``)."""
        return self.trace.trace_id if self.trace is not None else self.rid

    @property
    def hop(self) -> int:
        """The trace hop (0: the engine the request was submitted to)."""
        return self.trace.hop if self.trace is not None else 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return self.state in (FINISHED, CANCELLED)


class RequestHandle:
    """Client handle for one request (``submit() -> handle``)."""

    def __init__(self, engine, request: Request):
        self._engine = engine
        self._req = request
        self._q: queue.Queue = queue.Queue()
        self._done = threading.Event()
        self._error: BaseException | None = None
        #: the first closer wins, atomically: a raced second close never
        #: overwrites the cause the first one wrote
        self._close_once = threading.Lock()
        self._closed = False

    # -- engine side ---------------------------------------------------
    def _emit(self, token: int):
        self._q.put(int(token))

    def _close(self, error: BaseException | None = None):
        """First close wins; it alone closes the timeline with its typed
        cause and records it in the engine's `TimelineRing`."""
        with self._close_once:
            first = not self._closed
            self._closed = True
            if first:
                self._error = error
        if first:
            self._finalize(error)
        self._q.put(_SENTINEL)
        self._done.set()

    def _finalize(self, error):
        """The terminal funnel (``request.py:194-233``): the timeline's
        typed close, the engine's SLO observation and its ring's record,
        once. It never raises: a failure here is counted on
        ``serving_timeline_finalize_failures_total``, so an accounting
        fault cannot mask the close path (a death's sweep runs
        through it)."""
        from .timeline import cause_of

        try:
            req = self._req
            cause = cause_of(req.state, error)
            if not req.timeline.close(cause, error):
                return
            tracker = getattr(self._engine, "slo", None)
            if tracker is not None:
                tracker.observe(req, cause)
            ring = getattr(self._engine, "timelines", None)
            if ring is not None:
                ring.record(req)
        except Exception:  # noqa: BLE001 - counted, see the docstring
            from ..observability import get_registry
            get_registry().counter(
                "serving_timeline_finalize_failures_total",
                "request terminal-accounting (timeline close / SLO "
                "observe / exemplar record) failures swallowed by the "
                "handle close path").inc()

    # -- client side ---------------------------------------------------
    @property
    def state(self) -> str:
        return self._req.state

    @property
    def timeline(self):
        """The request's phase `timeline.Timeline`, readable at any time;
        closed with a typed cause when the request ends."""
        return self._req.timeline

    def done(self) -> bool:
        """True once the request finished, failed or was cancelled (its
        tokens may still wait in the stream: `tokens` drains them)."""
        return self._done.is_set()

    def cancel(self):
        """Stop generating: a queued request is dropped, an active one
        frees its slot and pages at once."""
        self._engine._cancel(self._req)

    def tokens(self, timeout=None):
        """Iterate the generated ids as the engine emits them. While the
        engine runs its background loop the iterator waits on the
        handle's stream, 50 ms at a time; otherwise it steps the engine
        itself (the cooperative mode).

        ``timeout`` (seconds) bounds the wait for the NEXT token: when
        neither a token nor a terminal state has come within it, checked
        between waits, the iterator raises `TimeoutError`. The request
        keeps its place; a later `tokens` or `result` call picks the
        stream up again."""
        last_progress = time.monotonic()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                if self._done.is_set():
                    # emitted and closed between the read and this check:
                    # drain, do not drop
                    while True:
                        try:
                            item = self._q.get_nowait()
                        except queue.Empty:
                            self._raise_if_failed()
                            return
                        if item is _SENTINEL:
                            self._raise_if_failed()
                            return
                        yield item
                if (timeout is not None
                        and time.monotonic() - last_progress > timeout):
                    raise TimeoutError(
                        f"request {self._req.rid}: no token or terminal "
                        f"state within {timeout}s "
                        f"({len(self._req.emitted)} tokens so far)")
                if self._engine.running:
                    try:
                        item = self._q.get(timeout=0.05)
                    except queue.Empty:
                        continue
                else:
                    if (not self._engine.step() and self._q.empty()
                            and not self._done.is_set()):
                        if self._req.state != QUEUED:
                            raise RuntimeError(
                                f"request {self._req.rid} is unfinished "
                                "but the engine has no work")
                        # queued behind an admission retry's backoff
                        time.sleep(0.001)
                    continue
            if item is _SENTINEL:
                self._raise_if_failed()
                return
            last_progress = time.monotonic()
            yield item

    def _raise_if_failed(self):
        if self._error is None:
            return
        if isinstance(self._error, ServingError):
            raise self._error
        raise RuntimeError(
            f"serving engine failed while request {self._req.rid} was "
            f"in flight ({len(self._req.emitted)} tokens emitted)"
        ) from self._error

    def result(self, timeout=None) -> list:
        """The whole continuation (an EOS token, when hit, included).
        ``timeout`` bounds each wait for a token, as in `tokens`
        (``request.py:333-345``)."""
        for _ in self.tokens(timeout=timeout):
            pass
        return list(self._req.emitted)

    @property
    def partial(self) -> list:
        """Tokens emitted so far: the readable remainder of a request
        that missed its deadline mid-decode."""
        return list(self._req.emitted)

    @property
    def ttft(self) -> float | None:
        """Seconds from submit to the first token (None before it)."""
        if self._req.first_token_time is None:
            return None
        return self._req.first_token_time - self._req.submit_time


__all__ = ["SamplingParams", "Request", "RequestHandle",
           "QUEUED", "DECODING", "FINISHED", "CANCELLED"]
