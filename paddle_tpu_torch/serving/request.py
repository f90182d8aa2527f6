"""Request records and streaming handles for the serving engine.

Counterpart: ``paddle_tpu/serving/request.py`` (the prefix-cache and
chunked-prefill fields of :75-83 included), without deadlines,
tracing, timelines and the background thread. A request lives through
QUEUED -> DECODING -> (FINISHED | CANCELLED). The `RequestHandle` that
`Engine.submit` returns is the client surface: `tokens()` streams the
generated ids, `result()` returns the whole continuation, `cancel()`
frees the request's slot and pages. The engine is cooperative: a handle
that waits for a token drives ``engine.step()`` itself.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from .errors import ServingError

#: request lifecycle states
QUEUED = "queued"
DECODING = "decoding"
FINISHED = "finished"
CANCELLED = "cancelled"


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
    emitted: list = field(default_factory=list)
    submit_time: float = field(default_factory=time.perf_counter)

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
        self._closed = False
        self._error: BaseException | None = None

    # -- engine side ---------------------------------------------------
    def _close(self, error: BaseException | None = None):
        """First close wins: a later close cannot overwrite the cause."""
        if not self._closed:
            self._closed = True
            self._error = error

    # -- client side ---------------------------------------------------
    def cancel(self):
        """Stop generating: a queued request is dropped, an active one
        frees its slot and pages at once."""
        self._engine._cancel(self._req)

    def tokens(self, timeout=None):
        """Iterate the generated ids as the engine emits them, stepping
        the engine while the next one is not there yet (the reference's
        cooperative mode, ``paddle_tpu/serving/request.py:263-312``).

        ``timeout`` (seconds) bounds the wait for the NEXT token: when
        neither a token nor a terminal state has come within it, checked
        between engine steps, the iterator raises `TimeoutError`. The
        request keeps its place; a later `tokens` or `result` call picks
        the stream up again."""
        i = 0
        last_progress = time.monotonic()
        while True:
            while i < len(self._req.emitted):
                last_progress = time.monotonic()
                yield self._req.emitted[i]
                i += 1
            if self._closed:
                self._raise_if_failed()
                return
            if (timeout is not None
                    and time.monotonic() - last_progress > timeout):
                raise TimeoutError(
                    f"request {self._req.rid}: no token or terminal state "
                    f"within {timeout}s ({len(self._req.emitted)} tokens "
                    "so far)")
            if not self._engine.step():
                raise RuntimeError(
                    f"request {self._req.rid} is unfinished but the engine "
                    "has no work")

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
        """Tokens emitted so far."""
        return list(self._req.emitted)


__all__ = ["SamplingParams", "Request", "RequestHandle",
           "QUEUED", "DECODING", "FINISHED", "CANCELLED"]
