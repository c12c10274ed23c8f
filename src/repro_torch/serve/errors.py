"""The serving stack's typed error taxonomy, rooted at `ServeError`.

One leaf module with no dependencies, importable from anywhere in the
port (the decision layer `runtime/fault.py`, the column layer
`serve/fault.py` and `serve/engine.py`, tests) without layering cycles.
The port's own copy of the reference's `serve/errors.py`: the same class
names, bases and messages, so a caller catches the same families in both
packages. The LM classes (`PromptTooLong`, `EngineStalled`, `QueueFull`,
`RequestExpired`, `InsufficientPages`, `PagedCacheUnsupported`,
`TicketNotReady`) are kept for the LM engine, paged cache and front-end
that have no port yet; their docstrings name those layers.

Two deliberate exceptions to the RuntimeError mixin:

* `ColumnDeadError` / `ColumnHungError` are NOT `RuntimeError`s: retry
  loops whose ``retry_on`` covers `RuntimeError`
  (`runtime.fault.Supervisor.call`) must never swallow a death or a
  wedge — those resolve through drain/requeue and heartbeat timeout
  respectively, not through a retry.
* `PromptTooLong` and `PagedCacheUnsupported` are admission-boundary
  rejections of the REQUEST/MODEL, not engine outages, and keep their
  `ValueError`/`TypeError` bases.
"""
from __future__ import annotations

__all__ = [
    "ServeError", "PromptTooLong", "EngineStalled", "QueueFull",
    "RequestExpired", "InsufficientHealthyWorkers",
    "TransientDispatchError", "ColumnDeadError", "ColumnHungError",
    "InsufficientPages", "PagedCacheUnsupported", "TicketNotReady",
]


class ServeError(Exception):
    """Root of the serving error taxonomy (`serve/errors.py`)."""


class PromptTooLong(ServeError, ValueError):
    """A submitted prompt exceeds the engine's cache length (``max_len``).

    Raised at admission (`Engine.add_request`) — admitting it would blow
    up mid-bucket with a raw NumPy broadcast error (the bucket width is
    capped at ``max_len`` but the prompt row write is not) and wedge
    every request sharing the admission bucket. Rejecting at the
    boundary keeps one bad request from taking down a batch."""

    def __init__(self, rid, n_tokens: int, max_len: int):
        self.rid = rid
        self.n_tokens = int(n_tokens)
        self.max_len = int(max_len)
        super().__init__(
            f"request {rid}: prompt of {n_tokens} tokens exceeds the "
            f"engine cache length max_len={max_len}")


class EngineStalled(ServeError, RuntimeError):
    """`Engine.run_to_completion` exhausted ``max_steps`` with requests
    still queued or live. Carries the unfinished ``rids`` and the
    ``done`` subset — the caller decides whether to resubmit, extend the
    budget, or surface the outage; silently returning only the finished
    subset (the old behaviour) dropped work on the floor."""

    def __init__(self, unfinished, done=None):
        self.unfinished = list(unfinished)
        self.done = list(done) if done is not None else []
        super().__init__(
            f"engine stalled with {len(self.unfinished)} unfinished "
            f"request(s) after the step budget: rids {self.unfinished}")


class QueueFull(ServeError, RuntimeError):
    """The bounded admission queue is at capacity — typed backpressure.

    The caller sheds load or retries later; the engine never grows the
    queue past ``max_queue``. Carries the rejected ``rid`` and the queue
    ``depth`` at rejection time."""

    def __init__(self, rid, depth: int, max_queue: int):
        self.rid = rid
        self.depth = int(depth)
        self.max_queue = int(max_queue)
        super().__init__(
            f"request {rid} rejected: admission queue at capacity "
            f"({depth}/{max_queue})")


class RequestExpired(ServeError, RuntimeError):
    """A request's TTL elapsed before it could be admitted.

    Raised at `FaultTolerantEngine.add_request` for a dead-on-arrival
    TTL; requests that expire while QUEUED are dropped into
    `FaultTolerantEngine.expired` at the next step instead (there is no
    caller on the stack to throw to)."""

    def __init__(self, rid, ttl: float):
        self.rid = rid
        self.ttl = float(ttl)
        super().__init__(f"request {rid} expired (ttl {ttl:g}s)")


class InsufficientHealthyWorkers(ServeError, RuntimeError):
    """Too few healthy workers/columns/slots to satisfy the requested
    plan.

    Raised by `runtime.fault.elastic_plan` when the healthy-chip count
    cannot cover the fixed model axis, by the serving layer when every
    column of a fleet is dead (`serve/engine.py:ColumnScheduler`), and
    by the LM supervision layer when no healthy slot remains with work
    pending (`serve/engine_fault.py`) — the caller decides whether to
    shrink the plan, wait for capacity, or surface the outage."""


class TransientDispatchError(ServeError, RuntimeError):
    """A retryable dispatch failure (flaky link, preempted worker slot).

    The worker/column is expected to survive; `Supervisor.call` retries
    these with capped exponential backoff."""


class ColumnDeadError(ServeError):
    """A column died and will never answer again.

    NOT a `RuntimeError` on purpose: retry loops whose `retry_on`
    includes `RuntimeError` must not swallow a death. The serving layer
    reacts by draining the column and requeuing its unretired work
    (`serve/fault.py`)."""

    def __init__(self, column: int, message: str = ""):
        self.column = int(column)
        super().__init__(message or f"column {column} died")


class ColumnHungError(ServeError):
    """A simulated WEDGED column: the dispatch neither completes nor
    errors (no retire, so no heartbeat). Only the injector raises this —
    a real hung dispatch just never returns — and only the supervision
    loop's heartbeat timeout can declare the column dead. NOT a
    `RuntimeError` for the same no-swallowing reason as
    `ColumnDeadError`."""

    def __init__(self, column: int):
        self.column = int(column)
        super().__init__(f"column {column} is hung (no retire, no error)")


class InsufficientPages(ServeError, RuntimeError):
    """The page pool cannot cover an allocation.

    Raised at `PagedEngine.add_request` when a request's worst-case page
    footprint exceeds the POOL CAPACITY (it could never be admitted —
    rejecting at the boundary mirrors `PromptTooLong`), and by
    `serve.paged.PagePool.alloc` on a direct over-allocation. A request
    that merely exceeds the FREE count right now is not an error: it
    waits in the queue until decoding frees pages (that wait is the
    admission backpressure)."""

    def __init__(self, need: int, free: int, capacity: int):
        self.need = int(need)
        self.free = int(free)
        self.capacity = int(capacity)
        super().__init__(
            f"page pool cannot cover {need} page(s): {free} free of "
            f"{capacity} total")


class PagedCacheUnsupported(ServeError, TypeError):
    """The model's cache cannot be paged.

    Paging requires every cache leaf to carry named "batch" and "seq"
    axes (attention K/V rings and linear caches do); recurrent state
    leaves (rwkv/mamba) have no sequence axis — their state IS the whole
    history — and enc-dec decoders admit token-at-a-time. Those serve on
    the dense `Engine` path instead."""


class TicketNotReady(ServeError, RuntimeError):
    """`Ticket.result()` was called before the work completed — drive
    the front-end (`ServeFrontend.run` / `pump`) first."""

    def __init__(self, tid, status: str):
        self.tid = tid
        self.status = str(status)
        super().__init__(
            f"ticket {tid} is not done (status {status!r}); run the "
            f"front-end before reading results")
