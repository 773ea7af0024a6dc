"""Serve-plane queue primitives: one thread-safe FIFO, one request type.

The port of the reference's ``serve/queue.py``, and the shared substrate of
every serving loop of the port: the async continuous-batching engine
(``repro_torch.serve.engine``), the synchronous KRR micro-batcher and the
LM slot scheduler (both in ``repro_torch.runtime.serve_loop``) queue their
work through ``FifoQueue``.

The interesting method is ``next_batch``: fill-or-timeout batch formation.
A waiting worker is woken as soon as (a) ``max_batch`` items are queued —
fill; (b) the oldest queued item has waited ``max_wait`` seconds —
timeout, serve a partial batch; or (c) some queued item's deadline would
expire before the timeout — serve early so the deadline can still be met.

Everything here is host-side Python (no torch): the queue is usable from
any thread.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Generic, Optional, TypeVar

import numpy as np

T = TypeVar("T")


class DeadlineMissError(RuntimeError):
    """A request's deadline expired before a batch could serve it.

    Raised *into the request's future* — a missed deadline is always a
    descriptive failure the caller observes, never a silent drop. The
    message names the request, how long it waited, and the batch policy
    that was in force, so capacity problems are diagnosable from the
    error alone.
    """


class UnknownModelError(KeyError):
    """A request named a model key with no published model behind it.

    Raised into the future at submit time (the router resolves keys
    eagerly so a typo fails fast). Engines with a ``fallback_model``
    route unknown keys there instead of raising.
    """

    def __str__(self) -> str:  # KeyError quotes its arg; keep the message
        return self.args[0] if self.args else ""


class EngineStoppedError(RuntimeError):
    """The engine stopped while this request was still queued.

    Set on every pending future at shutdown — like deadline misses,
    stopping the engine never silently drops queued work.
    """


class QueueFullError(RuntimeError):
    """A bounded queue rejected a push at its ``max_depth``.

    Backpressure, not buffering: past the configured depth every request
    already queued is going to miss its latency budget, so admitting
    more only converts future deadline misses into a longer queue. The
    engine sheds instead — the caller observes this error (counted in
    ``ServeStats.shed``) immediately, while the system is still
    saturated, rather than a ``DeadlineMissError`` seconds later.
    """


@dataclasses.dataclass
class ServeRequest:
    """One queued prediction request of the async serve plane.

    Attributes:
      uid:       engine-assigned monotonic id (diagnostics / error text).
      x:         the query point, host-side ``(dim,)`` array.
      model:     resolved model-slot key this request routes to.
      deadline:  absolute ``clock()`` time after which serving it is a
                 miss; ``None`` = no deadline.
      submitted: ``clock()`` time of submission (latency accounting).
      future:    resolves to a ``repro_torch.serve.ServeResult`` — or raises
                 ``DeadlineMissError`` / ``EngineStoppedError``.
    """

    uid: int
    x: np.ndarray
    model: str
    deadline: float | None = None
    submitted: float = 0.0
    future: Future = dataclasses.field(default_factory=Future)


class FifoQueue(Generic[T]):
    """Thread-safe FIFO with fill-or-timeout batch formation.

    Producers ``push`` items; consumers either ``pop``/``take``
    non-blockingly (the synchronous engines) or block in ``next_batch``
    (the async engine's worker). Arrival times are recorded per item so
    the fill-or-timeout window is measured from the *oldest* queued
    item, which is the quantity a latency SLO cares about.

    ``max_depth`` bounds the queue: a ``push`` that would exceed it
    raises ``QueueFullError`` instead of buffering without limit
    (``None`` = unbounded, the default).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 max_depth: int | None = None):
        if max_depth is not None and max_depth <= 0:
            raise ValueError(f"max_depth must be positive or None, got "
                             f"{max_depth}")
        self._clock = clock
        self.max_depth = max_depth
        self._cond = threading.Condition()
        self._items: deque[tuple[float, T]] = deque()

    def push(self, item: T) -> None:
        """Append one item and wake any batch-forming waiter.

        Raises ``QueueFullError`` when a ``max_depth`` is configured and
        the queue already holds that many items.
        """
        with self._cond:
            if (self.max_depth is not None
                    and len(self._items) >= self.max_depth):
                age = self._clock() - self._items[0][0]
                raise QueueFullError(
                    f"queue is full: {len(self._items)} items at "
                    f"max_depth={self.max_depth}, oldest has waited "
                    f"{age * 1e3:.1f} ms — the consumer is saturated; "
                    "shed load or raise max_depth")
            self._items.append((self._clock(), item))
            self._cond.notify_all()

    def pop(self) -> Optional[T]:
        """The oldest item, or ``None`` when empty (non-blocking)."""
        with self._cond:
            return self._items.popleft()[1] if self._items else None

    def take(self, k: int) -> list[T]:
        """Up to ``k`` oldest items, non-blocking (the sync micro-batch)."""
        with self._cond:
            out: list[T] = []
            while self._items and len(out) < k:
                out.append(self._items.popleft()[1])
            return out

    def drain(self) -> list[T]:
        """Remove and return everything queued (engine shutdown path)."""
        with self._cond:
            out = [item for _, item in self._items]
            self._items.clear()
            return out

    def kick(self) -> None:
        """Wake every waiter without enqueueing (stop-event delivery)."""
        with self._cond:
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def oldest_age(self) -> float | None:
        """Seconds the head item has been queued, or ``None`` if empty."""
        with self._cond:
            if not self._items:
                return None
            return self._clock() - self._items[0][0]

    def next_batch(self, max_batch: int, max_wait: float, *,
                   deadline_of: Callable[[T], float | None] | None = None,
                   stop: threading.Event | None = None,
                   idle_wait: float = 0.05,
                   deadline_guard: float = 0.005) -> list[T]:
        """Block until a batch is ready, then pop and return it.

        Fill-or-timeout: returns as soon as ``max_batch`` items are
        queued, OR the oldest item has waited ``max_wait`` seconds
        (partial batch), OR waiting any longer would expire some item's
        ``deadline_of(item)`` (serve early, meet the deadline). The
        deadline wake fires ``deadline_guard`` seconds *before* the
        earliest deadline — waking exactly at it would put the batch a
        scheduler tick past expiry every time. Returns ``[]`` — without
        popping — once ``stop`` is set; pair with ``kick()`` so shutdown
        doesn't wait out ``idle_wait``.
        """
        with self._cond:
            while True:
                if stop is not None and stop.is_set():
                    return []
                if len(self._items) >= max_batch:
                    break
                if self._items:
                    now = self._clock()
                    age = now - self._items[0][0]
                    if age >= max_wait:
                        break
                    timeout = max_wait - age
                    if deadline_of is not None:
                        dls = [d for d in (deadline_of(item)
                                           for _, item in self._items)
                               if d is not None]
                        if dls:
                            until_first = min(dls) - now - deadline_guard
                            if until_first <= 0:
                                break      # at/near a deadline: serve now
                            timeout = min(timeout, until_first)
                    self._cond.wait(timeout)
                else:
                    self._cond.wait(idle_wait)
            out: list[T] = []
            while self._items and len(out) < max_batch:
                out.append(self._items.popleft()[1])
            return out
