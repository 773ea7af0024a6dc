"""The serve plane's FIFO, the port of ``serve/queue.py::FifoQueue``.

Only what the synchronous ``ServeEngine`` uses: ``push``, the
non-blocking ``pop``/``take``/``drain`` and ``len``. The reference's
fill-or-timeout ``next_batch``, deadlines and bounded depth belong to its
async serve plane, ROADMAP item 10. Pure host-side Python.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class FifoQueue(Generic[T]):
    """Thread-safe FIFO: producers ``push``, consumers take the oldest
    items without blocking."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: deque[T] = deque()

    def push(self, item: T) -> None:
        with self._lock:
            self._items.append(item)

    def pop(self) -> Optional[T]:
        """The oldest item, or ``None`` when empty."""
        with self._lock:
            return self._items.popleft() if self._items else None

    def take(self, k: int) -> list[T]:
        """Up to ``k`` oldest items."""
        with self._lock:
            return [self._items.popleft()
                    for _ in range(min(k, len(self._items)))]

    def drain(self) -> list[T]:
        """Remove and return everything queued."""
        with self._lock:
            out = list(self._items)
            self._items.clear()
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
