"""The async serve plane: continuous batching over hot-swappable models.

* ``queue``   — thread-safe FIFO with fill-or-timeout batch formation and
  deadline-aware waits; shared by the async engine and both synchronous
  loops in ``repro_torch.runtime.serve_loop``.
* ``slot``    — ``ModelSlot``: atomic publish/swap of an immutable
  ``PublishedModel`` snapshot; one predict function per config with the
  dual as an argument, so a hot swap builds nothing.
* ``engine``  — ``AsyncServeEngine``: background worker, per-request
  deadlines, bucketed padding, multi-model routing with optional
  fallback, p50/p99 stats.
* ``refresh`` — ``BackgroundRefresher``: ``partial_fit → finalize →
  publish`` loops for model updates while serving.
"""
from .engine import AsyncServeEngine, BatchPolicy, ServeResult, ServeStats
from .queue import (DeadlineMissError, EngineStoppedError, FifoQueue,
                    QueueFullError, ServeRequest, UnknownModelError)
from .refresh import BackgroundRefresher
from .slot import ModelSlot, PublishedModel

__all__ = [
    "AsyncServeEngine",
    "BackgroundRefresher",
    "BatchPolicy",
    "DeadlineMissError",
    "EngineStoppedError",
    "FifoQueue",
    "ModelSlot",
    "PublishedModel",
    "QueueFullError",
    "ServeRequest",
    "ServeResult",
    "ServeStats",
    "UnknownModelError",
]
