"""The async serve plane: deadline-aware continuous batching over
hot-swappable model slots.

``AsyncServeEngine`` runs a background worker that forms batches
fill-or-timeout style (``repro_torch.serve.queue.FifoQueue.next_batch``):
a batch leaves the queue when it is full, when the oldest request has
waited out the policy's window, or when waiting longer would expire a
request's deadline. Partial batches are padded up to a small set of
buckets (powers of two by default), so the predict runs at a few fixed
shapes — on the card, K1 at (bucket, p, d) — and each slot serves the O(p)
landmark dual as an argument of one function per config
(``repro_torch.serve.slot``), so a model swap builds nothing new.

Multi-model routing: the engine holds one ``ModelSlot`` per string key;
requests name a key (or take the single-model default), unknown keys fail
fast with ``UnknownModelError`` unless a ``fallback_model`` is configured.
A background refresher (``repro_torch.serve.refresh``) publishes refreshed
duals into a slot while serving continues.

    engine = AsyncServeEngine(model)             # or {"key": model, ...}
    engine.start()
    fut = engine.submit(x, deadline_ms=50.0)     # concurrent.futures.Future
    result = fut.result(30)                      # ServeResult
    engine.publish(refreshed_model)              # atomic hot swap
    engine.stop()

Every terminal outcome is explicit: served requests resolve to a
``ServeResult`` (value, serving model key + version, latency), expired
ones raise ``DeadlineMissError``, and requests still queued at ``stop``
raise ``EngineStoppedError`` — the engine never drops work silently. The
worker and a refresher launch device work from two threads on the same
device's current stream; each batch's results are copied back to the host
before its futures resolve.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Mapping, NamedTuple

import numpy as np

from .queue import (DeadlineMissError, EngineStoppedError, FifoQueue,
                    QueueFullError, ServeRequest, UnknownModelError)
from .slot import ModelSlot

DEFAULT_MODEL_KEY = "default"


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Batch-formation knobs of the async engine (frozen, reusable).

    Attributes:
      max_batch:   upper bound on live requests per batch; also the cap
                   of the default bucket ladder.
      max_wait_ms: fill-or-timeout window — a partial batch is served
                   once its oldest request has waited this long. ``0``
                   serves whatever is queued as fast as the worker spins
                   (lowest latency, smallest batches).
      buckets:     explicit padded-batch sizes, ascending. ``None`` uses
                   powers of two up to ``max_batch``. Every bucket is
                   rounded up to a multiple of the model's ``n_shards``
                   at use (1 in the port).
      default_deadline_ms: deadline given to requests that don't carry
                   their own (``None`` = no implicit deadline).
      max_queue_depth: bound on queued requests. A submit past it is
                   *shed*: its future fails immediately with
                   ``QueueFullError`` (counted in ``ServeStats.shed``)
                   instead of queueing up a guaranteed deadline miss.
                   ``None`` = unbounded (the default).
    """

    max_batch: int = 64
    max_wait_ms: float = 2.0
    buckets: tuple[int, ...] | None = None
    default_deadline_ms: float | None = None
    max_queue_depth: int | None = None

    def __post_init__(self) -> None:
        if self.max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got "
                             f"{self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got "
                             f"{self.max_wait_ms}")
        if self.max_queue_depth is not None and self.max_queue_depth <= 0:
            raise ValueError(f"max_queue_depth must be positive or None, "
                             f"got {self.max_queue_depth}")
        if self.buckets is not None:
            b = tuple(self.buckets)
            if not b or any(x <= 0 for x in b) or list(b) != sorted(b):
                raise ValueError(
                    f"buckets must be ascending positive sizes, got "
                    f"{self.buckets!r}")
            if b[-1] < self.max_batch:
                raise ValueError(
                    f"largest bucket {b[-1]} < max_batch "
                    f"{self.max_batch}: a full batch would not fit")

    def bucket_for(self, k: int, n_shards: int = 1) -> int:
        """Padded batch size for ``k`` live requests.

        The smallest configured bucket that holds ``k`` (default ladder:
        powers of two capped at ``max_batch``), rounded up to a multiple
        of ``n_shards`` so a sharded model's batch divides its mesh
        evenly — the same rounding the synchronous engine applies to its
        fixed micro-batch.
        """
        if k <= 0:
            raise ValueError(f"bucket_for needs k >= 1, got {k}")
        if self.buckets is not None:
            bucket = next((b for b in self.buckets if b >= k),
                          self.buckets[-1])
            bucket = max(bucket, k)
        else:
            bucket = 1
            while bucket < k:
                bucket *= 2
            bucket = min(bucket, max(self.max_batch, k))
        return -(-bucket // n_shards) * n_shards


class ServeResult(NamedTuple):
    """What a served request's future resolves to.

    ``model``/``version`` name the exact published snapshot that served
    the request — the hot-swap consistency tests key on it — and
    ``latency_ms`` is submit-to-result wall time.
    """

    y_hat: float
    model: str
    version: int
    latency_ms: float


@dataclasses.dataclass
class ServeStats:
    """Counters + latency record of one engine's lifetime.

    ``latencies_ms`` holds every served request's submit-to-result time
    (host-side list). ``batch_sizes`` are live request counts per executed batch,
    ``buckets`` the padded sizes actually run, ``publishes`` the number
    of model publishes routed through the engine, ``shed`` the number of
    submissions rejected at ``max_queue_depth`` (backpressure).
    """

    served: int = 0
    misses: int = 0
    shed: int = 0
    batches: int = 0
    publishes: int = 0
    batch_sizes: list = dataclasses.field(default_factory=list)
    buckets: list = dataclasses.field(default_factory=list)
    latencies_ms: list = dataclasses.field(default_factory=list)

    def percentile(self, q: float) -> float:
        """Latency percentile in ms over everything served (nan if none)."""
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_ms), q))

    def p50(self) -> float:
        """Median serve latency in milliseconds."""
        return self.percentile(50.0)

    def p99(self) -> float:
        """99th-percentile serve latency in milliseconds."""
        return self.percentile(99.0)


class AsyncServeEngine:
    """Deadline-aware continuous-batching server over hot-swappable models.

    Construction takes one fitted ``SketchedKRR`` (served under the key
    ``"default"``) or a mapping of key → model. ``start``/``stop`` (or
    the context manager) run the background worker; ``submit`` returns a
    ``concurrent.futures.Future``; ``publish`` atomically swaps a
    refreshed model into its slot while serving continues.

    One worker thread forms and executes batches. A batch is served from
    a single atomic slot snapshot, so concurrent publishes can never
    produce a torn dual; requests for different model keys that land in
    the same formation window are served as consecutive per-key groups,
    preserving FIFO order within each key.
    """

    def __init__(self, models: Any,
                 *, policy: BatchPolicy = BatchPolicy(),
                 fallback_model: str | None = None,
                 clock=time.monotonic):
        if not isinstance(models, Mapping):
            models = {DEFAULT_MODEL_KEY: models}
        if not models:
            raise ValueError("AsyncServeEngine needs at least one model")
        self.policy = policy
        self._slots: dict[str, ModelSlot] = {
            key: ModelSlot(m, key=key) for key, m in models.items()}
        if fallback_model is not None and fallback_model not in self._slots:
            raise ValueError(
                f"fallback_model {fallback_model!r} is not a published "
                f"model key; available: {sorted(self._slots)}")
        self._fallback = fallback_model
        self._default_key = (next(iter(self._slots)) if len(self._slots) == 1
                             else (DEFAULT_MODEL_KEY
                                   if DEFAULT_MODEL_KEY in self._slots
                                   else None))
        self._clock = clock
        self._queue: FifoQueue[ServeRequest] = FifoQueue(
            clock, max_depth=policy.max_queue_depth)
        self._uid = itertools.count()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._stats = ServeStats()
        self._stats_lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "AsyncServeEngine":
        """Start the background batching worker (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._serve_loop, name="serve-plane-worker",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the worker and fail anything still queued — loudly.

        Queued requests get ``EngineStoppedError`` set on their futures;
        a stop is never a silent drop.
        """
        self._stop.set()
        self._queue.kick()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        for req in self._queue.drain():
            if not req.future.done():
                req.future.set_exception(EngineStoppedError(
                    f"engine stopped with request {req.uid} (model "
                    f"{req.model!r}) still queued"))

    def __enter__(self) -> "AsyncServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- routing

    def publish(self, model: Any, key: str | None = None) -> int:
        """Atomically publish ``model`` under ``key`` (hot swap).

        Swapping an existing key replaces its live snapshot between
        batches — in-flight batches finish on the snapshot they
        acquired; publishing a new key adds a route. Returns the slot's
        new version.
        """
        if key is None:
            if self._default_key is None:
                raise ValueError(
                    "publish(model) without a key is ambiguous for a "
                    f"multi-model engine; pass key= one of "
                    f"{sorted(self._slots)} (or a new key)")
            key = self._default_key
        slot = self._slots.get(key)
        if slot is None:
            self._slots[key] = ModelSlot(model, key=key)
            version = self._slots[key].version
        else:
            version = slot.publish(model)
        with self._stats_lock:
            self._stats.publishes += 1
        return version

    def models(self) -> dict[str, int]:
        """Published model keys → live version (a routing snapshot)."""
        return {key: slot.version for key, slot in self._slots.items()}

    # ------------------------------------------------------------ submission

    def submit(self, x: Any, *, model: str | None = None,
               deadline_ms: float | None = None) -> Future:
        """Queue one query point; returns a future of ``ServeResult``.

        ``model`` routes to a published slot (optional for single-model
        engines); unknown keys go to the configured ``fallback_model``
        or fail the future immediately with ``UnknownModelError``.
        ``deadline_ms`` (relative to now; default from the policy) bounds
        queueing — an expired request raises ``DeadlineMissError`` into
        the future rather than being served late or dropped. Past the
        policy's ``max_queue_depth`` the request is shed: the future
        fails with ``QueueFullError`` and ``ServeStats.shed`` counts it.
        """
        fut: Future = Future()
        key = model if model is not None else self._default_key
        if key is None:
            fut.set_exception(UnknownModelError(
                "submit() needs model= for a multi-model engine without "
                f"a 'default' slot; available: {sorted(self._slots)}"))
            return fut
        if key not in self._slots:
            if self._fallback is not None:
                key = self._fallback
            else:
                fut.set_exception(UnknownModelError(
                    f"no model published under key {key!r}; available: "
                    f"{sorted(self._slots)} (configure fallback_model= "
                    "to route unknown keys to a default)"))
                return fut
        now = self._clock()
        dm = (deadline_ms if deadline_ms is not None
              else self.policy.default_deadline_ms)
        req = ServeRequest(
            uid=next(self._uid), x=np.asarray(x), model=key,
            deadline=None if dm is None else now + dm / 1e3,
            submitted=now, future=fut)
        try:
            self._queue.push(req)
        except QueueFullError as exc:
            with self._stats_lock:
                self._stats.shed += 1
            fut.set_exception(exc)
        return fut

    def predict(self, x: Any, *, model: str | None = None,
                deadline_ms: float | None = None,
                timeout: float | None = 30.0) -> ServeResult:
        """Synchronous convenience: ``submit`` and wait for the result."""
        return self.submit(x, model=model,
                           deadline_ms=deadline_ms).result(timeout)

    def stats(self) -> ServeStats:
        """A consistent copy of the engine's counters and latencies."""
        with self._stats_lock:
            return dataclasses.replace(
                self._stats,
                batch_sizes=list(self._stats.batch_sizes),
                buckets=list(self._stats.buckets),
                latencies_ms=list(self._stats.latencies_ms))

    # --------------------------------------------------------------- worker

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            batch = self._queue.next_batch(
                self.policy.max_batch, self.policy.max_wait_ms / 1e3,
                deadline_of=lambda r: r.deadline, stop=self._stop)
            if batch:
                self._serve_batch(batch)

    def _serve_batch(self, batch: list[ServeRequest]) -> None:
        now = self._clock()
        live: list[ServeRequest] = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                waited_ms = (now - req.submitted) * 1e3
                budget_ms = (req.deadline - req.submitted) * 1e3
                req.future.set_exception(DeadlineMissError(
                    f"request {req.uid} for model {req.model!r} missed "
                    f"its deadline: waited {waited_ms:.1f} ms in queue "
                    f"against a {budget_ms:.1f} ms budget (policy: "
                    f"max_batch={self.policy.max_batch}, max_wait_ms="
                    f"{self.policy.max_wait_ms})"))
                with self._stats_lock:
                    self._stats.misses += 1
            else:
                live.append(req)
        # group by model key, preserving per-key FIFO order
        groups: dict[str, list[ServeRequest]] = {}
        for req in live:
            groups.setdefault(req.model, []).append(req)
        for key, reqs in groups.items():
            try:
                self._serve_group(key, reqs)
            except BaseException as exc:     # noqa: BLE001 — forwarded
                for req in reqs:
                    if not req.future.done():
                        req.future.set_exception(exc)

    def _serve_group(self, key: str, reqs: list[ServeRequest]) -> None:
        entry = self._slots[key].current()   # ONE snapshot for the batch
        bucket = self.policy.bucket_for(len(reqs), entry.n_shards)
        y = entry.predict_padded(np.stack([r.x for r in reqs]), bucket)
        done = self._clock()
        lats = []
        for req, val in zip(reqs, y):
            lat_ms = (done - req.submitted) * 1e3
            lats.append(lat_ms)
            req.future.set_result(ServeResult(
                float(val), entry.key, entry.version, lat_ms))
        with self._stats_lock:
            self._stats.served += len(reqs)
            self._stats.batches += 1
            self._stats.batch_sizes.append(len(reqs))
            self._stats.buckets.append(bucket)
            self._stats.latencies_ms.extend(lats)
