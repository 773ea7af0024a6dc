"""Background model refresh: ``partial_fit → finalize → publish``.

The chunk accumulators make a model refresh cheap: each ``ingest`` folds a
new chunk into the running sufficient statistics, re-solves the O(p) core
and atomically publishes the refreshed dual into the serving engine.
Because the slot snapshots the exported ``ServingState`` at publish time,
the refresher can keep changing its estimator between publishes without
perturbing what is being served: the serve plane only ever sees finalized
versions.

    refresher = BackgroundRefresher(engine, model)
    refresher.start(chunk_stream)     # thread: ingest+publish per chunk
    ...serve traffic concurrently...
    refresher.join(timeout=30)
"""
from __future__ import annotations

import threading
from typing import Any, Iterable


class BackgroundRefresher:
    """Streams data chunks into a model and hot-swaps each refresh live.

    Wraps one ``SketchedKRR`` (already fitted or about to receive its
    first chunk) and one ``AsyncServeEngine`` slot key. ``ingest`` is
    synchronous (one chunk → one publish); ``start``/``join`` run a
    whole chunk stream on a background thread while the engine serves.
    """

    def __init__(self, engine: Any, model: Any, *, key: str | None = None):
        self.engine = engine
        self.model = model
        self.key = key
        self.versions: list[int] = []
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def ingest(self, X: Any, y: Any) -> int:
        """Fold one ``(X, y)`` chunk in and publish the refreshed model.

        ``partial_fit`` updates the accumulators, ``finalize`` re-solves
        the O(p) core, and ``engine.publish`` swaps the new dual live.
        Returns the published slot version.
        """
        self.model.partial_fit(X, y)
        self.model.finalize()
        version = self.engine.publish(self.model, key=self.key)
        self.versions.append(version)
        return version

    def run(self, chunks: Iterable[tuple[Any, Any]]) -> list[int]:
        """Ingest every ``(X, y)`` chunk in order; returns the versions."""
        return [self.ingest(X, y) for X, y in chunks]

    def start(self, chunks: Iterable[tuple[Any, Any]]
              ) -> "BackgroundRefresher":
        """Run ``run(chunks)`` on a daemon thread (one active at a time)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("refresher is already running")

        def _worker() -> None:
            try:
                self.run(chunks)
            except BaseException as exc:   # noqa: BLE001 — reported by join
                self._error = exc

        self._error = None
        self._thread = threading.Thread(
            target=_worker, name="serve-plane-refresher", daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: float | None = None) -> None:
        """Wait for the background run; re-raises any worker error."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("refresher still running after "
                                   f"{timeout} s")
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
