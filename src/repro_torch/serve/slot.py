"""``ModelSlot`` — atomic publish/swap of the O(p) serving state.

The paper's landmark dual is tiny — β ∈ R^p plus the p landmark rows — so
refreshing a served model is one small-array exchange, not a redeploy. A
``ModelSlot`` makes that exchange safe under concurrency:

* ``publish(model)`` snapshots the model's serving state into an immutable
  ``PublishedModel`` and swaps it in with one reference assignment.
  Readers never lock.
* ``current()`` returns the live snapshot. A batch that acquired a
  snapshot keeps serving from it even if a swap lands mid-batch: the dual
  travels as one immutable tuple of tensors, so no batch sees a torn dual.

No rebuild on a hot swap: for the landmark-family solvers the slot builds
one ``(state, Xb) -> y`` function per config, with the O(p) state passed
as an argument, so publishing a refreshed dual of the same config reuses
it — the swap costs one host assignment. Solvers without an exportable
dual (``exact``, ``dnc``) serve through the model's own
``make_batched_predict`` (state closed over), one new function a publish.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import numpy as np
import torch

from ..api.estimator import solver_state_from_serving
from ..api.solvers import SOLVERS
from ..core.precision import to_dtype


@dataclasses.dataclass(frozen=True)
class PublishedModel:
    """One immutable published serving snapshot.

    Attributes:
      key:         the slot key this snapshot serves under.
      version:     monotonically increasing per slot (1 = first publish).
      state:       the O(p) landmark-dual state passed to ``predict_fn``,
                   or ``None`` when the snapshot serves through a
                   closed-over fixed-batch predict.
      n_shards:    device count of the model's executor; 1 (the port has
                   no sharded executor), batch buckets are multiples of it.
      serve_dtype: the precision policy's quantized serve dtype
                   (``None`` = full fit precision).
      data_dtype:  the config's data dtype; host batches are cast to it
                   before the copy to the device (``SketchedKRR._cast``).
      device:      the model's device, where every batch is served.
    """

    key: str
    version: int
    state: Any
    n_shards: int
    serve_dtype: str | None
    data_dtype: str | None
    device: torch.device
    predict_fn: Callable = dataclasses.field(repr=False, compare=False)

    def predict_padded(self, X: np.ndarray, bucket: int) -> np.ndarray:
        """Serve a ``(k, dim)`` host batch padded to ``bucket`` rows.

        Pads on the host in numpy by repeating the last row (the
        convention of ``SketchedKRR.predict_batched``), casts to the data
        dtype there, makes one host-to-device copy of the ``(bucket,
        dim)`` batch, runs the predict on the model's device and trims back
        to ``k`` results. Per-row outputs are independent in the landmark
        form, so padding rows cannot perturb live results."""
        k = X.shape[0]
        if k > bucket:
            raise ValueError(f"batch of {k} exceeds bucket {bucket}")
        Xp = np.asarray(X)
        pad = bucket - k
        if pad:
            Xp = np.concatenate(
                [Xp, np.broadcast_to(Xp[-1:], (pad,) + Xp.shape[1:])])
        Xb = torch.from_numpy(np.ascontiguousarray(Xp))
        if self.data_dtype is not None:
            Xb = Xb.to(to_dtype(self.data_dtype))
        Xb = Xb.to(self.device)
        if self.state is not None:
            y = self.predict_fn(self.state, Xb)
        else:
            y = self.predict_fn(Xb)
        return y.cpu().numpy()[:k]


class ModelSlot:
    """Holds the live ``PublishedModel`` behind an atomic publish/swap.

    ``publish`` may be called from any thread (a background
    ``partial_fit → finalize`` refresher, typically) while serve workers
    read ``current()``; the swap is one reference assignment and every
    snapshot is immutable, so readers need no lock.
    """

    def __init__(self, model: Any = None, *, key: str = "default"):
        self.key = key
        self._lock = threading.Lock()
        self._entry: PublishedModel | None = None
        # one state-as-argument predict per config, reused across publishes
        self._fn: Callable | None = None
        self._fn_cfg: Any = None
        if model is not None:
            self.publish(model)

    @property
    def version(self) -> int:
        """Version of the live snapshot (0 before the first publish)."""
        entry = self._entry
        return 0 if entry is None else entry.version

    def current(self) -> PublishedModel:
        """The live snapshot; raises if nothing was published yet. A batch
        is served from one ``current()`` read: that read is the atomicity
        contract."""
        entry = self._entry
        if entry is None:
            raise RuntimeError(
                f"model slot {self.key!r} has no published model yet — "
                "call publish(model) first")
        return entry

    def _dual_predict_fn(self, cfg: Any) -> Callable:
        """The ``(state, Xb) -> y`` serve path for ``cfg``, built once per
        config and cached on the slot, with the quantized-serving rule of
        ``SketchedKRR.make_batched_predict``."""
        if self._fn is None or self._fn_cfg != cfg:
            solver = SOLVERS.get(cfg.solver)
            serve = cfg.precision.serve()
            if serve is None:
                def fn(st, Xb):
                    return solver.predict(cfg, st, Xb)
            else:
                qcfg = cfg.replace(precision=cfg.precision.for_serving())

                def fn(st, Xb):
                    return solver.predict(qcfg, st, Xb.to(serve))
            self._fn = fn
            self._fn_cfg = cfg
        return self._fn

    def publish(self, model: Any) -> int:
        """Snapshot ``model``'s serving state and swap it live.

        ``model`` is a fitted ``repro_torch.api.SketchedKRR``. For the
        landmark-family solvers the snapshot is the exported O(p)
        ``ServingState``, decoupled from the estimator; other solvers serve
        through their own ``make_batched_predict``. Returns the new
        version; raises ``NotFittedError`` for an unfitted model."""
        cfg = model.config
        try:
            serving = model.export_serving_state()
        except TypeError:
            serving = None      # no landmark dual (exact / dnc)
        if serving is not None:
            state = solver_state_from_serving(serving)
            fn = self._dual_predict_fn(cfg)
        else:
            state = None
            fn = model.make_batched_predict()   # fails fast if unfitted
        with self._lock:
            entry = PublishedModel(
                key=self.key, version=self.version + 1, state=state,
                n_shards=1, serve_dtype=cfg.precision.serve_dtype,
                data_dtype=cfg.precision.data_dtype, device=model.device,
                predict_fn=fn)
            self._entry = entry     # the atomic swap
        return entry.version
