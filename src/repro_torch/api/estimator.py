"""The ``SketchedKRR`` estimator — one object for the whole paper pipeline.

    config = SketchConfig(kernel=RBFKernel(1.5), p=200, lam=1e-3)
    model = SketchedKRR(config).fit(X, y)     # on the card by default
    y_hat = model.predict(X_test)             # out-of-sample Nyström extension
    l_hat = model.scores()                    # sampler's leverage estimates
    report = model.risk(f_star, noise_std)    # eq.-(4) risk (empirical for
                                              # the iterative solvers)

``fit`` seeds its CPU ``torch.Generator`` streams from ``config.seed``, so a
fit is a pure function of (config, X, y) and draws the same landmarks on
every device. Every kernel block the sampler, the solver and prediction
evaluate goes through the ``KernelOps`` backend selected by
``config.backend`` (``auto``: the Hopper kernels on CUDA, the plain
PyTorch path on the CPU).

Fits also stream (``repro_torch.api.out_of_core``): ``fit(source)`` with a
``repro_torch.data`` chunk source (array, generator factory, memory-mapped
``.npy``, CSR), ``fit(X_csr, y)`` for a ``CsrMatrix`` or scipy.sparse
matrix, and ``chunk_rows`` on the config for in-memory arrays hold
O(chunk_rows·p) on the device; ``partial_fit(X, y)``/``finalize()``
accumulate the same statistics incrementally, freezing the landmarks after
the first chunk. Such models predict like in-memory ones; ``risk`` and
``predict_train`` need the in-memory factor or training set and say so.
``eigenpro`` streams a source once per epoch (``fit(source)``), which
``partial_fit`` cannot do: its ``finalize`` raises.

The fitted model of the landmark solvers is the O(p) ``ServingState`` —
β, the landmark rows Z and the sketch column weights — which
``export_serving_state``/``import_serving_state`` move between estimators,
``serving_state_from_reference`` builds from the JAX package's export, and
``solver_state_from_serving`` turns into the state the solvers' ``predict``
takes (the serve plane, ``repro_torch.serve``, passes it as an argument).
``make_batched_predict`` is the fixed-batch predict with the fitted state
closed over, through which ``predict_batched`` and the serve plane serve
solvers without an O(p) dual (``exact``, ``dnc``).
"""
from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..core.backends import KernelOps, ops_for_config
from ..core.krr import RiskReport, empirical_risk
from ..core.nystrom import ColumnSample
from ..data.chunks import (ArrayChunkSource, ChunkSource,
                           as_chunk_source, to_host)
from ..data.sparse import CsrMatrix, SparseChunkSource, is_sparse_matrix
from ..device import resolve_device
from .config import SketchConfig
from .out_of_core import fit_from_source, require_sparse_chunk_solver
from .samplers import SAMPLERS, Sampler, streams
from .solvers import SOLVERS, NystromState, Solver


class NotFittedError(RuntimeError):
    """Raised when a method that needs a fitted model runs before ``fit``."""


class ServingState(NamedTuple):
    """The swap-able O(p) serving state of a landmark-family fit: what the
    Nyström extension f̂(x) = k(x, Z)·β needs at serve time, plus the
    solver the dual belongs to."""

    beta: Tensor
    landmarks: Tensor
    col_weights: Tensor | None
    solver: str


def solver_state_from_serving(serving: ServingState) -> NystromState:
    """A predict-capable ``NystromState`` holding only the serving triple
    (β, Z, column weights): what the landmark solvers' ``predict`` reads.
    Training-set diagnostics (``risk``, ``predict_train``) are not
    rebuilt from O(p) state and stay unavailable."""
    return NystromState(approx=None, alpha=None, beta=serving.beta,
                        landmarks=serving.landmarks,
                        col_weights=serving.col_weights)


def serving_state_from_reference(fields: dict, *,
                                 device: str | torch.device = "cuda"
                                 ) -> ServingState:
    """A ``ServingState`` from the JAX package's ``export_serving_state()``
    fields as numpy arrays (``beta``, ``landmarks``, ``col_weights`` — or
    None — and ``solver``), on ``device``."""
    dev = resolve_device(device)

    def tensor(a):
        return None if a is None else torch.as_tensor(np.array(a),
                                                      device=dev)

    return ServingState(beta=tensor(fields["beta"]),
                        landmarks=tensor(fields["landmarks"]),
                        col_weights=tensor(fields.get("col_weights")),
                        solver=str(fields["solver"]))


class SketchedKRR:
    """Sketched kernel ridge regression with pluggable sampler and solver.

    The sampler and solver are resolved from the registries and the device
    is resolved at construction, so a typo — or ``device="cuda"`` on a
    machine without a GPU — fails before any compute happens.
    """

    def __init__(self, config: SketchConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self._sampler: Sampler = SAMPLERS.get(config.sampler)
        self._solver: Solver = SOLVERS.get(config.solver)
        self._state: Any = None
        self._sample: ColumnSample | None = None
        self._scores: Tensor | None = None
        self._X_train: Tensor | None = None
        self._injected: dict = {}
        self._predict_fn: Callable[[Tensor], Tensor] | None = None
        self._accum: Any = None       # live ChunkAccumulator (partial_fit)
        self._n_seen = 0

    # ------------------------------------------------------------- fitting

    def _cast(self, arr):
        """``arr`` on the config's device, in its data dtype (None keeps
        the input dtype); a ``CsrMatrix`` or scipy.sparse matrix becomes a
        validated ``CsrMatrix`` of tensors there."""
        dt = self.config.precision.data()
        if is_sparse_matrix(arr):
            if not isinstance(arr, CsrMatrix):
                arr = CsrMatrix.from_scipy(arr)
            return arr.validate().cast(dt, self.device)
        return torch.as_tensor(arr, dtype=dt, device=self.device)

    def _draws(self, sample, score_landmarks) -> dict:
        """Injected draws as tensors on this estimator's device (a list of
        them for the per-stage / per-level landmarks of ``bless`` and
        ``recursive_rls``)."""
        if isinstance(score_landmarks, (list, tuple)):
            landmarks = [torch.as_tensor(i, device=self.device)
                         for i in score_landmarks]
        else:
            landmarks = (None if score_landmarks is None else
                         torch.as_tensor(score_landmarks, device=self.device))
        return {
            "landmarks": landmarks,
            "sample": None if sample is None else ColumnSample(
                *(torch.as_tensor(a, device=self.device) for a in sample))}

    def fit(self, X, y=None, *, sample: ColumnSample | None = None,
            score_landmarks: Tensor | None = None,
            partitions: Tensor | None = None) -> "SketchedKRR":
        """Fit from in-memory rows — or out of core.

        Input shapes:
          * ``fit(X, y)`` with arrays: the in-memory fit, unless
            ``config.chunk_rows`` is set, which streams the same rows
            through the chunked driver in ``chunk_rows`` blocks;
          * ``fit(source)`` with a ``repro_torch.data`` ``ChunkSource``
            (targets ride inside it);
          * ``fit(X_csr, y)`` with a ``CsrMatrix`` or scipy.sparse matrix:
            the chunked driver over a ``SparseChunkSource`` (one
            whole-matrix chunk when ``chunk_rows`` is unset), X never
            densified;
          * ``fit(path, y_path)`` with ``.npy`` paths (a
            ``MemmapChunkSource``) or ``fit(factory)`` with a zero-arg
            callable yielding ``(X_block, y_block)`` pairs (a
            ``GeneratorChunkSource``), at ``chunk_rows`` (default 4096).

        ``sample`` (a ``ColumnSample``), ``score_landmarks`` (the
        Theorem-4 pass's landmark indices; for ``bless`` and
        ``recursive_rls`` a list, one per stage or level) and
        ``partitions`` (the ``dnc`` solver's (m, n/m) row indices, in
        memory) replace the fit's own random draws with given ones — the
        seam through which the parity tests inject the reference's draws,
        which PyTorch cannot reproduce.
        Chunked fits are bit-identical across source kinds at equal
        ``chunk_rows``.
        """
        cfg = self.config
        draws = dict(sample=sample, score_landmarks=score_landmarks,
                     partitions=partitions)
        self._predict_fn = None
        if isinstance(X, ChunkSource):
            if y is not None:
                raise ValueError("fit(source): targets ride inside the "
                                 "chunk source, drop the y argument")
            return self._fit_source(X, **draws)
        if isinstance(X, (str, os.PathLike)) or callable(X):
            return self._fit_source(
                as_chunk_source(X, y, cfg.chunk_rows or 4096), **draws)
        if y is None:
            raise TypeError("fit(X, y) needs targets; only chunk sources "
                            "carry their own y")
        if is_sparse_matrix(X):
            if not isinstance(X, CsrMatrix):
                X = CsrMatrix.from_scipy(X)
            return self._fit_source(SparseChunkSource(
                X, to_host(y), cfg.chunk_rows or max(X.shape[0], 1)), **draws)
        if cfg.chunk_rows is not None:
            return self._fit_source(ArrayChunkSource(
                to_host(X), to_host(y), cfg.chunk_rows), **draws)
        self._X_train = self._cast(X)
        y = self._cast(y)
        self._sample = self._scores = None
        self._accum = None
        self._injected = self._draws(sample, score_landmarks)
        # solvers that ignore the sample (exact) skip the sampling pass;
        # scores()/sample() run it lazily from the same seed
        drawn = self._run_sampler() if self._solver.needs_sample else None
        extra = {}
        if partitions is not None:
            if cfg.solver != "dnc":
                raise ValueError(f"partitions= is the dnc solver's draw; "
                                 f"solver {cfg.solver!r} takes none")
            extra["partitions"] = torch.as_tensor(partitions,
                                                  device=self.device)
        self._state = self._solver.fit(self.config, self._X_train, y, drawn,
                                       **extra)
        return self

    def _fit_source(self, source: ChunkSource, *, sample=None,
                    score_landmarks=None, partitions=None) -> "SketchedKRR":
        """Out-of-core fit through ``repro_torch.api.out_of_core``."""
        if partitions is not None:
            raise ValueError("partitions= is the in-memory dnc fit's draw; "
                             "an out-of-core fit takes none")
        self._sample = self._scores = self._X_train = None
        self._accum = None
        draws = self._draws(sample, score_landmarks)
        res = fit_from_source(self.config, self._solver, source,
                              sample=draws["sample"],
                              score_landmarks=draws["landmarks"])
        self._sample, self._scores = res.sample, res.scores
        self._n_seen = res.n_rows
        self._state = res.state
        return self

    def partial_fit(self, X, y) -> "SketchedKRR":
        """Fold one row chunk (dense or CSR) into the fit's statistics.

        The first chunk runs the configured sampler on that chunk and
        freezes the landmarks and sketch weights (valid when chunks are
        exchangeable draws from one distribution); every chunk, the first
        included, then folds into the solver's accumulator — O(p²) state
        for the Nyström solvers, buffered rows for ``exact``. ``finalize()``
        solves; more ``partial_fit`` + ``finalize`` rounds refine the same
        model from the enlarged statistics.
        """
        cfg = self.config
        X, y = self._cast(X), self._cast(y)
        require_sparse_chunk_solver(cfg, isinstance(X, CsrMatrix))
        if self._accum is None:
            self._state = None
            self._sample = self._scores = self._X_train = None
            self._n_seen = 0
            landmarks = None
            if self._solver.needs_sample:
                out = self._sampler(tuple(streams(cfg.seed, 2)), cfg.kernel,
                                    X, cfg)
                self._sample, self._scores = out.sample, out.scores
                landmarks = X[out.sample.idx]
            self._accum = self._solver.begin_chunked(cfg, landmarks,
                                                     self._sample)
        self._accum.add(X, y)
        self._n_seen += X.shape[0]
        return self

    def finalize(self) -> "SketchedKRR":
        """Solve from the statistics ``partial_fit`` accumulated (O(p³) for
        the Nyström solvers); the accumulator stays live for more chunks."""
        if self._accum is None:
            raise NotFittedError("call partial_fit(X, y) before finalize()")
        self._state = self._accum.finalize(self._n_seen)
        self._predict_fn = None
        return self

    def _run_sampler(self) -> ColumnSample:
        if self._X_train is None:
            raise NotFittedError(
                "sampler diagnostics need the in-memory training set, which "
                "an out-of-core fit whose solver drew no sample, or a model "
                "imported from a serving state, does not have")
        out = self._sampler(tuple(streams(self.config.seed, 2)),
                            self.config.kernel, self._X_train, self.config,
                            **self._injected)
        self._sample, self._scores = out.sample, out.scores
        return self._sample

    def _require_fit(self) -> None:
        if self._state is None:
            if self._accum is not None:
                raise NotFittedError(
                    "partial_fit has accumulated chunks but the model is "
                    "not solved yet — call finalize() first")
            raise NotFittedError("call fit(X, y) before this method")

    # ---------------------------------------------------------- prediction

    def predict(self, X_test) -> Tensor:
        """Out-of-sample predictions f̂(x) = k(x, Z)·β (the Nyström
        extension for the sketched solvers), through the configured
        kernel backend."""
        self._require_fit()
        return self._solver.predict(self.config, self._state,
                                    self._cast(X_test))

    def predict_train(self) -> Tensor:
        """Predictions at the training points, through the solver's cached
        factors (zero fresh kernel evaluations)."""
        self._require_fit()
        return self._solver.predict_train(self.config, self._state,
                                          self._X_train)

    def make_batched_predict(self) -> Callable[[Tensor], Tensor]:
        """The fixed-batch predict of the serve path: a callable
        ``Xb -> y`` with the fitted state closed over, built once and
        cached on the estimator until the next fit, ``finalize`` or import.
        ``Xb`` must be on the model's device in its data dtype.

        With ``config.precision.serve_dtype`` set it is the quantized
        server: the batch is cast to that dtype and its blocks are
        evaluated there, the contraction in ``accum_dtype``. Unset, it
        serves at full fit precision, as ``predict`` always does."""
        self._require_fit()
        if self._predict_fn is None:
            cfg, solver, state = self.config, self._solver, self._state
            serve = cfg.precision.serve()
            if serve is None:
                def fn(Xb):
                    return solver.predict(cfg, state, Xb)
            else:
                qcfg = cfg.replace(precision=cfg.precision.for_serving())

                def fn(Xb):
                    return solver.predict(qcfg, state, Xb.to(serve))
            self._predict_fn = fn
        return self._predict_fn

    def predict_batched(self, X_test, batch_size: int = 256) -> Tensor:
        """Predict in fixed-size batches through ``make_batched_predict``,
        padding the tail batch with copies of its last row (the serve
        path's fixed shapes)."""
        self._require_fit()
        if is_sparse_matrix(X_test):
            raise TypeError(
                "predict_batched slices/pads dense test batches, which "
                "CsrMatrix does not support; call predict(X_test) — the "
                "sparse cross block is internally nnz-tiled already")
        X_test = self._cast(X_test)
        n = X_test.shape[0]
        if n == 0:
            return self.predict(X_test)
        fn = self.make_batched_predict()
        outs = []
        for start in range(0, n, batch_size):
            blk = X_test[start:start + batch_size]
            valid = blk.shape[0]
            if valid < batch_size:
                blk = torch.cat([blk, blk[-1:].expand(batch_size - valid,
                                                      *blk.shape[1:])])
            outs.append(fn(blk)[:valid])
        return torch.cat(outs)

    # ------------------------------------------------------- serving state

    def export_serving_state(self) -> ServingState:
        """The O(p) state a serving process needs — and nothing else; a
        snapshot that later ``partial_fit``/``finalize`` rounds leave
        untouched. ``exact`` and ``dnc`` raise ``TypeError``: their state
        is O(n), served through ``make_batched_predict``."""
        self._require_fit()
        beta = getattr(self._state, "beta", None)
        landmarks = getattr(self._state, "landmarks", None)
        if beta is None or landmarks is None:
            raise TypeError(
                f"solver {self.config.solver!r} has no O(p) landmark dual to "
                "export — its fitted state scales with the training set; "
                "serve it through make_batched_predict() instead")
        return ServingState(beta=beta, landmarks=landmarks,
                            col_weights=getattr(self._state, "col_weights",
                                                None),
                            solver=self.config.solver)

    def import_serving_state(self, serving: ServingState) -> "SketchedKRR":
        """Install an exported O(p) serving state (moved to this
        estimator's device). The solvers must match: duals are not
        portable across solvers."""
        if serving.solver != self.config.solver:
            raise ValueError(
                f"serving state was exported from solver {serving.solver!r} "
                f"but this estimator is configured for "
                f"{self.config.solver!r}; duals are not portable across "
                "solvers")
        weights = serving.col_weights
        self._state = solver_state_from_serving(serving._replace(
            beta=serving.beta.to(self.device),
            landmarks=serving.landmarks.to(self.device),
            col_weights=None if weights is None else weights.to(self.device)))
        self._sample = self._scores = self._X_train = None
        self._accum = None
        self._predict_fn = None
        return self

    # ---------------------------------------------------------- diagnostics

    def scores(self) -> Tensor:
        """The sampler's unnormalized score vector (leverage estimates for
        the rls_* samplers, K_ii for diagonal, ones for uniform)."""
        self._require_fit()
        if self._scores is None:
            self._run_sampler()
        return self._scores

    def sample(self) -> ColumnSample:
        """The Theorem-3 column draw behind the fit."""
        self._require_fit()
        if self._sample is None:
            self._run_sampler()
        return self._sample

    def state(self) -> Any:
        """The raw fitted solver state (solver-specific named tuple)."""
        self._require_fit()
        return self._state

    def ops(self) -> KernelOps:
        """The resolved ``KernelOps`` executor of this model."""
        return ops_for_config(self.config)

    def risk(self, f_star, noise_std: float) -> RiskReport:
        """Closed-form eq.-(4) risk when the solver has one; otherwise the
        empirical risk (1/n)‖f̂ − f*‖² at the training points, with NaN
        bias and variance."""
        self._require_fit()
        f_star = self._cast(f_star)
        report = self._solver.risk(self.config, self._state, f_star,
                                   noise_std)
        if report is None:
            r = empirical_risk(self.predict_train(), f_star)
            nan = torch.full_like(r, float("nan"))
            report = RiskReport(r, nan, nan)
        return report

    def __repr__(self) -> str:
        fitted = "fitted" if self._state is not None else "unfitted"
        return (f"SketchedKRR(sampler={self.config.sampler!r}, "
                f"solver={self.config.solver!r}, p={self.config.p}, "
                f"lam={self.config.lam}, device={self.device}, {fitted})")
