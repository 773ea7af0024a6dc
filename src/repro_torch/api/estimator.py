"""The ``SketchedKRR`` estimator — one object for the whole paper pipeline.

    config = SketchConfig(kernel=RBFKernel(1.5), p=200, lam=1e-3)
    model = SketchedKRR(config).fit(X, y)     # on the card by default
    y_hat = model.predict(X_test)             # out-of-sample Nyström extension
    l_hat = model.scores()                    # sampler's leverage estimates
    report = model.risk(f_star, noise_std)    # closed-form eq.-(4) risk

``fit`` seeds its CPU ``torch.Generator`` streams from ``config.seed``, so a
fit is a pure function of (config, X, y) and draws the same landmarks on
every device. Every kernel block the sampler, the solver and prediction
evaluate goes through the ``KernelOps`` backend selected by
``config.backend`` (``auto``: the Hopper kernels on CUDA, the plain
PyTorch path on the CPU).

The fitted model of the landmark solvers is the O(p) ``ServingState`` —
β, the landmark rows Z and the sketch column weights — which
``export_serving_state``/``import_serving_state`` move between estimators,
and ``serving_state_from_reference`` builds from the JAX package's export.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..core.backends import KernelOps, ops_for_config
from ..core.krr import RiskReport
from ..core.nystrom import ColumnSample
from ..device import resolve_device
from .config import SketchConfig
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

    # ------------------------------------------------------------- fitting

    def _cast(self, arr) -> Tensor:
        """``arr`` on the config's device, in its data dtype (None keeps
        the input dtype)."""
        return torch.as_tensor(arr, dtype=self.config.precision.data(),
                               device=self.device)

    def fit(self, X, y, *, sample: ColumnSample | None = None,
            score_landmarks: Tensor | None = None) -> "SketchedKRR":
        """Fit from in-memory rows.

        ``sample`` (a ``ColumnSample``) and ``score_landmarks`` (the
        Theorem-4 pass's landmark indices) replace the fit's own random
        draws with given ones — the seam through which the parity tests
        inject the reference's draws, which PyTorch cannot reproduce.
        """
        self._X_train = self._cast(X)
        y = self._cast(y)
        self._sample = self._scores = None
        self._injected = {
            "landmarks": None if score_landmarks is None
            else torch.as_tensor(score_landmarks, device=self.device),
            "sample": None if sample is None else ColumnSample(
                *(torch.as_tensor(a, device=self.device) for a in sample))}
        # solvers that ignore the sample (exact) skip the sampling pass;
        # scores()/sample() run it lazily from the same seed
        drawn = self._run_sampler() if self._solver.needs_sample else None
        self._state = self._solver.fit(self.config, self._X_train, y, drawn)
        return self

    def _run_sampler(self) -> ColumnSample:
        if self._X_train is None:
            raise NotFittedError(
                "sampler diagnostics need the in-memory training set, which "
                "a model imported from a serving state does not have")
        out = self._sampler(tuple(streams(self.config.seed, 2)),
                            self.config.kernel, self._X_train, self.config,
                            **self._injected)
        self._sample, self._scores = out.sample, out.scores
        return self._sample

    def _require_fit(self) -> None:
        if self._state is None:
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

    def predict_batched(self, X_test, batch_size: int = 256) -> Tensor:
        """Predict in fixed-size batches, padding the tail batch with
        copies of its last row (the serve path's fixed shapes).

        With ``config.precision.serve_dtype`` set, each batch is cast to
        that dtype and its blocks are evaluated there."""
        self._require_fit()
        X_test = self._cast(X_test)
        n = X_test.shape[0]
        if n == 0:
            return self.predict(X_test)
        cfg, solver, state = self.config, self._solver, self._state
        serve = cfg.precision.serve()
        if serve is not None:
            cfg = cfg.replace(precision=cfg.precision.for_serving())
        outs = []
        for start in range(0, n, batch_size):
            blk = X_test[start:start + batch_size]
            valid = blk.shape[0]
            if valid < batch_size:
                blk = torch.cat([blk, blk[-1:].expand(batch_size - valid,
                                                      *blk.shape[1:])])
            if serve is not None:
                blk = blk.to(serve)
            outs.append(solver.predict(cfg, state, blk)[:valid])
        return torch.cat(outs)

    # ------------------------------------------------------- serving state

    def export_serving_state(self) -> ServingState:
        """The O(p) state a serving process needs — and nothing else.
        ``exact`` raises ``TypeError``: its state is O(n)."""
        self._require_fit()
        beta = getattr(self._state, "beta", None)
        landmarks = getattr(self._state, "landmarks", None)
        if beta is None or landmarks is None:
            raise TypeError(
                f"solver {self.config.solver!r} has no O(p) landmark dual to "
                "export — its fitted state scales with the training set")
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
        self._state = NystromState(
            approx=None, alpha=None, beta=serving.beta.to(self.device),
            landmarks=serving.landmarks.to(self.device),
            col_weights=None if weights is None else weights.to(self.device))
        self._sample = self._scores = self._X_train = None
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
        """Closed-form eq.-(4) risk of the fitted model."""
        self._require_fit()
        return self._solver.risk(self.config, self._state,
                                 self._cast(f_star), noise_std)

    def __repr__(self) -> str:
        fitted = "fitted" if self._state is not None else "unfitted"
        return (f"SketchedKRR(sampler={self.config.sampler!r}, "
                f"solver={self.config.solver!r}, p={self.config.p}, "
                f"lam={self.config.lam}, device={self.device}, {fitted})")
