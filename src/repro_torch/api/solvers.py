"""Solvers behind one protocol (paper §2; footnote 4).

A ``Solver`` turns (config, X, y, column sample) into a fitted state and
maps that state to predictions at arbitrary points — including the
out-of-sample Nyström extension f̂(x) = k(x, Z)·β (β lives in landmark
space, so predict is O(batch·p·dim)). Every kernel block comes from the
``KernelOps`` backend configured on the ``SketchConfig``.

Registry entries → paper results:
  exact               α = (K + nλI)^{-1}y          eq. (2); O(n³) reference.
  nystrom             L = C W† Cᵀ                   §2 classic sketch, solved
                                                    through Woodbury (Thm 3).
  nystrom_regularized L_γ = KS(SᵀKS + nγI)^{-1}SᵀK footnote 4 / App. C.

The three also fit incrementally: ``begin_chunked(config, landmarks,
sample)`` returns a ``ChunkAccumulator`` that the out-of-core driver
(``repro_torch.api.out_of_core``) and ``SketchedKRR.partial_fit`` feed one
row chunk at a time — O(p²) sufficient statistics for the Nyström solvers,
buffered rows for ``exact``.

The reference's iterative, divide-and-conquer and distributed solvers are
ROADMAP items 6, 7 and 9.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Protocol

import torch
from torch import Tensor

from ..core.backends import KernelOps, ops_for_config
from ..core.krr import (RiskReport, krr_fit, nystrom_krr_fit, risk_exact,
                        risk_nystrom)
from ..core.nystrom import (ColumnSample, NystromApprox,
                            nystrom_beta_from_stats, nystrom_factors,
                            nystrom_regularized_beta_from_stats,
                            nystrom_regularized_factors)
from ..core.precision import to_dtype
from ..data.sparse import CsrMatrix
from ..registry import Registry
from .config import SketchConfig


def _ops(config: SketchConfig) -> KernelOps:
    """The configured kernel-execution backend."""
    return ops_for_config(config)


def _solve_cast(config: SketchConfig, *arrays: Tensor):
    """Arrays up-cast to an explicitly requested ``solve_dtype``, else
    untouched (the reference's rule: the default sub-f64 widening is for
    the score pass's near-singular overlap, not for these nλ-shifted fits
    over the O(n·p) sketch)."""
    sd = config.precision.solve_dtype
    out = arrays if sd is None else tuple(a.to(to_dtype(sd)) for a in arrays)
    return out if len(out) > 1 else out[0]


class Solver(Protocol):
    """fit/predict/risk; ``needs_sample`` tells the estimator whether to
    run the configured sampler before fitting. Solvers that fit
    incrementally also expose ``begin_chunked(config, landmarks, sample)
    -> ChunkAccumulator``."""

    needs_sample: bool

    def fit(self, config: SketchConfig, X: Tensor, y: Tensor,
            sample: ColumnSample | None) -> Any: ...

    def predict(self, config: SketchConfig, state: Any,
                X_test: Tensor) -> Tensor: ...

    def predict_train(self, config: SketchConfig, state: Any,
                      X_train: Tensor) -> Tensor: ...

    def risk(self, config: SketchConfig, state: Any, f_star: Tensor,
             noise_std: float) -> RiskReport: ...


SOLVERS: Registry[Solver] = Registry("solver")


# ----------------------------------------------- chunked-fit accumulators

class ChunkAccumulator(Protocol):
    """Streaming half of a solver: per-chunk statistics in, state out.

    ``add`` folds one row chunk into the running statistics (``n_valid``
    masks a zero-padded tail); ``finalize`` turns the statistics seen so
    far into a fitted state and may be called again after more ``add``
    calls — the contract behind ``SketchedKRR.partial_fit``/``finalize``.
    """

    def add(self, Xb, yb: Tensor, n_valid: int | None = None) -> None: ...

    def finalize(self, n: int) -> Any: ...


class _NystromChunkAccumulator:
    """O(p²) sufficient statistics for the two Nyström solvers.

    Accumulates Gc = Σ_b C_bᵀC_b and bc = Σ_b C_bᵀy_b over (for the
    regularized sketch, weight-scaled) column chunks C_b = k(X_b, Z), each
    block from the configured ``KernelOps`` executor (K1 for dense chunks,
    K3 for CSR ones under ``hopper``). ``finalize`` maps them to β through
    the ``*_beta_from_stats`` algebra; nothing of size O(n) is held, so the
    state carries no training factor (``approx=None``).

    Chunk reductions run in the policy's accumulation dtype. The p×p
    finalization follows the in-memory ``_solve_cast`` rule — an explicit
    ``solve_dtype`` up-casts, otherwise the data dtype is kept, so
    ``chunk_rows`` stays a pure memory knob — except that sub-f32 storage
    widens to the policy's solve resolution (no sub-f32 factorizations).
    """

    def __init__(self, config: SketchConfig, landmarks: Tensor,
                 sample: ColumnSample | None, *, regularized: bool):
        self.config = config
        self.ops = _ops(config)
        self.Z = landmarks
        self.sample = sample
        self.weights = sample.weights if regularized else None
        self.accum_dtype, wide = self.ops.score_pass_dtypes(landmarks.dtype)
        if config.precision.solve_dtype is not None:
            self.solve_dtype = to_dtype(config.precision.solve_dtype)
        elif landmarks.dtype.itemsize < 4:
            self.solve_dtype = wide     # bf16/f16 cannot factor at all
        else:
            self.solve_dtype = landmarks.dtype
        p = landmarks.shape[0]
        self.Gc = torch.zeros((p, p), dtype=self.accum_dtype,
                              device=landmarks.device)
        self.bc: Tensor | None = None   # allocated on the first chunk's y
        self.prepared = None            # K3's landmarks, at the first CSR chunk

    def add(self, Xb, yb: Tensor, n_valid: int | None = None) -> None:
        """Fold one (possibly tail-padded) chunk into the statistics."""
        rows = Xb.shape[0]
        n_valid = rows if n_valid is None else int(n_valid)
        if self.bc is None:
            self.bc = torch.zeros((self.Z.shape[0],) + tuple(yb.shape[1:]),
                                  dtype=self.accum_dtype, device=self.Z.device)
        mb = (torch.arange(rows, device=self.Z.device) < n_valid).to(
            self.Z.dtype)
        if isinstance(Xb, CsrMatrix) and self.prepared is None:
            self.prepared = self.ops.prepare_sparse(self.Z)
        Cs = self.ops.cross(Xb, self.Z, prepared=self.prepared)
        if self.weights is not None:
            Cs = Cs * self.weights[None, :]
        # mask BEFORE the reductions: padded rows are exact zeros
        Cs = (Cs * mb[:, None]).to(self.accum_dtype)
        yb = (yb * mb.reshape((-1,) + (1,) * (yb.ndim - 1))).to(
            self.accum_dtype)
        self.Gc = self.Gc + Cs.T @ Cs
        self.bc = self.bc + Cs.T @ yb

    def finalize(self, n: int) -> "NystromState":
        """β from the statistics seen so far (p×p algebra, O(p³))."""
        if self.bc is None:
            raise ValueError("no chunks accumulated")
        cfg, sd = self.config, self.solve_dtype
        W = self.ops.cross(self.Z, self.Z).to(sd)
        Gc, bc = self.Gc.to(sd), self.bc.to(sd)
        if self.weights is not None:
            gamma = cfg.lam if cfg.gamma is None else cfg.gamma
            beta = nystrom_regularized_beta_from_stats(
                W, self.weights.to(sd), Gc, bc, n, gamma, cfg.lam)
        else:
            beta = nystrom_beta_from_stats(W, Gc, bc, n, cfg.lam,
                                           jitter=cfg.jitter)
        return NystromState(None, None, beta.to(self.Z.dtype), self.Z,
                            self.weights)


class _BufferChunkAccumulator:
    """The exact solver's accumulator: its sufficient statistic is the data
    itself, so valid rows are buffered on the host and ``finalize`` runs
    the in-memory fit on them. O(n·d) — for API uniformity and small n."""

    def __init__(self, config: SketchConfig, solver: "Solver"):
        self.config, self.solver = config, solver
        self._xs: list[Tensor] = []
        self._ys: list[Tensor] = []

    def add(self, Xb: Tensor, yb: Tensor, n_valid: int | None = None) -> None:
        """Buffer one chunk's valid rows."""
        v = Xb.shape[0] if n_valid is None else int(n_valid)
        self._xs.append(Xb[:v].cpu())
        self._ys.append(yb[:v].cpu())

    def finalize(self, n: int) -> Any:
        """Concatenate the buffered rows and run the in-memory fit."""
        if not self._xs:
            raise ValueError("no chunks accumulated")
        dev = torch.device(self.config.device)
        return self.solver.fit(self.config, torch.cat(self._xs).to(dev),
                               torch.cat(self._ys).to(dev), None)


def _require_factor(state, what: str) -> NystromApprox:
    """Loud failure for diagnostics that need the O(n·p) training factor,
    which neither an out-of-core fit nor an imported O(p) serving state
    keeps."""
    if state.approx is None:
        raise RuntimeError(
            f"{what} needs the O(n·p) training factor, which an out-of-core "
            "/ partial_fit model or one imported from an O(p) serving state "
            "does not carry (its state is the O(p) landmark dual); for "
            "closed-form diagnostics fit in memory with chunk_rows=None")
    return state.approx


# ----------------------------------------------------------------- exact

class ExactState(NamedTuple):
    alpha: Tensor     # (n,) dual coefficients
    X_train: Tensor
    K: Tensor         # kept for closed-form risk


class ExactSolver:
    """Full-K KRR (eq. 2) — the O(n³) reference everything sketches."""

    needs_sample = False

    def fit(self, config, X, y, sample):
        K = _ops(config).cross(X, X)
        K, y = _solve_cast(config, K, y)
        return ExactState(krr_fit(K, y, config.lam), X, K)

    def begin_chunked(self, config, landmarks, sample):
        """Chunked fitting by buffering rows (``_BufferChunkAccumulator``):
        the exact solver has no sufficient statistic below the data."""
        return _BufferChunkAccumulator(config, self)

    def predict(self, config, state, X_test):
        return _ops(config).matvec(X_test, state.X_train, state.alpha)

    def predict_train(self, config, state, X_train):
        return state.K @ state.alpha

    def risk(self, config, state, f_star, noise_std):
        return risk_exact(state.K, f_star, config.lam, noise_std)


SOLVERS.register("exact")(ExactSolver())


# --------------------------------------------------- Nyström (plain / L_γ)

class NystromState(NamedTuple):
    approx: NystromApprox | None
    alpha: Tensor | None       # (n,) dual through the Woodbury solve
    beta: Tensor               # (p,) landmark-space dual for prediction
    landmarks: Tensor          # (p, dim) sampled points Z
    col_weights: Tensor | None  # S weights scaling k(·, Z) (regularized only)


def _nystrom_predict(config, state, X_test):
    # (k(x, Z)·w) @ β == k(x, Z) @ (w·β): fold S's weights into the dual so
    # the whole predict is one implicit-C matvec
    beta = state.beta
    if state.col_weights is not None:
        beta = beta * state.col_weights.reshape(
            (-1,) + (1,) * (beta.ndim - 1))
    return _ops(config).matvec(X_test, state.landmarks, beta)


def _nystrom_predict_train(config, state, X_train):
    # L α through the cached factor — zero kernel evaluations
    return _require_factor(state, "predict_train()").matvec(state.alpha)


class NystromSolver:
    """Classic sketch L = C W† Cᵀ, fitted through Woodbury (Theorem 3)."""

    needs_sample = True

    def fit(self, config, X, y, sample):
        C = _ops(config).columns(X, sample.idx)
        C, y = _solve_cast(config, C, y)
        F, G = nystrom_factors(C, sample.idx, jitter=config.jitter)
        del C
        approx = NystromApprox(F, sample)
        alpha = nystrom_krr_fit(approx, y, config.lam)
        # Nyström extension: f̂(x) = k(x, Z) W† Cᵀ α = k(x, Z) G (Fᵀ α)
        beta = G @ (F.T @ alpha)
        return NystromState(approx, alpha, beta, X[sample.idx], None)

    def begin_chunked(self, config, landmarks, sample):
        """O(p²) sufficient statistics (``_NystromChunkAccumulator``)."""
        return _NystromChunkAccumulator(config, landmarks, sample,
                                        regularized=False)

    predict = staticmethod(_nystrom_predict)
    predict_train = staticmethod(_nystrom_predict_train)

    def risk(self, config, state, f_star, noise_std):
        return risk_nystrom(_require_factor(state, "risk()"), f_star,
                            config.lam, noise_std)


class NystromRegularizedSolver:
    """Footnote-4 sketch L_γ = KS(SᵀKS + nγI)^{-1}SᵀK — no λ lower-bound
    condition; γ defaults to λ when unset."""

    needs_sample = True

    def fit(self, config, X, y, sample):
        gamma = config.lam if config.gamma is None else config.gamma
        n = X.shape[0]
        C = _ops(config).columns(X, sample.idx)
        C, y = _solve_cast(config, C, y)
        F, Lchol = nystrom_regularized_factors(C, sample.idx, sample.weights,
                                               n, gamma)
        del C
        approx = NystromApprox(F, sample)
        alpha = nystrom_krr_fit(approx, y, config.lam)
        # f̂(x) = (k(x, Z)·w) A^{-1} Csᵀ α = (k(x, Z)·w) L^{-T} (Fᵀ α)
        FTa = F.T @ alpha
        beta = torch.linalg.solve_triangular(
            Lchol.T, FTa[:, None] if FTa.ndim == 1 else FTa, upper=True)
        beta = beta[:, 0] if FTa.ndim == 1 else beta
        return NystromState(approx, alpha, beta, X[sample.idx],
                            sample.weights)

    def begin_chunked(self, config, landmarks, sample):
        """O(p²) sufficient statistics of the L_γ sketch
        (``_NystromChunkAccumulator``)."""
        return _NystromChunkAccumulator(config, landmarks, sample,
                                        regularized=True)

    predict = staticmethod(_nystrom_predict)
    predict_train = staticmethod(_nystrom_predict_train)

    def risk(self, config, state, f_star, noise_std):
        return risk_nystrom(_require_factor(state, "risk()"), f_star,
                            config.lam, noise_std)


SOLVERS.register("nystrom")(NystromSolver())
SOLVERS.register("nystrom_regularized")(NystromRegularizedSolver())
