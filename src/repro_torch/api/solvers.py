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
from ..core.nystrom import (ColumnSample, NystromApprox, nystrom_factors,
                            nystrom_regularized_factors)
from ..core.precision import to_dtype
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
    run the configured sampler before fitting."""

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


def _require_factor(state, what: str) -> NystromApprox:
    """Loud failure for diagnostics that need the O(n·p) training factor a
    state imported from O(p) serving state does not carry."""
    if state.approx is None:
        raise RuntimeError(
            f"{what} needs the O(n·p) training factor, which a model "
            "imported from an O(p) serving state does not carry; fit in "
            "memory for closed-form diagnostics")
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

    predict = staticmethod(_nystrom_predict)
    predict_train = staticmethod(_nystrom_predict_train)

    def risk(self, config, state, f_star, noise_std):
        return risk_nystrom(_require_factor(state, "risk()"), f_star,
                            config.lam, noise_std)


SOLVERS.register("nystrom")(NystromSolver())
SOLVERS.register("nystrom_regularized")(NystromRegularizedSolver())
