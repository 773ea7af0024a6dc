"""Kernel ridge regression estimators and exact risk computation (paper §2).

Model:  y = f*(x_i) + σ ξ_i,  ξ ~ N(0, I).
Estimator with kernel matrix M (either K or a Nyström L):
    α = (M + nλ I)^{-1} y,   f̂_M = M α.
Risk (eq. 4):
    R(f̂_M) = bias(M)² + variance(M)
    bias(M)²   = nλ² ‖(M + nλI)^{-1} f*‖²
    variance(M)= σ²/n · Tr(M² (M + nλI)^{-2})

The Nyström path never forms L: with L = F Fᵀ (F ∈ R^{n×r}), all solves go
through the Woodbury identity in dimension r:
    (F Fᵀ + nλ I)^{-1} v = (v − F (FᵀF + nλ I_r)^{-1} Fᵀ v) / (nλ).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from .kernels import Kernel
from .nystrom import NystromApprox


class RiskReport(NamedTuple):
    risk: Tensor
    bias_sq: Tensor
    variance: Tensor


def _eye(r: int, like: Tensor) -> Tensor:
    return torch.eye(r, dtype=like.dtype, device=like.device)


def _cho_solve(c: Tensor, b: Tensor) -> Tensor:
    """A^{-1} b for A = c cᵀ; a vector b is solved as one column."""
    if b.ndim == 1:
        return torch.cholesky_solve(b[:, None], c)[:, 0]
    return torch.cholesky_solve(b, c)


# ------------------------------------------------------------- exact (K) path

def krr_fit(K: Tensor, y: Tensor, lam: float) -> Tensor:
    """α = (K + nλI)^{-1} y via Cholesky."""
    n = K.shape[0]
    c = torch.linalg.cholesky(K + n * lam * _eye(n, K))
    return _cho_solve(c, y)


def krr_predict_train(K: Tensor, alpha: Tensor) -> Tensor:
    return K @ alpha


def krr_predict(kernel: Kernel, X_train: Tensor, X_test: Tensor,
                alpha: Tensor) -> Tensor:
    return kernel.gram(X_test, X_train) @ alpha


def risk_exact(K: Tensor, f_star: Tensor, lam: float,
               noise_std: float) -> RiskReport:
    """Closed-form risk of f̂_K (eq. 4) — no Monte Carlo."""
    n = K.shape[0]
    c = torch.linalg.cholesky(K + n * lam * _eye(n, K))
    Ainv_f = _cho_solve(c, f_star)
    bias_sq = n * lam**2 * torch.sum(Ainv_f**2)
    AinvK = _cho_solve(c, K)                    # Tr(K² A^{-2}) = ‖A^{-1}K‖_F²
    variance = noise_std**2 / n * torch.sum(AinvK * AinvK)
    return RiskReport(bias_sq + variance, bias_sq, variance)


# --------------------------------------------------------- Nyström (L) path

def woodbury_solve(F: Tensor, nlam: float, v: Tensor) -> Tensor:
    """(F Fᵀ + nlam·I)^{-1} v in O(n r² + r³)."""
    r = F.shape[1]
    G = F.T @ F + nlam * _eye(r, F)
    c = torch.linalg.cholesky(0.5 * (G + G.T))
    return (v - F @ _cho_solve(c, F.T @ v)) / nlam


def woodbury_dual_from_stats(G_F: Tensor, b_F: Tensor, nlam: float) -> Tensor:
    """Fᵀα from the r×r sufficient statistics G_F = FᵀF and b_F = Fᵀy:
    Fᵀα = (Fᵀy − (FᵀF)(½(FᵀF + (FᵀF)ᵀ) + nλI)^{-1} Fᵀy) / nλ."""
    r = G_F.shape[0]
    c = torch.linalg.cholesky(0.5 * (G_F + G_F.T) + nlam * _eye(r, G_F))
    return (b_F - G_F @ _cho_solve(c, b_F)) / nlam


def nystrom_krr_fit(approx: NystromApprox, y: Tensor, lam: float) -> Tensor:
    """α = (L + nλI)^{-1} y without forming L."""
    return woodbury_solve(approx.F, y.shape[0] * lam, y)


def nystrom_krr_predict_train(approx: NystromApprox, alpha: Tensor) -> Tensor:
    return approx.matvec(alpha)


def risk_nystrom(approx: NystromApprox, f_star: Tensor, lam: float,
                 noise_std: float) -> RiskReport:
    """Closed-form risk of f̂_L, all in the rank-r factor (O(n r²)):
    bias² = nλ² ‖A^{-1} f*‖², var = σ²/n ‖(A^{-1}F)ᵀ F‖_F², A = L + nλI."""
    F = approx.F
    n = F.shape[0]
    nlam = n * lam
    Ainv_f = woodbury_solve(F, nlam, f_star)
    bias_sq = n * lam**2 * torch.sum(Ainv_f**2)
    M = woodbury_solve(F, nlam, F).T @ F
    variance = noise_std**2 / n * torch.sum(M * M)
    return RiskReport(bias_sq + variance, bias_sq, variance)


def empirical_risk(f_hat: Tensor, f_star: Tensor) -> Tensor:
    """(1/n)‖f̂ − f*‖² — single-noise-draw empirical counterpart of eq. (3)."""
    return torch.mean((f_hat - f_star) ** 2)
