"""Theorem-2 / matrix-Bernstein machinery (paper §3.2, Appendix B).

These are analysis utilities: they evaluate the paper's bounds so tests
and benchmarks can check that empirical deviations respect the predicted
tails, and they back the sample-size formulas of the samplers.
"""
from __future__ import annotations

import math

import torch
from torch import Tensor


def bernstein_tail(t: float, p: int, lam_max: float, frob_sq: float,
                   beta: float, dim: int) -> float:
    """RHS of eq. (7):  n·exp( −p t²/2 / (λ_max(ΨΨᵀ)(‖Ψ‖_F²/β + t/3)) )."""
    denom = lam_max * (frob_sq / beta + t / 3.0)
    return dim * math.exp(-p * t * t / 2.0 / denom)


def theorem2_required_p(t: float, lam_max: float, frob_sq: float, beta: float,
                        dim: int, rho: float) -> int:
    """Smallest p making the Theorem-2 tail ≤ ρ."""
    denom = lam_max * (frob_sq / beta + t / 3.0)
    return int(math.ceil(2.0 * denom * math.log(dim / rho) / (t * t)))


def beta_of_distribution(probs: Tensor, col_norms_sq: Tensor) -> Tensor:
    """Largest β with probs_i ≥ β ‖ψ_i‖²/‖Ψ‖_F² for all i (paper eq. 6).

    β = min_i probs_i ‖Ψ‖_F² / ‖ψ_i‖².  For uniform sampling this recovers
    Bach's coherence-style quantity ‖Ψ‖_F² / (m·max_i ‖ψ_i‖²).
    """
    frob_sq = torch.sum(col_norms_sq)
    mask = col_norms_sq > 0
    ratios = torch.where(
        mask, probs * frob_sq / torch.clamp_min(col_norms_sq, 1e-300),
        torch.full_like(col_norms_sq, math.inf))
    return torch.clamp(torch.min(ratios), 0.0, 1.0)


def psi_matrix(K: Tensor, gamma: float) -> Tensor:
    """Ψ = Φ^{1/2} Uᵀ with Φ = Σ(Σ + nγI)^{-1}: column norms are l_i(γ),
    ‖Ψ‖_F² = d_eff(γ), λ_max(ΨΨᵀ) ≤ 1 (Appendix C)."""
    n = K.shape[0]
    sig, U = torch.linalg.eigh(K)
    sig = torch.clamp_min(sig, 0.0)
    phi = sig / (sig + n * gamma)
    return torch.sqrt(phi)[:, None] * U.T


def sketch_deviation(Psi: Tensor, S: Tensor) -> Tensor:
    """λ_max(ΨΨᵀ − Ψ S Sᵀ Ψᵀ) — the quantity Theorem 2 controls."""
    PS = Psi @ S
    M = Psi @ Psi.T - PS @ PS.T
    return torch.max(torch.linalg.eigvalsh(0.5 * (M + M.T)))
