"""Nyström approximations and the column draw (paper §2, §3.4).

Approximators build either
  * the classic  L   = C W† Cᵀ                     (paper §2), or
  * regularized  L_γ = K S (SᵀKS + nγ I)^{-1} SᵀK  (paper footnote 4 / App. C).

Columns are sampled WITH replacement (required by the Theorem-2 Bernstein
argument). The sketching matrix S has S[i_j, j] = 1/sqrt(p * p_{i_j}).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import Tensor

from .precision import floored_jitter, precision_independent_probs


class ColumnSample(NamedTuple):
    idx: Tensor      # (p,) sampled column indices (with replacement)
    probs: Tensor    # (n,) the sampling distribution used
    weights: Tensor  # (p,) 1/sqrt(p * p_{i_j}) — S's non-zero entries


def draw_columns(gen: torch.Generator, probs: Tensor, p: int) -> ColumnSample:
    """Draw p columns with replacement from ``probs`` and build S's weights.

    The draw runs on the host in float64 from the CPU generator ``gen``
    (device- and precision-independent); ``probs``/``weights`` stay in the
    dtype and on the device of the incoming distribution.
    """
    wide = precision_independent_probs(probs).cpu()
    idx = torch.multinomial(wide, p, replacement=True,
                            generator=gen).to(probs.device)
    w = (1.0 / torch.sqrt(p * probs[idx])).to(probs.dtype)
    return ColumnSample(idx, probs, w)


@dataclasses.dataclass(frozen=True)
class NystromApprox:
    """Low-rank factor F with L = F Fᵀ ≈ K, plus sampling metadata."""

    F: Tensor                 # (n, r) factor
    sample: ColumnSample

    def matvec(self, v: Tensor) -> Tensor:
        return self.F @ (self.F.T @ v)

    def dense(self) -> Tensor:
        return self.F @ self.F.T


def _psd_factor(M: Tensor, jitter: float) -> Tensor:
    """G with G Gᵀ = M† (pinv square root) via eigh, clipping tiny/negative
    eigenvalues below max|s|·jitter′ (jitter floored per dtype)."""
    s, V = torch.linalg.eigh(0.5 * (M + M.T))
    tol = torch.max(torch.abs(s)) * floored_jitter(jitter, M.dtype)
    inv_sqrt = torch.where(s > tol, 1.0 / torch.sqrt(torch.maximum(s, tol)),
                           torch.zeros_like(s))
    return V * inv_sqrt[None, :]


def nystrom_factors(C: Tensor, idx: Tensor, *,
                    jitter: float = 1e-10) -> tuple[Tensor, Tensor]:
    """(F, G) with F = C G and G Gᵀ = W†, so F Fᵀ = C W† Cᵀ.

    G is the landmark-space half-inverse needed for out-of-sample Nyström
    extension: f̂(x) = k(x, Z) G (Fᵀ α) with Z the landmark points.
    """
    G = _psd_factor(C[idx, :], jitter)
    return C @ G, G


def nystrom_regularized_factors(C: Tensor, idx: Tensor, weights: Tensor,
                                n: int, gamma: float) -> tuple[Tensor, Tensor]:
    """(F, Lchol) for F Fᵀ = L_γ = K S (SᵀKS + nγI)^{-1} SᵀK.

    With Cs = C·diag(w) = K S and Ws = diag(w)·W·diag(w) = SᵀKS:
      L_γ = Cs (Ws + nγI)^{-1} Csᵀ = F Fᵀ,  F = Cs L^{-T},  A = L Lᵀ.
    """
    Cs = C * weights[None, :]
    Ws = (C[idx, :] * weights[None, :]) * weights[:, None]
    p = Ws.shape[0]
    A = 0.5 * (Ws + Ws.T) + n * gamma * torch.eye(p, dtype=C.dtype,
                                                  device=C.device)
    Lchol = torch.linalg.cholesky(A)
    F = torch.linalg.solve_triangular(Lchol.T, Cs, upper=True, left=False)
    return F, Lchol


# ------------------------------------------- out-of-core sufficient stats
#
# The fitted predictor of either Nyström solver is f̂(x) = k(x, Z)·β with
# β ∈ R^p, and both sketches admit O(p²) sufficient statistics for it: the
# landmark overlap W = k(Z, Z), the accumulated CᵀC (of the weighted
# columns for L_γ) and Cᵀy. The chunked driver streams the two
# accumulators; these finalizers turn them into β with O(p³) work.

def nystrom_beta_from_stats(W: Tensor, CtC: Tensor, Cty: Tensor, n: int,
                            lam: float, *, jitter: float = 1e-10) -> Tensor:
    """β of the classic sketch L = C W† Cᵀ from O(p²) statistics: with
    F = C G (G Gᵀ = W†), FᵀF = Gᵀ(CᵀC)G and Fᵀy = Gᵀ(Cᵀy), and
    β = G (Fᵀα) — the ``NystromSolver`` β without C or F."""
    from .krr import woodbury_dual_from_stats
    G = _psd_factor(W, jitter)
    G_F = G.T @ CtC @ G
    b_F = G.T @ Cty
    return G @ woodbury_dual_from_stats(G_F, b_F, n * lam)


def nystrom_regularized_beta_from_stats(W: Tensor, weights: Tensor,
                                        CtC: Tensor, Cty: Tensor, n: int,
                                        gamma: float, lam: float) -> Tensor:
    """β of the footnote-4 sketch L_γ from O(p²) statistics over the
    weighted columns Cs = C·diag(w): with A = ½(Ws + Wsᵀ) + nγI = L Lᵀ and
    F = Cs L^{-T}, FᵀF = L^{-1}(CsᵀCs)L^{-T}, Fᵀy = L^{-1}(Csᵀy) and
    β = L^{-T}(Fᵀα) — the ``NystromRegularizedSolver`` algebra term for
    term."""
    from .krr import woodbury_dual_from_stats
    Ws = (W * weights[None, :]) * weights[:, None]
    p = Ws.shape[0]
    A = 0.5 * (Ws + Ws.T) + n * gamma * torch.eye(p, dtype=W.dtype,
                                                  device=W.device)
    Lchol = torch.linalg.cholesky(A)
    t1 = torch.linalg.solve_triangular(Lchol, CtC, upper=False)
    G_F = torch.linalg.solve_triangular(Lchol, t1.T, upper=False).T
    vec = Cty.ndim == 1
    b_F = torch.linalg.solve_triangular(
        Lchol, Cty[:, None] if vec else Cty, upper=False)
    dual = woodbury_dual_from_stats(G_F, b_F, n * lam)
    beta = torch.linalg.solve_triangular(Lchol.T, dual, upper=True)
    return beta[:, 0] if vec else beta
