"""Exact λ-ridge leverage scores and the paper's fast O(np²) approximation.

Definition 1:   l_i(λ) = [K (K + nλ I)^{-1}]_ii = Σ_j σ_j/(σ_j + nλ) U_ij²
Effective dim:  d_eff(λ) = Σ_i l_i(λ) = Tr(K (K + nλ I)^{-1})
Max d.o.f.:     d_mof(λ) = n · max_i l_i(λ)            (Bach [2])

Fast approximation (paper §3.5 / Theorem 4):
  1. sample p landmarks with p_i = K_ii / Tr(K) (squared-length sampling),
  2. B with B Bᵀ = C W† Cᵀ (Cholesky of W, triangular solve against Cᵀ),
  3. l̃_i = B_iᵀ (BᵀB + nλ I)^{-1} B_i   — everything in dimension p.

Guarantees (Theorem 4, for p ≥ 8(Tr(K)/(nλε) + 1/6) log(n/ρ)):
  additive:        l_i(λ) − 2ε ≤ l̃_i ≤ l_i(λ)
  multiplicative:  ((σ_n − nλε)/(σ_n + nλε)) l_i(λ) ≤ l̃_i ≤ l_i(λ)
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor

from .backends import KernelOps, landmark_cholesky, ops_for
from .kernels import Kernel
from .precision import Precision, precision_independent_probs


# ---------------------------------------------------------------- exact path

def ridge_leverage_scores(K: Tensor, lam: float) -> Tensor:
    """Exact l_i(λ) = diag(K (K + nλI)^{-1}) = 1 − nλ·diag(A^{-1}).  O(n³)."""
    n = K.shape[0]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    Lchol = torch.linalg.cholesky(K + n * lam * eye)
    V = torch.linalg.solve_triangular(Lchol, eye, upper=False)
    return 1.0 - n * lam * torch.sum(V * V, dim=0)


def ridge_leverage_scores_eig(K: Tensor, lam: float) -> Tensor:
    """Definition-1 form through the eigendecomposition (oracle for tests)."""
    n = K.shape[0]
    sig, U = torch.linalg.eigh(K)
    sig = torch.clamp_min(sig, 0.0)
    return (U * U) @ (sig / (sig + n * lam))


def effective_dimension(K: Tensor, lam: float) -> Tensor:
    """d_eff(λ) = Tr(K (K + nλI)^{-1})."""
    return torch.sum(ridge_leverage_scores(K, lam))


def max_degrees_of_freedom(K: Tensor, lam: float) -> Tensor:
    """Bach's d_mof(λ) = n ‖diag(K (K + nλI)^{-1})‖_∞."""
    return K.shape[0] * torch.max(ridge_leverage_scores(K, lam))


def theorem3_sample_size(d_eff: float, n: int, beta: float = 1.0,
                         rho: float = 0.1) -> int:
    """p ≥ 8 (d_eff/β + 1/6) log(n/ρ)  (Theorem 3)."""
    return int(math.ceil(8.0 * (d_eff / beta + 1.0 / 6.0) * math.log(n / rho)))


def theorem4_sample_size(trace_K: float, n: int, lam: float, eps: float,
                         rho: float = 0.1) -> int:
    """p ≥ 8 (Tr(K)/(nλε) + 1/6) log(n/ρ)  (Theorem 4)."""
    return int(math.ceil(8.0 * (trace_K / (n * lam * eps) + 1.0 / 6.0)
                         * math.log(n / rho)))


# ------------------------------------------------------------ fast O(np²)

class FastLeverageResult(NamedTuple):
    scores: Tensor          # l̃_i, shape (n,)
    landmarks: Tensor       # sampled indices, shape (p,)
    B: Tensor | None        # (n, p) factor with B Bᵀ = C W† Cᵀ; None when
                            # the executor streams the pass (never formed)
    d_eff_estimate: Tensor
    row_sq: Tensor | None = None   # ‖B_i‖², (n,), when B is None


def _nystrom_factor(C: Tensor, W: Tensor, jitter: float, *,
                    solve_dtype=None) -> Tensor:
    """B such that B Bᵀ = C Wj^{-1} Cᵀ, via Cholesky of the jittered W.

    Step 4 of the paper's algorithm: Cholesky on the p×p overlap W
    (``backends.landmark_cholesky``, with its R1 rescue) and a triangular
    solve against C — O(p³ + np²). ``solve_dtype`` runs both at that
    precision; B comes back in C's dtype.
    """
    Lchol = landmark_cholesky(W, jitter, solve_dtype=solve_dtype)
    # B = C L^{-T}  =>  B Bᵀ = C (L Lᵀ)^{-1} Cᵀ
    B = torch.linalg.solve_triangular(Lchol.T, C.to(Lchol.dtype), upper=True,
                                      left=False)
    return B.to(C.dtype)


def draw_landmarks(gen: torch.Generator, probs: Tensor, p: int,
                   replace: bool = True) -> Tensor:
    """The Theorem-4 landmark draw: p indices from ``probs`` (float64,
    drawn on the host from the CPU generator ``gen``, so a seed gives the
    same set on every device and at every pipeline precision)."""
    wide = precision_independent_probs(probs).cpu()
    idx = torch.multinomial(wide, p, replacement=replace, generator=gen)
    return idx.to(probs.device)


def fast_ridge_leverage(
    kernel: Kernel,
    X: Tensor,
    lam: float,
    p: int,
    gen: torch.Generator | None = None,
    *,
    probs: Tensor | None = None,
    jitter: float = 1e-10,
    replace: bool = True,
    ops: KernelOps | None = None,
    idx: Tensor | None = None,
) -> FastLeverageResult:
    """The paper's §3.5 algorithm, end to end, never materializing K.

    Samples p landmarks with the Theorem-4 distribution p_i = K_ii / Tr(K)
    (or ``probs``) from ``gen`` — or takes them from ``idx``, which lets a
    test inject another implementation's draw. ``ops`` selects the kernel
    backend (``None`` → ``auto`` for X's device). An executor that streams
    the score pass (``streaming``) never forms C or B: the result then
    carries ``B=None`` and the ‖B_i‖² rows in ``row_sq``.
    """
    if ops is None:
        ops = ops_for(kernel, device=X.device)
    n = X.shape[0]
    if idx is None:
        if probs is None:
            diag = kernel.diag(X)
            probs = diag / torch.sum(diag)
        idx = draw_landmarks(gen, probs, p, replace)
    idx = idx.to(X.device)
    if getattr(ops, "streams_score_pass", False):
        scores, row_sq = ops.score_pass(X, idx, lam, jitter)
        return FastLeverageResult(scores, idx, None, torch.sum(scores),
                                  row_sq)
    C = ops.columns(X, idx)                     # (n, p): only p columns of K
    pr = getattr(ops, "precision", None) or Precision()
    B = _nystrom_factor(C, C[idx, :], jitter,
                        solve_dtype=pr.solve_for(C.dtype))
    del C
    scores = ops.leverage_scores(B, lam, n)
    return FastLeverageResult(scores, idx, B, torch.sum(scores))
