"""Recursive ridge-leverage sampling (beyond-paper refinement).

The paper's Theorem-4 estimator seeds with squared-length (diagonal)
sampling, which needs p = O(Tr(K)/(nλε)) columns — loose when the spectrum
decays fast. The recursive scheme (in the spirit of Musco & Musco 2017)
bootstraps better distributions level by level:

    level 0: diagonal sampling, p₀ columns  → scores l̃⁰
    level i: sample pᵢ columns ∝ l̃^{i-1}    → scores l̃ⁱ  (Theorem-3
             robustness: any β-approximate distribution works, and each
             level's β improves toward 1)

Each level is one ``fast_ridge_leverage`` pass, O(n·pᵢ²), so its kernel
blocks and scores come from the configured ``KernelOps`` backend (K1 and
K2 under ``hopper``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import Tensor

from .kernels import Kernel
from .leverage import FastLeverageResult, fast_ridge_leverage


class RecursiveRLSResult(NamedTuple):
    scores: Tensor                     # final l̃ (lower bound, Thm 4)
    levels: list[FastLeverageResult]
    d_eff_estimates: list[float]
    sampling_scores: list[Tensor]      # per-level overestimates (β-quality)


def row_norms_sq(res: FastLeverageResult) -> Tensor:
    """‖B_i‖² of a score pass, whether or not it formed B."""
    return res.row_sq if res.B is None else torch.sum(res.B * res.B, dim=-1)


def recursive_ridge_leverage(
    kernel: Kernel,
    X: Tensor,
    lam: float,
    p: int,
    gen: torch.Generator | None = None,
    *,
    n_levels: int = 2,
    growth: float = 1.0,
    ops=None,
    levels_idx: Sequence[Tensor] | None = None,
) -> RecursiveRLSResult:
    """``n_levels`` of leverage-refined sampling; level i uses p·growth^i
    columns, drawn from ``gen`` — or taken from ``levels_idx`` (one index
    tensor per level), which lets a test inject another implementation's
    draws. ``ops`` is the ``KernelOps`` executor of every level's pass."""
    if levels_idx is not None and len(levels_idx) != n_levels:
        raise ValueError(f"levels_idx holds {len(levels_idx)} draws for "
                         f"{n_levels} levels")
    n = X.shape[0]
    diag = kernel.diag(X)
    levels: list[FastLeverageResult] = []
    d_effs: list[float] = []
    overs: list[Tensor] = []
    probs = None
    p_i = p
    for i in range(n_levels):
        idx = None if levels_idx is None else levels_idx[i]
        res = fast_ridge_leverage(kernel, X, lam, min(p_i, n), gen,
                                  probs=probs, ops=ops, idx=idx)
        levels.append(res)
        d_effs.append(float(res.d_eff_estimate))
        # the next level samples from an OVERestimate: l̃ only sees
        # in-span mass (Thm 4: l̃ ≤ l), so a point orthogonal to the sketch
        # would never be drawn again. The Nyström residual
        # d_i = K_ii − ‖B_i‖² is the unseen mass; d_i/(d_i + nλ) bounds its
        # leverage contribution (cf. Musco & Musco 2017)
        deficit = torch.clamp_min(diag - row_norms_sq(res), 0.0)
        over = res.scores + deficit / (deficit + n * lam)
        overs.append(over)
        probs = over / torch.sum(over)
        p_i = int(p_i * growth)
    return RecursiveRLSResult(levels[-1].scores, levels, d_effs, overs)


def sampling_beta(scores_approx: Tensor, scores_exact: Tensor) -> Tensor:
    """β of the approximate RLS distribution vs the exact one (paper eq. 6):
    largest β with  p̃_i ≥ β · l_i/Σl_i  — quality of a sampling dist."""
    p_approx = scores_approx / torch.sum(scores_approx)
    p_opt = scores_exact / torch.sum(scores_exact)
    ratio = p_approx / torch.clamp_min(p_opt, 1e-300)
    return torch.min(torch.where(p_opt > 0, ratio,
                                 torch.full_like(ratio, float("inf"))))
