"""BLESS: bottom-up sequential ridge-leverage sampling (beyond-paper).

The Theorem-4 fast score pass is one-shot: it pays O(n·p_scores²) against a
dictionary sized for the final λ, although most of those columns only
matter at coarse regularization. BLESS ("On Fast Leverage Score Sampling
and Optimal Learning", Rudi et al. 2018, arXiv:1810.13258) reaches the same
ridge-leverage guarantees bottom-up, annealing λ through a geometric
schedule

    λ_max = Tr(K)/n  >  λ_1  >  λ_2  >  …  >  λ_H = λ_target

and, at each stage h, scoring every row at λ_h against the current small
dictionary D_{h-1}, then drawing an expanded dictionary D_h ∝ those
scores. Why it is cheap and sound:

  * at λ_max = Tr(K)/n, d_eff(λ) = Σ_i l_i(λ) ≤ 1, so the squared-length
    (Theorem-4 seed) draw of a tiny dictionary is already a β-good
    leverage distribution there;
  * one anneal step λ → λ/r inflates d_eff by at most r, so a stage-h
    dictionary of ``oversample × r × d̂_eff(λ_{h-1})`` rows stays
    leverage-accurate at λ_h;
  * each stage is the paper's §3.5 score pass with the sampling
    distribution swapped, so it is ``fast_ridge_leverage`` through the
    configured ``KernelOps`` executor (K1 and K2 under ``hopper``).

Total cost Σ_h O(n·q_h²) ≈ O(n·q_H²·log n) with q_H ≈ oversample·d_eff.

The distribution each stage samples from is the deficit-corrected
overestimate (``bless_overestimate``): l̃ only sees in-span mass, so a row
orthogonal to the current dictionary would never be drawn again; the
Nyström residual d_i = K_ii − ‖B_i‖² bounds the unseen leverage through
d_i/(d_i + nλ).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import torch
from torch import Tensor

from .kernels import Kernel
from .leverage import fast_ridge_leverage
from .precision import to_dtype
from .recursive_rls import row_norms_sq

# auto-schedule cap: past ~20 halvings the early stages cost nothing and
# add nothing (d_eff is still ~1); an explicit ``stages`` overrides it
MAX_AUTO_STAGES = 20


class BlessStage(NamedTuple):
    """One annealing stage: the λ it scored at, the dictionary size it
    scored against, and the d_eff estimate it produced."""

    lam: float
    dict_size: int
    d_eff_estimate: float


class BlessResult(NamedTuple):
    """The final stage's scores (ridge-leverage estimates at λ_target), the
    dictionary they were computed against, the ‖B_i‖² rows, and the
    per-stage trace."""

    scores: Tensor         # l̃_i at λ_target, shape (n,)
    dictionary: Tensor     # final-stage dictionary indices, shape (q_H,)
    row_sq: Tensor         # ‖B_i‖² rows of the final-stage factor, (n,)
    stages: list[BlessStage]


def bless_lambda_schedule(lam_max: float, lam: float,
                          stages: int | None = None) -> list[float]:
    """The geometric annealing grid (λ_1, …, λ_H] with λ_H = ``lam``.

    ``lam_max`` itself is not a stage. ``stages=None`` picks
    H = ⌈log₂(λ_max/λ)⌉ (clamped to [1, 20]), a halving schedule; an
    explicit ``stages`` spreads the same ratio over that many geometric
    steps. When ``lam ≥ lam_max`` the schedule is the target stage alone.
    """
    lam = float(lam)
    if stages is not None and stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")
    if lam >= lam_max:
        return [lam]
    if stages is None:
        stages = min(MAX_AUTO_STAGES,
                     max(1, math.ceil(math.log2(lam_max / lam))))
    if stages == 1:
        return [lam]
    # λ_h = λ_max · ρ^h with ρ chosen so λ_H = lam exactly
    rho = (lam / lam_max) ** (1.0 / stages)
    grid = [lam_max * rho ** h for h in range(1, stages)]
    return grid + [lam]


def _dict_floor(n: int) -> int:
    """The union-bound dictionary floor ⌈log₂ n⌉."""
    return max(2, math.ceil(math.log2(max(n, 2))))


def bless_dict_size(d_eff: float, ratio: float, oversample: float,
                    n: int, q_max: int,
                    d_eff_cap: float | None = None) -> int:
    """Dictionary size for the next stage: ``oversample`` × the predicted
    post-anneal effective dimension d_eff·ratio (d_eff(λ/r) ≤ r·d_eff(λ)),
    clipped from above by ``d_eff_cap`` (the analytic λ_max/λ ≥ d_eff(λ)),
    floored at ⌈log₂ n⌉ and capped at ``q_max`` and n."""
    want_d = max(d_eff * ratio, 1.0)
    if d_eff_cap is not None:
        want_d = min(want_d, max(d_eff_cap, 1.0))
    want = math.ceil(oversample * want_d)
    return int(min(max(want, _dict_floor(n)), q_max, n))


def bless_trim_schedule(grid: list[float], lam_max: float, n: int,
                        oversample: float) -> list[float]:
    """Drop the leading stages the floor already certifies: a stage with
    oversample·(λ_max/λ_h) ≤ ⌈log₂ n⌉ would draw a floor-sized dictionary
    that already oversamples the analytic d_eff(λ_h) bound. The target
    stage is never dropped."""
    floor = _dict_floor(n)
    keep = [lam_h for lam_h in grid[:-1]
            if oversample * (lam_max / lam_h) > floor]
    return keep + [grid[-1]]


def bless_grid(lam_max: float, lam: float, n: int, stages: int | None,
               oversample: float, n_injected: int | None = None
               ) -> list[float]:
    """The λ grid a BLESS pass runs: ``bless_lambda_schedule``, trimmed by
    ``bless_trim_schedule`` when the stage count is automatic (an explicit
    ``stages`` is honored verbatim). ``n_injected`` is the number of
    injected dictionaries, which must match the grid."""
    grid = bless_lambda_schedule(lam_max, lam, stages)
    if stages is None:
        grid = bless_trim_schedule(grid, lam_max, n, oversample)
    if n_injected is not None and n_injected != len(grid):
        raise ValueError(f"{n_injected} dictionaries given for a schedule "
                         f"of {len(grid)} stages")
    return grid


def injected_dictionary(dictionaries, h: int, lam_h: float, q_h: int):
    """Stage h's injected dictionary, or None when none was injected; it
    must hold the q_h rows this pass sizes the stage at (a silent mismatch
    would hide a schedule fault)."""
    if dictionaries is None:
        return None
    idx = dictionaries[h]
    if len(idx) != q_h:
        raise ValueError(f"stage {h} (λ = {lam_h:.3e}): the injected "
                         f"dictionary holds {len(idx)} rows but the schedule "
                         f"sizes it at {q_h}")
    return idx


def widen_bless_accum(ops, dtype):
    """The executor with its block reductions widened to the solve dtype.

    BLESS dictionaries are near-degenerate by construction (the annealer
    concentrates them on the highest-leverage rows), so a stage's Gram
    accumulated in the storage dtype turns indefinite. Widening only the
    reductions fixes it while the O(n·q) blocks keep their storage dtype.
    No-op when the policy solves at the data dtype (float64 data) or
    already accumulates at solve width."""
    wide = ops.precision.solve_for(dtype)
    if wide is None:
        return ops
    acc = ops.precision.accum_for(dtype)
    if acc is not None and torch.finfo(acc).eps <= torch.finfo(wide).eps:
        return ops
    return dataclasses.replace(ops, precision=dataclasses.replace(
        ops.precision, accum_dtype=str(to_dtype(wide)).removeprefix(
            "torch.")))


def bless_overestimate(scores: Tensor, diag: Tensor, row_sq: Tensor,
                       n: int, lam: float) -> Tensor:
    """Sampling overestimate for the next draw: l̃ + d/(d + nλ) with the
    Nyström deficit d_i = max(K_ii − ‖B_i‖², 0)."""
    deficit = torch.clamp_min(diag - row_sq, 0.0)
    return scores + deficit / (deficit + n * lam)


def bless_leverage(
    kernel: Kernel,
    X: Tensor,
    lam: float,
    gen: torch.Generator | None = None,
    *,
    stages: int | None = None,
    oversample: float = 2.0,
    q_max: int | None = None,
    jitter: float = 1e-10,
    ops=None,
    dictionaries: Sequence[Tensor] | None = None,
) -> BlessResult:
    """The in-memory BLESS pass: annealed ``fast_ridge_leverage`` stages.

    Each stage draws a ``bless_dict_size`` dictionary without replacement
    (a set: duplicates make W singular) from ``gen`` — or takes it from
    ``dictionaries`` (one index tensor per stage, for injecting another
    implementation's draws; each must hold the q_h this pass computes for
    its stage) — and scores every row at λ_h through ``ops`` with the
    reductions widened (``widen_bless_accum``). Returns the final stage's
    scores: ridge-leverage estimates at ``lam``.
    """
    if ops is None:
        from .backends import ops_for
        ops = ops_for(kernel, device=X.device)
    ops = widen_bless_accum(ops, X.dtype)
    n = X.shape[0]
    diag = kernel.diag(X)
    trace = float(torch.sum(diag))
    lam_max = trace / n                      # nλ_max = Tr(K) ⇒ d_eff ≤ 1
    grid = bless_grid(lam_max, lam, n, stages, oversample,
                      None if dictionaries is None else len(dictionaries))
    q_cap = n if q_max is None else min(int(q_max), n)
    probs = diag / trace                     # Theorem-4 seed distribution
    d_eff, prev_lam, q_prev = 1.0, lam_max, 0
    trace_out: list[BlessStage] = []
    res = row_sq = None
    for h, lam_h in enumerate(grid):
        # max(·, q_prev): dictionaries never shrink as λ anneals down
        q_h = max(bless_dict_size(d_eff, max(prev_lam / lam_h, 1.0),
                                  oversample, n, q_cap,
                                  d_eff_cap=lam_max / lam_h), q_prev)
        q_prev = q_h
        res = fast_ridge_leverage(
            kernel, X, lam_h, q_h, gen, probs=probs, jitter=jitter,
            replace=False, ops=ops,
            idx=injected_dictionary(dictionaries, h, lam_h, q_h))
        row_sq = row_norms_sq(res)
        over = bless_overestimate(res.scores, diag, row_sq, n, lam_h)
        probs = over / torch.sum(over)
        # the next dictionary is sized from Σ(over) ≥ d_eff, not Σl̃: the
        # in-span estimate lags exactly when the dictionary is too small
        d_eff, prev_lam = float(torch.sum(over)), lam_h
        trace_out.append(BlessStage(float(lam_h), q_h,
                                    float(res.d_eff_estimate)))
    return BlessResult(res.scores, res.landmarks, row_sq, trace_out)
