"""EigenPro-style preconditioned mini-batch SGD in landmark coordinates.

The sketched KRR fit of the regularized Nyström solver is, written out in
landmark space, one p-dimensional SPD linear system

    (CsᵀCs + nλ·A) β = Csᵀy,      A = ½(Ws + Wsᵀ) + nγI,

with Cs = C·diag(w) the weighted column sketch and Ws = diag(w)·W·diag(w)
the weighted landmark overlap (the system
``core.nystrom.nystrom_regularized_beta_from_stats`` solves in closed
form). Dividing by n, SGD on the least-squares objective

    F(β) = (1/2n)‖Cs β − y‖² + (λ/2)·βᵀAβ

has the direct solver's β as its unique fixed point, which makes the
iterative fit comparable with the O(p³) factorization.

Plain SGD is throttled by the top of the covariance spectrum: the step
size must satisfy η < 2/λ₁, while direction j converges like (1 − ηλ_j).
EigenPro (Ma & Belkin) deflates the top-k eigendirections out of the
gradient,

    P = I − Q diag(1 − λ_{k+1}/λ_j) Qᵀ,

so every deflated direction behaves as if its eigenvalue were λ_{k+1} and
the step may grow by λ₁/λ_{k+1}. The eigenpairs come from a subsample
estimate of the p×p landmark-space covariance

    M̂ = (1/s)·Cs_subᵀCs_sub + λ·A

(s = ``SketchConfig.precond_subsample`` rows), the step size from that
spectrum by the batch-adjusted EigenPro rule (on the preconditioned
per-sample norms, :func:`build_preconditioner`), and the mini-batch rows
from a device-memory budget (``SketchConfig.batch_budget_mb``).

Constant-step SGD on a noisy objective converges to a noise ball, not to
β, so a fit runs two phases over the same batches: SGD epochs (one update
per mini-batch) and then polish epochs, which sum the exact full gradient
over the epoch's batches and take one deflated-GD step; that iteration
contracts geometrically to the direct solver's β. A single-batch fit
(batch ≥ n) is polish from its first epoch.

Every kernel block comes from the configured ``KernelOps`` executor
(``ops.cross`` per mini-batch: K1 on the card under ``hopper``), so a step
holds O(batch_rows·p) whatever n is. The reference jits a ``lax.scan``
over zero-padded, masked batches; here the batches are plain slices of a
chunk's valid rows in a Python loop, so nothing is padded and nothing
needs a mask. ``SOLVERS["eigenpro"]`` (``repro_torch.api.solvers``) wraps
:func:`eigenpro_fit` for in-memory fits and the ``make_chunk_*`` functions
for the multi-epoch out-of-core protocol.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import Tensor

from .backends import KernelOps
from .precision import storage_floored_jitter, to_dtype


# -------------------------------------------------------- shared plumbing

def landmark_solve_dtypes(ops: KernelOps, dtype) -> tuple:
    """(accum, iterate) dtypes of the iterative landmark solvers.

    The chunked Nyström accumulator's rule: an explicitly requested
    ``solve_dtype`` wins; sub-f32 storage (bf16 / f16) widens to the
    policy's solve resolution (there is no sub-f32 eigh or Cholesky);
    otherwise the landmark dtype is kept, so an iterative solver never
    doubles the working precision of an f32 pipeline on its own.
    """
    acc, wide = ops.score_pass_dtypes(dtype)
    if ops.precision.solve_dtype is not None:
        sd = to_dtype(ops.precision.solve_dtype)
    elif dtype.itemsize < 4:
        sd = wide
    else:
        sd = dtype
    return acc, sd


def regularized_penalty(W: Tensor, weights: Tensor, n: int,
                        gamma: float) -> Tensor:
    """A = ½(Ws + Wsᵀ) + nγI — the footnote-4 ridge block of the
    landmark-space normal equations, symmetrized as the direct solver's
    ``nystrom_regularized_beta_from_stats`` does."""
    Ws = (W * weights[None, :]) * weights[:, None]
    p = Ws.shape[0]
    return 0.5 * (Ws + Ws.T) + n * gamma * torch.eye(
        p, dtype=W.dtype, device=W.device)


def auto_batch_rows(n: int, p: int, itemsize: int,
                    budget_mb: float) -> int:
    """Mini-batch rows from a device-memory budget.

    A step holds about 4 arrays of shape (m, p) at the block itemsize (the
    kernel block, its weighted copy, the residual's broadcast and the
    gradient's intermediates), so m = budget / (4·p·itemsize), clamped to
    [32, n].
    """
    m = int(budget_mb * 2**20) // max(1, 4 * p * itemsize)
    return max(1, min(n, max(32, m)))


# ----------------------------------------------------- the preconditioner

class EigenProPrecond(NamedTuple):
    """Top-k deflation preconditioner P = I − Q diag(damp) Qᵀ plus the
    spectral quantities the step-size rule needs."""

    Q: Tensor      # (p, k) top eigenvectors of the estimated covariance
    damp: Tensor   # (k,) deflation weights 1 − λ_{k+1}/λ_j
    tail: Tensor   # λ_{k+1} — the post-deflation spectral top
    bound: Tensor  # β_P = max_i cs_iᵀ P cs_i, preconditioned per-sample norm
    k: int


def step_size(precond: EigenProPrecond, m: int) -> Tensor:
    """EigenPro batch step rule η(m) = 0.99·m / (β_P + (m−1)·λ_{k+1}).

    Stable for any batch size: the per-sample term β_P dominates at small
    m, and η → 0.99/λ_{k+1} as m grows, the full-batch deflated-GD step
    the polish phase takes with m = n.
    """
    return 0.99 * m / (torch.maximum(precond.bound, precond.tail)
                       + (m - 1) * precond.tail)


def build_preconditioner(ops: KernelOps, X_sub: Tensor, Z: Tensor,
                         weights: Tensor, A: Tensor, lam: float, k: int,
                         solve_dtype) -> EigenProPrecond:
    """Estimate the covariance from ``s`` subsampled rows and derive
    (Q, damp, λ_{k+1}, β_P).

    M̂ = (1/s)·Cs_subᵀCs_sub + λ·A is the p×p landmark-space Hessian/n
    estimate (exact at s = n); its top-k eigenpairs give the deflation.
    Two guards:

    * β_P = max_i cs_iᵀ P cs_i is the preconditioned per-sample norm. The
      raw ‖cs_i‖² (about n for sketch-weighted columns) would cap
      η·λ_{k+1} near m/n, and the deflated directions, whose curvature is
      λ_{k+1}, would never move. The λAβ term needs no margin of its own:
      λA is inside M̂'s deflated spectrum.
    * λ_{k+1} is floored at 4·eps·λ₁: eigh's eigenvector error is
      O(eps·λ₁), so a smaller tail is noise, and stepping at 1/tail
      diverges (seen in f32 at tiny γ).
    """
    s = X_sub.shape[0]
    Cs = (ops.cross(X_sub, Z) * weights[None, :]).to(solve_dtype)
    M = Cs.T @ Cs / s + lam * A
    p = M.shape[0]
    k = max(1, min(k, p - 1))
    eigs, vecs = torch.linalg.eigh(0.5 * (M + M.T))   # ascending
    top = eigs[p - k:]
    tail = torch.maximum(eigs[p - k - 1],
                         4.0 * torch.finfo(solve_dtype).eps * eigs[-1])
    Q = vecs[:, p - k:]
    damp = 1.0 - tail / torch.maximum(top, tail)
    CQ = Cs @ Q
    row_p = torch.sum(Cs * Cs, dim=1) - (CQ * CQ) @ damp
    return EigenProPrecond(Q, damp, tail, torch.max(row_p), k)


# -------------------------------------------------------- the iteration

def _deflate(g: Tensor, Q: Tensor, damp: Tensor) -> Tensor:
    """P g = g − Q diag(damp) Qᵀ g, for (p,) or (p, k) gradients."""
    qg = Q.T @ g
    return g - Q @ (qg * damp.reshape((-1,) + (1,) * (qg.ndim - 1)))


def _batches(xb: Tensor, yb: Tensor, n_valid: int, m: int):
    """(x, y) mini-batches of m rows over the chunk's valid rows; the last
    one may be shorter."""
    for s in range(0, int(n_valid), m):
        e = min(s + m, int(n_valid))
        yield xb[s:e], yb[s:e]


def _batch_rows(chunk_rows: int, batch_rows: int) -> int:
    """Rows of one mini-batch of a chunk (never more than the chunk)."""
    return max(1, min(batch_rows, chunk_rows))


def make_chunk_step(ops: KernelOps, Z: Tensor, weights: Tensor, A: Tensor,
                    lam: float, precond: EigenProPrecond, chunk_rows: int,
                    batch_rows: int, solve_dtype) -> Callable:
    """``(β, X_chunk, y_chunk, n_valid) → β``: one preconditioned-SGD
    update per mini-batch of one chunk of ``chunk_rows`` rows.

    The batches cover the valid rows only, so a padded tail never enters
    a residual or a batch's normalization, and a chunk with no valid rows
    leaves β as it is. A step holds O(batch_rows·p). The in-memory driver
    uses it with chunk_rows = n. The step size is that of the batch size
    ``min(batch_rows, chunk_rows)``.
    """
    m = _batch_rows(chunk_rows, batch_rows)
    Q, damp = precond.Q, precond.damp
    eta = step_size(precond, m)
    wrow = weights[None, :]

    def step(beta, xb, yb, n_valid):
        for xm, ym in _batches(xb, yb, n_valid, m):
            Csb = (ops.cross(xm, Z) * wrow).to(solve_dtype)
            r = Csb @ beta - ym.to(solve_dtype)
            g = Csb.T @ r / xm.shape[0] + lam * (A @ beta)
            beta = beta - eta * _deflate(g, Q, damp)
        return beta

    return step


def make_chunk_grad(ops: KernelOps, Z: Tensor, weights: Tensor,
                    chunk_rows: int, batch_rows: int,
                    solve_dtype) -> Callable:
    """``(β, X_chunk, y_chunk, n_valid) → Σ_i cs_i(cs_iᵀβ − y_i)``: the
    chunk's unnormalized data-term gradient for the polish phase, in
    ``batch_rows`` tiles so a step holds O(batch_rows·p). The driver sums
    the chunks, divides by n and adds λAβ for the exact full gradient."""
    m = _batch_rows(chunk_rows, batch_rows)
    wrow = weights[None, :]

    def grad(beta, xb, yb, n_valid):
        acc = torch.zeros(beta.shape, dtype=solve_dtype, device=beta.device)
        for xm, ym in _batches(xb, yb, n_valid, m):
            Csb = (ops.cross(xm, Z) * wrow).to(solve_dtype)
            acc = acc + Csb.T @ (Csb @ beta - ym.to(solve_dtype))
        return acc

    return grad


def make_polish_step(A: Tensor, lam: float, precond: EigenProPrecond,
                     n: int) -> Callable:
    """``(β, Σ_chunks grad) → β``: one full-gradient deflated-GD step at
    the m = n step size, the deterministic contraction that carries the
    fit from the SGD noise ball to the direct solver's β."""
    Q, damp = precond.Q, precond.damp
    eta = step_size(precond, n)

    def polish(beta, gsum):
        g = gsum / n + lam * (A @ beta)
        return beta - eta * _deflate(g, Q, damp)

    return polish


# --------------------------------------------------- the in-memory driver

class EigenProResult(NamedTuple):
    beta: Tensor      # (p,) / (p, k) landmark dual at the last epoch
    epochs: int       # epochs actually run (early stop counts)
    deltas: Tensor    # per-epoch relative update ‖Δβ‖/‖β‖


def sgd_epoch_budget(epochs: int, batch_rows: int, n: int) -> int:
    """Epochs of the mini-batch SGD phase (the rest polish).

    A single-batch fit (batch ≥ n) has no gradient noise, so SGD and polish
    coincide and every epoch polishes; otherwise half the budget is SGD,
    first, for cheap early progress.
    """
    return 0 if batch_rows >= n else epochs // 2


def rel_delta(old: Tensor, new: Tensor) -> float:
    """‖new − old‖/‖new‖, with 0/0 → 0 (one host read of two norms)."""
    num = float(torch.linalg.norm(new - old))
    den = float(torch.linalg.norm(new))
    return num / den if den > 0 else (0.0 if num == 0.0 else float("inf"))


def penalty_block(ops: KernelOps, Z: Tensor, weights: Tensor, n: int,
                  gamma: float, jitter: float, solve_dtype) -> Tensor:
    """A of the landmark-space system, plus the jitter floored at Z's
    storage dtype (relative to tr(A)/p), in ``solve_dtype``."""
    p = Z.shape[0]
    A = regularized_penalty(ops.cross(Z, Z).to(solve_dtype),
                            weights.to(solve_dtype), n, gamma)
    return A + storage_floored_jitter(jitter, Z.dtype) * (
        torch.trace(A) / p) * torch.eye(p, dtype=solve_dtype,
                                        device=Z.device)


def eigenpro_fit(ops: KernelOps, X: Tensor, y: Tensor, Z: Tensor,
                 weights: Tensor, lam: float, gamma: float,
                 gen: torch.Generator, *, epochs: int, tol: float,
                 precond_k: int | None, subsample: int | None,
                 budget_mb: float, jitter: float) -> EigenProResult:
    """In-memory EigenPro fit of the landmark-space system (module
    docstring). The preconditioner's row subsample is drawn without
    replacement from the CPU generator ``gen``; the batch order is the row
    order, so a fit is a pure function of (inputs, generator state).
    Stops early when a polish epoch moves β by less than ``tol``,
    relatively (SGD epochs never stop early: their deltas measure gradient
    noise, not convergence).
    """
    n, p = X.shape[0], Z.shape[0]
    _, sd = landmark_solve_dtypes(ops, Z.dtype)
    A = penalty_block(ops, Z, weights, n, gamma, jitter, sd)
    s = min(n, subsample if subsample is not None else min(n, 4000))
    idx = torch.randperm(n, generator=gen)[:s].to(X.device)
    k = precond_k if precond_k is not None else min(p - 1, 64)
    precond = build_preconditioner(ops, X[idx], Z, weights, A, lam, k, sd)
    m = auto_batch_rows(n, p, Z.dtype.itemsize, budget_mb)
    sgd_epochs = sgd_epoch_budget(epochs, m, n)
    step = make_chunk_step(ops, Z, weights, A, lam, precond,
                           chunk_rows=n, batch_rows=m, solve_dtype=sd)
    grad = make_chunk_grad(ops, Z, weights, chunk_rows=n, batch_rows=m,
                           solve_dtype=sd)
    polish = make_polish_step(A, lam, precond, n)
    beta = torch.zeros((p,) + tuple(y.shape[1:]), dtype=sd, device=Z.device)
    deltas = []
    for e in range(epochs):
        if e < sgd_epochs:
            new = step(beta, X, y, n)
        else:
            new = polish(beta, grad(beta, X, y, n))
        rel = rel_delta(beta, new)
        beta = new
        deltas.append(rel)
        if e >= sgd_epochs and rel <= tol:
            break
    return EigenProResult(beta, len(deltas),
                          torch.tensor(deltas, dtype=torch.float32))
