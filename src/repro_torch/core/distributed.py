"""FALKON-style preconditioned CG in landmark space (``SOLVERS["falkon_pcg"]``).

PCG on the p-dimensional normal equations of the footnote-4 sketch,

    (CsᵀCs + nλ·A) β = Csᵀy,     A = ½(Ws + Wsᵀ) + nγI,

the system ``nystrom_regularized`` factors directly (so the two are
comparable), preconditioned by the weighted landmark overlap
M = Ws² + nλA. The iterate is p-sized; :func:`falkon_pcg_krr` applies the
operator through the configured ``KernelOps`` executor (``gram_matvec``:
K1 on the card under ``hopper``, tile by tile under ``streaming``), and its
chunked twin :func:`falkon_pcg_from_stats` iterates on one-pass O(p²)
statistics, so no O(n·p) state exists at any n.

This is the landmark-space part of the reference's
``repro.core.distributed``. Its sharded part (the ``shard_map`` leverage
pass, the Woodbury solve over a device mesh and the exact-K n-space PCG)
is ROADMAP item 9.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import Tensor

from .backends import KernelOps, jittered_cholesky
from .eigenpro import landmark_solve_dtypes, regularized_penalty
from .precision import storage_floored_jitter


class LandmarkPCG(NamedTuple):
    """Result of the landmark-space FALKON solve."""

    beta: Tensor        # (p,) / (p, k) landmark dual, in the solve dtype
    iters: int          # PCG iterations actually run (early stop counts)
    residuals: Tensor   # (iters,) relative residual ‖r‖/‖b‖ per iteration


def pcg_solve(matvec: Callable, b: Tensor, msolve: Callable | None = None,
              *, tol: float = 1e-6, max_iters: int = 100
              ) -> tuple[Tensor, int, Tensor]:
    """Preconditioned conjugate gradients on an SPD operator.

    ``matvec`` is any linear map v ↦ Hv (kernel passes through an
    executor, accumulated p×p statistics, …) and ``msolve`` a
    preconditioner r ↦ M⁻¹r (None: plain CG). Multi-output right-hand
    sides (p, k) share each matvec, with per-column step sizes. The loop
    stops when the max-over-columns ‖r‖/‖b‖ is at most ``tol`` (one host
    read a step); denominators are floored at the dtype's ``tiny``, so a
    converged or zero system never divides by 0.

    Returns ``(x, iters, residual_history)``.
    """
    if msolve is None:
        def msolve(r):
            return r

    def coldot(u, v):
        return torch.sum(u * v, dim=0)

    tiny = torch.finfo(b.dtype).tiny
    bfloor = torch.clamp_min(torch.sqrt(coldot(b, b)), tiny)
    x = torch.zeros_like(b)
    r = b
    pvec = msolve(r)
    rz = coldot(r, pvec)
    rel = float(torch.max(torch.sqrt(coldot(r, r)) / bfloor))
    history: list[float] = []
    while len(history) < max_iters and rel > tol:
        Hp = matvec(pvec)
        a = rz / torch.clamp_min(coldot(pvec, Hp), tiny)
        x = x + a * pvec
        r = r - a * Hp
        z = msolve(r)
        rz_new = coldot(r, z)
        pvec = z + (rz_new / torch.clamp_min(rz, tiny)) * pvec
        rz = rz_new
        rel = float(torch.max(torch.sqrt(coldot(r, r)) / bfloor))
        history.append(rel)
    return x, len(history), torch.tensor(history, dtype=torch.float32)


def nystrom_pcg_preconditioner(W: Tensor, weights: Tensor, n: int,
                               lam: float, gamma: float,
                               jitter: float) -> Callable:
    """r ↦ M⁻¹r for M = Ws·Ws + nλ·A, the FALKON preconditioner.

    With sketch weights w_j² = 1/(p·q_j) (``draw_columns``), Ws² is the
    importance-corrected estimate of CsᵀCs under any sampling
    distribution, so M ≈ H = CsᵀCs + nλA and the PCG spectrum clusters at
    1. M is SPD (A ⪰ nγI), factored once by the shared jittered Cholesky;
    each application is two p×p triangular solves.
    """
    Ws = (W * weights[None, :]) * weights[:, None]
    A = regularized_penalty(W, weights, n, gamma)
    M = Ws @ Ws + (n * lam) * A
    L = jittered_cholesky(M, jitter)

    def msolve(r):
        col = r if r.ndim == 2 else r[:, None]
        z = torch.linalg.solve_triangular(L, col, upper=False)
        z = torch.linalg.solve_triangular(L.T, z, upper=True)
        return z if r.ndim == 2 else z[:, 0]

    return msolve


def falkon_pcg_krr(ops: KernelOps, X: Tensor, y: Tensor, Z: Tensor,
                   weights: Tensor, lam: float, gamma: float, *,
                   tol: float = 1e-6, max_iters: int = 100,
                   jitter: float = 1e-10,
                   precondition: bool = True) -> LandmarkPCG:
    """FALKON: Nyström-preconditioned CG on the sketch's landmark-space
    normal equations.

    Solves (CsᵀCs + nλA)β = Csᵀy without forming Cs: the operator is
    Hv = w ∘ gram_matvec(X, Z, w ∘ v) + nλ·Av, each ``gram_matvec`` one
    pass of kernel blocks through the configured executor. Live state is
    O(p) plus one kernel block (one tile under ``streaming``). The
    preconditioner is :func:`nystrom_pcg_preconditioner`;
    ``precondition=False`` gives plain CG, for the iterations-to-tolerance
    comparison. Dtypes follow the ``Precision`` policy through
    ``landmark_solve_dtypes``.
    """
    n = X.shape[0]
    _, sd = landmark_solve_dtypes(ops, Z.dtype)
    W = ops.cross(Z, Z).to(sd)
    wgt = weights.to(sd)
    A = regularized_penalty(W, wgt, n, gamma)
    nlam = n * lam
    ry = ops.rmatvec(X, Z, y)
    wcol = wgt.reshape((-1,) + (1,) * (ry.ndim - 1))
    b = wcol * ry.to(sd)

    def matvec(v):
        kv = ops.gram_matvec(X, Z, wcol * v)
        return wcol * kv.to(sd) + nlam * (A @ v)

    msolve = None
    if precondition:
        msolve = nystrom_pcg_preconditioner(
            W, wgt, n, lam, gamma, storage_floored_jitter(jitter, Z.dtype))
    beta, iters, res = pcg_solve(matvec, b, msolve, tol=tol,
                                 max_iters=max_iters)
    return LandmarkPCG(beta, iters, res)


def falkon_pcg_from_stats(W: Tensor, weights: Tensor, Gc: Tensor,
                          bc: Tensor, n: int, gamma: float, lam: float, *,
                          tol: float = 1e-6, max_iters: int = 100,
                          jitter: float = 1e-10,
                          precondition: bool = True) -> LandmarkPCG:
    """The chunked twin of :func:`falkon_pcg_krr`, on one-pass statistics.

    ``Gc`` = CsᵀCs and ``bc`` = Csᵀy come from the out-of-core accumulator
    (the weighted-column convention of
    ``nystrom_regularized_beta_from_stats``), so the operator is the dense
    p×p map v ↦ ½(Gc + Gcᵀ)v + nλ·Av: the data streams once whatever the
    iteration count. All inputs are in the caller's solve dtype.
    """
    A = regularized_penalty(W, weights, n, gamma)
    nlam = n * lam
    Gs = 0.5 * (Gc + Gc.T)

    def matvec(v):
        return Gs @ v + nlam * (A @ v)

    msolve = None
    if precondition:
        msolve = nystrom_pcg_preconditioner(W, weights, n, lam, gamma,
                                            jitter)
    beta, iters, res = pcg_solve(matvec, bc, msolve, tol=tol,
                                 max_iters=max_iters)
    return LandmarkPCG(beta, iters, res)
