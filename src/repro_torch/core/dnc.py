"""Divide-and-conquer KRR baseline (Zhang, Duchi & Wainwright [7]).

The paper's §1 comparison target: split the n points into m random
partitions, solve KRR on each (kernel evaluations m·(n/m)² = n²/m), and
average the m estimators. With m ≈ n/d_eff² this costs O(n·d_eff²) kernel
evaluations against O(n·d_eff) for the leverage-sampled Nyström sketch.

Prediction at any point x: f̂(x) = (1/m) Σ_j k(x, X_j) α_j.

Every block comes from a ``KernelOps`` executor (K1 under ``hopper``), one
partition at a time: only one (n/m)² Gram is live at once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from .kernels import Kernel
from .krr import krr_fit


class DnCModel(NamedTuple):
    partitions: Tensor   # (m, n/m) indices into X
    alphas: Tensor       # (m, n/m) per-partition dual coefficients


def _ops(kernel: Kernel, X: Tensor, ops):
    if ops is None:
        from .backends import ops_for
        ops = ops_for(kernel, device=X.device)
    return ops


def dnc_fit(kernel: Kernel, X: Tensor, y: Tensor, lam: float, m: int,
            gen: torch.Generator | None = None, *,
            partitions: Tensor | None = None, ops=None) -> DnCModel:
    """m per-partition KRR fits: (K_j + (n/m)·λ I) α_j = y_j, each K_j from
    ``ops.cross`` and factored at the data dtype. The partitions are a
    random permutation of the rows drawn from ``gen`` — or ``partitions``
    ((m, n/m) indices, for injecting another implementation's draw)."""
    n = X.shape[0]
    if n % m != 0:
        raise ValueError(f"n={n} must be divisible by m={m}")
    size = n // m
    if partitions is None:
        partitions = torch.randperm(n, generator=gen).reshape(m, size)
    partitions = torch.as_tensor(partitions, device=X.device)
    if tuple(partitions.shape) != (m, size):
        raise ValueError(f"partitions must be ({m}, {size}), got "
                         f"{tuple(partitions.shape)}")
    ops = _ops(kernel, X, ops)
    alphas = []
    for idx in partitions:
        Xp = X[idx]
        # Zhang et al. regularize each sub-problem at λ w.r.t. its own size
        alphas.append(krr_fit(ops.cross(Xp, Xp), y[idx], lam))
    return DnCModel(partitions, torch.stack(alphas))


def dnc_predict(kernel: Kernel, X: Tensor, model: DnCModel,
                X_test: Tensor, *, ops=None) -> Tensor:
    """The mean over partitions of k(X_test, X_j) α_j."""
    ops = _ops(kernel, X, ops)
    total = None
    for idx, alpha in zip(model.partitions, model.alphas):
        pred = ops.matvec(X_test, X[idx], alpha)
        total = pred if total is None else total + pred
    return total / model.partitions.shape[0]


def dnc_predict_train(kernel: Kernel, X: Tensor, model: DnCModel, *,
                      ops=None) -> Tensor:
    return dnc_predict(kernel, X, model, X, ops=ops)


def dnc_kernel_evals(n: int, m: int) -> int:
    """m (n/m)² = n²/m kernel evaluations (fit only)."""
    return n * n // m
