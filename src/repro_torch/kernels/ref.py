"""Plain PyTorch versions of the hand-written kernels.

They repeat each kernel's arithmetic with ordinary tensor ops, run on any
device, and are what the kernel wrappers use for CPU tensors and what the
kernels are held against on the card.
"""
from __future__ import annotations

import torch
from torch import Tensor


def rbf_block_ref(X: Tensor, Z: Tensor, bandwidth: float = 1.0) -> Tensor:
    """C_ij = exp(-‖x_i − z_j‖² / (2 h²))."""
    xx = torch.sum(X * X, dim=-1)[:, None]
    zz = torch.sum(Z * Z, dim=-1)[None, :]
    d2 = torch.clamp_min(xx + zz - 2.0 * (X @ Z.T), 0.0)
    return torch.exp(-d2 / (2.0 * bandwidth**2))


def linear_block_ref(X: Tensor, Z: Tensor) -> Tensor:
    return X @ Z.T


def poly_block_ref(X: Tensor, Z: Tensor, degree: int = 2, scale: float = 1.0,
                   offset: float = 1.0) -> Tensor:
    """C_ij = (x_i·z_j / scale + offset)^degree."""
    return (X @ Z.T / scale + offset) ** degree


def rls_scores_ref(B: Tensor, M: Tensor) -> Tensor:
    """l̃_i = B_i M B_iᵀ rowwise."""
    return torch.sum((B @ M) * B, dim=-1)
