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


def sparse_cross_ref(data: Tensor, indices: Tensor, indptr: Tensor,
                     Z: Tensor) -> Tensor:
    """X_csr·Zᵀ → (n_rows, p) in Z's dtype, over nnz tiles of
    ``sparse_tile(nnz, n_rows)``: per tile, the Zᵀ rows of the tile's
    column ids times its values, added into an (n_rows + 1, p) buffer
    whose last row takes the padding slots and is sliced off."""
    from .sparse_block import sparse_row_ids, sparse_tile
    n_rows, nnz = indptr.shape[0] - 1, data.shape[0]
    rows = sparse_row_ids(indptr, nnz).long()
    tile = sparse_tile(nnz, n_rows)
    Zt = Z.T.contiguous()
    out = torch.zeros((n_rows + 1, Z.shape[0]), dtype=Z.dtype,
                      device=Z.device)
    for lo in range(0, nnz, tile):
        sl = slice(lo, lo + tile)
        part = Zt.index_select(0, indices[sl].long()) * data[sl, None].to(Z.dtype)
        out.index_add_(0, rows[sl], part)
    return out[:n_rows]


def sparse_kernel_block_ref(data: Tensor, indices: Tensor, indptr: Tensor,
                            Z: Tensor, *, kind: str = "rbf",
                            bandwidth: float = 1.0, degree: int = 2,
                            scale: float = 1.0, offset: float = 1.0,
                            acc_dtype=None) -> Tensor:
    """k(X_csr, Z) for ``kind`` ∈ {rbf, linear, poly}, unfused: the cross
    product in ``acc_dtype`` (default: the result dtype) rounded to the
    result dtype, then the epilogue — the reference's
    ``sparse_kernel_block``. Padded rows (no stored values) give k(0, z)."""
    from .sparse_block import sparse_row_sqnorms
    out_dtype = torch.promote_types(data.dtype, Z.dtype)
    acc = out_dtype if acc_dtype is None else acc_dtype
    if kind not in ("rbf", "linear", "poly"):
        raise ValueError(f"unknown sparse kernel kind: {kind!r}")
    cross = sparse_cross_ref(data.to(acc), indices, indptr,
                             Z.to(acc)).to(out_dtype)
    if kind == "linear":
        return cross
    if kind == "poly":
        return ((cross.to(acc) / scale + offset) ** degree).to(out_dtype)
    row_sq = sparse_row_sqnorms(data, indptr, acc_dtype=acc).to(acc)
    zc = Z.to(acc)
    zz = torch.sum(zc * zc, dim=1)
    d2 = torch.clamp_min(row_sq[:, None] + zz[None, :]
                         - 2.0 * cross.to(acc), 0.0)
    return torch.exp(-d2 / (2.0 * bandwidth * bandwidth)).to(out_dtype)
