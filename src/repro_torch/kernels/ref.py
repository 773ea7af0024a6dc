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


def attention_mask(q_pos: Tensor, k_pos: Tensor, causal: bool,
                   window: int) -> Tensor:
    """(len(q_pos), len(k_pos)) visibility: causal (q ≥ k) and the sliding
    window (q − k < window) when ``window > 0``."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                  scale: float | None = None, causal: bool = True,
                  window: int = 0) -> Tensor:
    """Exact (GQA-aware) softmax attention, the reference's ``attention_ref``
    arithmetic: logits in the input dtype, then float32 and scaled; masked
    logits are −inf. q: (B, Hq, S, D), k/v: (B, Hkv, S, D)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    s = scale if scale is not None else 1.0 / (D**0.5)
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * s
    pos = torch.arange(S, device=q.device)
    logits = logits.masked_fill(~attention_mask(pos, pos, causal, window),
                                float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)


# query rows per step of ``flash_attention_ref``: bounds its float32 logits
# at (B, Hq, 1024, S), 0.8 GB at the LM cell's prefill (24 heads, S = 8192)
REF_ROWS = 1024


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float = 0.0) -> Tensor:
    """K4's plain version, in the Pallas kernel's own arithmetic: q, k and v
    upcast to float32, q scaled before the product (``scale = 0`` ⇒ 1/√D),
    masked logits set to −1e30 and their weights to 0, the normaliser
    floored at 1e-30, the result cast to q's dtype. GQA: query head h reads
    KV head h // (Hq / Hkv). Exact softmax over all keys, ``REF_ROWS``
    query rows at a time (the kernel's online softmax gives the same function);
    q: (B, Hq, S, D), k/v: (B, Hkv, S, D)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    s = scale or 1.0 / (D**0.5)
    qf = q.float().reshape(B, Hkv, g, S, D) * s
    kt = k.float().transpose(-1, -2)                     # (B, Hkv, D, S)
    vf = v.float()
    out = torch.empty((B, Hkv, g, S, D), dtype=q.dtype, device=q.device)
    k_pos = torch.arange(S, device=q.device)
    for lo in range(0, S, REF_ROWS):
        hi = min(lo + REF_ROWS, S)
        c = hi - lo
        logits = torch.matmul(qf[:, :, :, lo:hi].reshape(B, Hkv, g * c, D),
                              kt).reshape(B, Hkv, g, c, S)
        mask = attention_mask(k_pos[lo:hi], k_pos, causal, window)
        logits = logits.masked_fill(~mask, -1e30)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m).masked_fill(~mask, 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.reshape(B, Hkv, g * c, S), vf).reshape(
            B, Hkv, g, c, D)
        out[:, :, :, lo:hi] = (o / l.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(B, Hq, S, D)
