"""K3 ``sparse_cross``: k(X_csr, Z) on the card through ``csrc/sparse_cross.cu``.

The Hopper counterpart of the Pallas kernel
``src/repro/kernels/sparse_block.py::_sparse_cross_pallas``. X is a CSR row
block (``data``/``indices`` over the stored values, ``indptr`` the row
pointer), Z a dense (p, d) landmark block. One launch computes the cross
product X·Zᵀ and, for kind rbf/poly, the kernel's epilogue in the same
store: ‖x_i‖² comes from the values the kernel already walks, ‖z‖² from a
short norm kernel over Z. See the note at the top of the CUDA source for
the design and its bound.

Also here, shared with the plain versions in ``ref`` and with
``data.sparse``: the nnz tile of the plain contraction (``sparse_tile``),
the row id of every stored slot (``sparse_row_ids``) and the row norms
(``sparse_row_sqnorms``).

Accumulation follows the reference: the result dtype
``promote(data, Z)`` unless ``acc_dtype`` overrides it. bf16 raises on the
card (ROADMAP item 14). This wrapper takes CUDA tensors only;
``repro_torch.kernels.ops.sparse_block`` sends CPU tensors to the plain
version.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from ..core.precision import to_dtype
from .rbf_block import DTYPE_CODES, KINDS, check_cuda, check_dtypes

# floor on the plain contraction's nnz tile: below it the loop's step count
# dominates; the (tile, p) gather it implies is a constant O(MIN_TILE·p)
MIN_TILE = 512
# bytes of one landmark slab row that a warp reads per stored value: the
# kernel's SLAB = 1024 / itemsize columns (256 float32, 128 float64), and
# the width the Zᵀ copy is padded to
SLAB_BYTES = 1024
_INT32_MAX = 2**31 - 1


def sparse_tile(nnz_cap: int, n_rows: int) -> int:
    """The nnz tile of the plain contraction for a CSR block with
    ``nnz_cap`` stored slots over ``n_rows`` rows: capped at
    ``max(n_rows, MIN_TILE)`` so the per-tile (tile, p) gather never
    exceeds O(n_rows·p) plus a constant."""
    return max(1, min(int(nnz_cap), max(int(n_rows), MIN_TILE)))


def sparse_row_ids(indptr: Tensor, nnz: int) -> Tensor:
    """Row id of every slot of the flat stored-value stream: slot k lives in
    row i iff indptr[i] ≤ k < indptr[i+1] (``right=True`` lands empty rows
    correctly). Slots at or past ``indptr[-1]`` — padding — map to
    ``n_rows``, a row that every consumer drops."""
    k = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return (torch.searchsorted(indptr, k, right=True) - 1).to(torch.int32)


def sparse_row_sqnorms(data: Tensor, indptr: Tensor, *,
                       acc_dtype=None) -> Tensor:
    """‖x_i‖² per row of a CSR block, accumulated in ``acc_dtype``
    (default: the data dtype) and returned in the data dtype."""
    n_rows = indptr.shape[0] - 1
    acc = data.dtype if acc_dtype is None else to_dtype(acc_dtype)
    rows = sparse_row_ids(indptr, data.shape[0]).long()
    sq = data.to(acc) * data.to(acc)
    out = torch.zeros(n_rows + 1, dtype=acc, device=data.device)
    out.index_add_(0, rows, sq)
    return out[:n_rows].to(data.dtype)


@functools.cache
def _entry():
    from . import _build
    lib = _build.library("sparse_cross")
    fn = lib.sparse_cross_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_double, ctypes.c_double,
                   ctypes.c_double, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.sparse_cross_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def sparse_cross(data: Tensor, indices: Tensor, indptr: Tensor, Z: Tensor, *,
                 kind: str = "linear", bandwidth: float = 1.0,
                 degree: int = 2, scale: float = 1.0, offset: float = 1.0,
                 acc_dtype=None) -> Tensor:
    """k(X_csr, Z) ∈ R^{n_rows×p} in one launch of K3 (CUDA tensors only).

    ``data`` (nnz,) and Z (p, d) are contiguous float32/float64 tensors of
    one dtype, ``indices`` (nnz,) and ``indptr`` (n_rows + 1,) contiguous
    int32, all on one CUDA device; column ids must lie in [0, d)
    (``CsrMatrix.validate``). Slots at or past ``indptr[-1]`` are never
    read. ``acc_dtype`` overrides the accumulation (default: the data
    dtype). Launches on the current stream and does not synchronise.
    """
    check_cuda("sparse_cross", data, indices, indptr, Z)
    acc = data.dtype if acc_dtype is None else to_dtype(acc_dtype)
    check_dtypes("sparse_cross", acc, data, Z)
    if kind not in KINDS:
        raise ValueError(f"unsupported kind {kind!r}; one of {sorted(KINDS)}")
    if data.dtype != Z.dtype:
        raise TypeError(f"sparse_cross needs one dtype, got {data.dtype} and "
                        f"{Z.dtype}")
    if indices.dtype != torch.int32 or indptr.dtype != torch.int32:
        raise TypeError(f"sparse_cross needs int32 indices and indptr, got "
                        f"{indices.dtype} and {indptr.dtype}")
    if (data.ndim != 1 or indices.shape != data.shape or indptr.ndim != 1
            or indptr.shape[0] < 1 or Z.ndim != 2):
        raise ValueError(
            f"sparse_cross needs data and indices (nnz,), indptr "
            f"(n_rows + 1,) and Z (p, d), got {tuple(data.shape)}, "
            f"{tuple(indices.shape)}, {tuple(indptr.shape)} and "
            f"{tuple(Z.shape)}")
    if not all(a.is_contiguous() for a in (data, indices, indptr, Z)):
        raise ValueError("sparse_cross needs contiguous operands")
    if kind == "poly" and int(degree) < 0:
        raise ValueError(f"poly degree must be >= 0, got {degree}")
    n_rows = indptr.shape[0] - 1
    p, d = Z.shape
    slab = SLAB_BYTES // Z.element_size()
    ld = -(-p // slab) * slab
    if max(n_rows, ld, d, data.shape[0]) > _INT32_MAX or d * ld > 2**62:
        raise ValueError(f"sparse_cross shape {(n_rows, p, d)} exceeds int32")
    out = torch.empty((n_rows, p), dtype=data.dtype, device=data.device)
    if n_rows == 0 or p == 0:
        return out
    # Zᵀ as one (d, ld) copy, its rows padded with zeros to whole slabs so
    # that every slab load is aligned and in bounds
    Zt = torch.empty((d, ld), dtype=Z.dtype, device=Z.device)
    Zt[:, :p] = Z.T
    Zt[:, p:] = 0
    zz = torch.empty(p, dtype=acc, device=Z.device)
    fn, err = _entry()
    code = fn(data.data_ptr(), indices.data_ptr(), indptr.data_ptr(),
              Z.data_ptr(), Zt.data_ptr(), zz.data_ptr(), out.data_ptr(),
              n_rows, p, d, ld, DTYPE_CODES[data.dtype], DTYPE_CODES[acc],
              KINDS[kind], 2.0 * float(bandwidth) ** 2, float(scale),
              float(offset), int(degree), data.device.index,
              torch.cuda.current_stream(data.device).cuda_stream)
    if code:
        raise RuntimeError(f"sparse_cross launch failed: "
                           f"{err(code).decode()} (cudaError {code})")
    sparse_cross.launches += 1
    return out


sparse_cross.launches = 0
