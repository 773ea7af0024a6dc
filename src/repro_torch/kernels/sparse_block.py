"""K3 ``sparse_cross``: k(X_csr, Z) on the card through ``csrc/sparse_cross.cu``.

The Hopper counterpart of the Pallas kernel
``src/repro/kernels/sparse_block.py::_sparse_cross_pallas``. X is a CSR row
block (``data``/``indices`` over the stored values, ``indptr`` the row
pointer), Z a dense (p, d) landmark block. One launch computes the cross
product X·Zᵀ and, for kind rbf/poly, the kernel's epilogue in the same
store (‖x_i‖² from the values the kernel walks).

Z is prepared once (``prepare_landmarks``, a ``SparseLandmarks``): ‖z‖²,
the hot columns (the ones with the most non-zeros in Z) as a dense table of
Zᵀ rows, and Z's other non-zeros as per-column lists. A fit prepares its
landmarks once and hands the preparation to every launch (``prepared=``);
a launch without one prepares Z itself. See the note at the top of the CUDA
source for the design and its bound.

Also here, shared with the plain versions in ``ref`` and with
``data.sparse``: the nnz tile of the plain contraction (``sparse_tile``),
the row id of every stored slot (``sparse_row_ids``) and the row norms
(``sparse_row_sqnorms``).

Accumulation follows the reference: the result dtype
``promote(data, Z)`` unless ``acc_dtype`` overrides it (float32 or float64
on the card; bf16 values accumulate in float32 by the precision policy's
bf16 rule). bf16 values take the same kernel on a bf16 values array. As
in the reference's ``sparse_kernel_block``, ‖x‖² and the cross product are
rounded to the block dtype before the epilogue. This wrapper takes CUDA
tensors only;
``repro_torch.kernels.ops.sparse_block`` sends CPU tensors to the plain
version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch import Tensor

from ..core.precision import to_dtype
from .rbf_block import (ACC_CODES, DTYPE_CODES, KINDS, check_cuda,
                        check_dtypes)

# floor on the plain contraction's nnz tile: below it the loop's step count
# dominates; the (tile, p) gather it implies is a constant O(MIN_TILE·p)
MIN_TILE = 512
# landmark columns a block of the kernel owns (csrc/sparse_cross.cu SLAB):
# the hot table's rows are padded to whole slabs and the lists are cut at
# slab edges
SLAB = 256
# bytes of the hot table's slab that a block holds in shared memory, and the
# most hot columns (csrc/sparse_cross.cu HOT_BYTES, MAX_HOT; hot_slot is
# int8): 127 hot columns in float32, 80 in float64 (``max_hot``)
HOT_BYTES = 160 * 1024
MAX_HOT = 127
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
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = [P, P, P, P, P, I, P, P, P, P, P, I, I, I, I, I, I, D, D,
                   D, I, I, P]
    fn.restype = ctypes.c_int
    norms = lib.sparse_sqnorms_launch
    norms.argtypes = [P, I, I, I, I, P, I, P]
    norms.restype = ctypes.c_int
    err = lib.sparse_cross_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, norms, err


@dataclasses.dataclass(frozen=True)
class SparseLandmarks:
    """Landmarks Z (p, d) prepared for K3, once per Z: a fit builds one
    when its landmarks are set and passes it to every CSR block.

    ``Z`` is the tensor prepared and ``version`` its ``_version`` then (None
    for an inference tensor): a launch takes the preparation only for that
    same, unchanged tensor. ``zz`` (p,) ‖z_j‖² in ``acc``; ``hot_slot`` (d,) int8, the row of ``hot``
    that holds feature column c, or −1; ``hot`` (H, ld) in ``acc``, Zᵀ rows
    of the H hot columns, zero past p (ld = p padded to whole slabs of
    ``SLAB``); the other columns' non-zeros of Z, by (column, slab): those of
    column c in slab s are ``ent_j``/``ent_z`` [colptr[c·S + s],
    colptr[c·S + s + 1]), ``ent_j`` the landmark's index inside its slab."""

    Z: Tensor
    version: int | None
    acc: torch.dtype
    zz: Tensor
    hot_slot: Tensor
    hot: Tensor
    colptr: Tensor
    ent_j: Tensor
    ent_z: Tensor

    @property
    def ld(self) -> int:
        return self.hot.shape[1]

    @property
    def slabs(self) -> int:
        return self.ld // SLAB


def max_hot(acc: torch.dtype) -> int:
    """The most hot columns whose slab fits the kernel's table."""
    return min(MAX_HOT,
               HOT_BYTES // (SLAB * torch.empty((), dtype=acc).element_size()))


def _version(t: Tensor) -> int | None:
    return None if t.is_inference() else t._version


def prepare_landmarks(Z: Tensor, acc_dtype=None) -> SparseLandmarks:
    """Z (p, d) prepared for ``sparse_cross`` under accumulation
    ``acc_dtype`` (default: Z's dtype), on Z's device.

    The hot columns are the ``max_hot(acc)`` with the most non-zeros in Z,
    ties to the lower column id, among those with any: a choice from Z
    alone, so a prepared Z is the same on every call. The lists hold Z's non-zeros only; a zero of Z adds nothing to a
    product."""
    if Z.ndim != 2:
        raise ValueError(f"landmarks must be (p, d), got {tuple(Z.shape)}")
    acc = Z.dtype if acc_dtype is None else to_dtype(acc_dtype)
    if Z.is_cuda:
        check_dtypes("sparse_cross", acc, Z)
    Z = Z.contiguous()
    p, d = Z.shape
    dev = Z.device
    ld = -(-p // SLAB) * SLAB
    slabs = ld // SLAB
    if d * slabs + 1 > _INT32_MAX or p * d > 2**62:
        raise ValueError(f"landmarks shape {(p, d)} exceeds int32 lists")
    nz = Z.T.contiguous() != 0                          # (d, p)
    counts = nz.sum(dim=1)
    n_hot = min(max_hot(acc), int((counts > 0).sum()))
    order = torch.arange(d, device=dev)
    key = counts * d + (d - 1 - order)                  # unique: no ties
    hot_cols = torch.sort(torch.topk(key, n_hot).indices).values
    hot_slot = torch.full((d,), -1, dtype=torch.int8, device=dev)
    hot_slot[hot_cols] = torch.arange(n_hot, dtype=torch.int8, device=dev)
    hot = torch.zeros((n_hot, ld), dtype=acc, device=dev)
    hot[:, :p] = Z[:, hot_cols].T.to(acc)
    nz[hot_cols] = False
    cj = torch.nonzero(nz)                              # (c, j), sorted
    c, j = cj[:, 0], cj[:, 1]
    if c.shape[0] > _INT32_MAX:
        raise ValueError(f"landmarks with {c.shape[0]} non-zeros exceed "
                         "int32 lists")
    counts_cs = torch.bincount(c * slabs + j // SLAB, minlength=d * slabs)
    colptr = torch.zeros(d * slabs + 1, dtype=torch.int32, device=dev)
    colptr[1:] = torch.cumsum(counts_cs, 0).to(torch.int32)
    ent_j = (j % SLAB).to(torch.int32)
    ent_z = Z[j, c].to(acc)
    if Z.is_cuda:
        zz = torch.empty(p, dtype=acc, device=dev)
        _, norms, err = _entry()
        code = norms(Z.data_ptr(), p, d, DTYPE_CODES[Z.dtype],
                     ACC_CODES[acc], zz.data_ptr(), dev.index,
                     torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise RuntimeError(f"sparse_cross norms launch failed: "
                               f"{err(code).decode()} (cudaError {code})")
    else:
        Za = Z.to(acc)
        zz = torch.sum(Za * Za, dim=1)
    return SparseLandmarks(Z, _version(Z), acc, zz, hot_slot, hot, colptr, ent_j, ent_z)


def sparse_cross(data: Tensor, indices: Tensor, indptr: Tensor, Z: Tensor, *,
                 kind: str = "linear", bandwidth: float = 1.0,
                 degree: int = 2, scale: float = 1.0, offset: float = 1.0,
                 acc_dtype=None,
                 prepared: SparseLandmarks | None = None) -> Tensor:
    """k(X_csr, Z) ∈ R^{n_rows×p} in one launch of K3 (CUDA tensors only).

    ``data`` (nnz,) and Z (p, d) are contiguous float32, float64 or bf16
    tensors of one dtype, ``indices`` (nnz,) and ``indptr`` (n_rows + 1,) contiguous
    int32, all on one CUDA device; column ids must lie in [0, d)
    (``CsrMatrix.validate``). Slots at or past ``indptr[-1]`` are never
    read. ``acc_dtype`` overrides the accumulation (default: the data
    dtype). ``prepared`` is this very Z, unchanged since, prepared for this
    accumulation (``prepare_landmarks``); without it the call prepares Z.
    Launches on the current stream and does not synchronise.
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
    if max(n_rows, d, data.shape[0]) > _INT32_MAX:
        raise ValueError(f"sparse_cross shape {(n_rows, p, d)} exceeds int32")
    if prepared is None:
        prepared = prepare_landmarks(Z, acc)
    elif (prepared.Z.shape != Z.shape or prepared.Z.dtype != Z.dtype
          or prepared.Z.device != Z.device or prepared.acc != acc):
        raise ValueError(
            f"prepared landmarks are {tuple(prepared.Z.shape)} "
            f"{prepared.Z.dtype} with {prepared.acc} accumulation on "
            f"{prepared.Z.device}; this call has Z {tuple(Z.shape)} "
            f"{Z.dtype} with {acc} on {Z.device}")
    elif (prepared.Z.data_ptr() != Z.data_ptr()
          or prepared.version != _version(Z)):
        raise ValueError("prepared landmarks were made from another Z, or Z "
                         "has changed since: prepare this Z")
    out = torch.empty((n_rows, p), dtype=data.dtype, device=data.device)
    if n_rows == 0 or p == 0:
        return out
    fn, _, err = _entry()
    L = prepared
    code = fn(data.data_ptr(), indices.data_ptr(), indptr.data_ptr(),
              L.hot_slot.data_ptr(), L.hot.data_ptr(), L.hot.shape[0],
              L.colptr.data_ptr(), L.ent_j.data_ptr(), L.ent_z.data_ptr(),
              L.zz.data_ptr(), out.data_ptr(), n_rows, p, L.ld,
              DTYPE_CODES[data.dtype], ACC_CODES[acc], KINDS[kind],
              2.0 * float(bandwidth) ** 2, float(scale), float(offset),
              int(degree), data.device.index,
              torch.cuda.current_stream(data.device).cuda_stream)
    if code:
        raise RuntimeError(f"sparse_cross launch failed: "
                           f"{err(code).decode()} (cudaError {code})")
    sparse_cross.launches += 1
    return out


sparse_cross.launches = 0
