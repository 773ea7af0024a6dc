"""CSR sparse rows: the port's sparse input subsystem.

Bag-of-words text and user-item data live in sparse features where
``d ≫ p`` and densifying X would cost more than the kernel itself. The
paper's pipeline touches X only through row-block kernel evaluations
k(X, Z) against a dense (p, d) landmark block, so a CSR block
(``kernels.sparse_block``, kernel K3 on the card) opens every sampler and
solver of the out-of-core driver to sparse data.

:class:`CsrMatrix`
    ``data``/``indices`` over a flat stream of stored values plus the
    ``indptr`` row pointer and the column count. Host-side it holds numpy
    arrays; ``cast`` moves it to a device as tensors. It has enough of an
    array's surface (``shape``, ``dtype``, ``astype``, a dense row gather
    through ``[]``) for the executors' cast and landmark-gather paths.

:class:`SparseChunkSource`
    The CSR counterpart of ``ArrayChunkSource``: chunks of exactly
    ``chunk_rows`` rows and ``nnz_cap`` stored slots, zero-valued padding
    past ``indptr[-1]`` and ``n_valid`` masking the padded tail rows.

Dense↔sparse is numerical parity (same algebra, another order of
summation), sparse↔sparse across source kinds is bit identity.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch
from torch import Tensor

from .chunks import Chunk, ChunkSource, is_floating, pad_rows, to_host

__all__ = ["CsrMatrix", "SparseChunkSource", "is_sparse_matrix"]


def _tensor(a, device=None) -> Tensor:
    return torch.as_tensor(a, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class CsrMatrix:
    """A CSR row block.

    Attributes:
      data:    ``(nnz,)`` stored values; slots at or past ``indptr[-1]``
               are structural padding that belongs to no row.
      indices: ``(nnz,)`` int32 column ids aligned with ``data``.
      indptr:  ``(n_rows + 1,)`` int32 row pointer.
      n_cols:  the column count ``d``.

    The three arrays are numpy arrays (host side, as a chunk source holds
    them) or tensors of one device (after ``cast``).
    """

    data: Tensor | np.ndarray
    indices: Tensor | np.ndarray
    indptr: Tensor | np.ndarray
    n_cols: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.indptr.shape[0] - 1, self.n_cols)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return (self.data.device if isinstance(self.data, Tensor)
                else torch.device("cpu"))

    @property
    def nnz(self) -> int:
        """Stored-slot capacity (structural padding included)."""
        return self.data.shape[0]

    def validate(self) -> "CsrMatrix":
        """Check the structure (shapes, a non-decreasing ``indptr`` from 0,
        column ids in ``[0, n_cols)``) so that no kernel reads out of
        bounds; returns ``self``. Entry points call it once per matrix."""
        data, indices = _tensor(self.data), _tensor(self.indices)
        ptr = _tensor(self.indptr).long()
        if data.ndim != 1 or indices.shape != data.shape or ptr.ndim != 1 \
                or ptr.shape[0] < 1:
            raise ValueError(
                f"CSR needs 1-D data and indices of one length and a 1-D "
                f"indptr; got {tuple(data.shape)}, {tuple(indices.shape)}, "
                f"{tuple(ptr.shape)}")
        if int(ptr[0]) != 0 or bool((ptr[1:] < ptr[:-1]).any()) \
                or int(ptr[-1]) > data.shape[0]:
            raise ValueError("CSR indptr must start at 0, never decrease and "
                             "end at or below the stored-slot count")
        used = indices[:int(ptr[-1])]
        if used.numel() and (int(used.min()) < 0
                             or int(used.max()) >= self.n_cols):
            raise ValueError(f"CSR column ids must lie in [0, {self.n_cols})")
        return self

    def astype(self, dtype) -> "CsrMatrix":
        """Values cast to ``dtype``; the structure is untouched."""
        data = (self.data.to(dtype) if isinstance(self.data, Tensor)
                else self.data.astype(dtype))
        return CsrMatrix(data, self.indices, self.indptr, self.n_cols)

    def cast(self, dtype: torch.dtype | None = None,
             device: str | torch.device | None = None) -> "CsrMatrix":
        """Tensors on ``device``: values in ``dtype`` (None keeps theirs),
        structure in int32 — the sparse form of the driver's chunk cast."""
        return CsrMatrix(torch.as_tensor(self.data, dtype=dtype,
                                         device=device),
                         torch.as_tensor(self.indices, dtype=torch.int32,
                                         device=device),
                         torch.as_tensor(self.indptr, dtype=torch.int32,
                                         device=device), self.n_cols)

    def todense(self) -> Tensor:
        """Dense ``(n_rows, d)`` tensor — for tests; no executor calls it."""
        from ..kernels.sparse_block import sparse_row_ids
        data = _tensor(self.data)
        rows = sparse_row_ids(_tensor(self.indptr, data.device), data.shape[0])
        out = torch.zeros((self.shape[0] + 1, self.n_cols), dtype=data.dtype,
                          device=data.device)
        out.index_put_((rows.long(), _tensor(self.indices, data.device).long()),
                       data, accumulate=True)
        return out[:-1]

    def __getitem__(self, idx) -> Tensor:
        """Dense row gather: an int gives one ``(d,)`` row, an index array
        ``(len(idx), d)`` rows — the landmark gather ``X[sample.idx]``,
        which densifies by design (landmarks are a dense (p, d) block).

        Only the selected rows' slots are read, found by slicing
        ``indptr``: O(their stored values + len(idx)·d)."""
        if isinstance(idx, slice):
            raise TypeError(
                "CsrMatrix does not support row slicing; wrap it in "
                "repro_torch.data.SparseChunkSource for fixed-size row blocks")
        data = _tensor(self.data)
        dev = data.device
        indptr = _tensor(self.indptr, dev).long()
        sel = torch.as_tensor(np.asarray(idx) if not isinstance(idx, Tensor)
                              else idx, device=dev).long()
        scalar = sel.ndim == 0
        sel = sel.reshape(-1)
        sel = torch.where(sel < 0, sel + self.shape[0], sel)
        if sel.numel() and (int(sel.min()) < 0
                            or int(sel.max()) >= self.shape[0]):
            raise IndexError(f"row index out of range for {self.shape[0]} "
                             "rows")
        starts, lengths = indptr[sel], indptr[sel + 1] - indptr[sel]
        out_row = torch.repeat_interleave(
            torch.arange(sel.numel(), device=dev), lengths)
        first = torch.cumsum(lengths, 0) - lengths
        slot = starts[out_row] + (torch.arange(out_row.numel(), device=dev)
                                  - first[out_row])
        out = torch.zeros((sel.numel(), self.n_cols), dtype=data.dtype,
                          device=dev)
        out.index_put_((out_row, _tensor(self.indices, dev)[slot].long()),
                       data[slot], accumulate=True)
        return out[0] if scalar else out

    @classmethod
    def from_dense(cls, X) -> "CsrMatrix":
        """Host-side CSR compression of a dense ``(n, d)`` array (exact
        zeros dropped, row-major order kept)."""
        X = X.detach().cpu().numpy() if isinstance(X, Tensor) else np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"CsrMatrix.from_dense needs a 2-D (n, d) "
                             f"array, got shape {X.shape}")
        rows, cols = np.nonzero(X)
        counts = np.bincount(rows, minlength=X.shape[0])
        indptr = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(counts)]).astype(np.int32)
        return cls(np.ascontiguousarray(X[rows, cols]),
                   cols.astype(np.int32), indptr, int(X.shape[1]))

    @classmethod
    def from_scipy(cls, mat) -> "CsrMatrix":
        """From any scipy.sparse matrix (duck-typed through ``.tocsr()``)."""
        csr = mat.tocsr()
        return cls(np.asarray(csr.data),
                   np.asarray(csr.indices, dtype=np.int32),
                   np.asarray(csr.indptr, dtype=np.int32), int(csr.shape[1]))


def is_sparse_matrix(x) -> bool:
    """True for the inputs the sparse seam owns: a :class:`CsrMatrix` or a
    scipy.sparse matrix (duck-typed)."""
    return isinstance(x, CsrMatrix) or hasattr(x, "tocsr")


class SparseChunkSource(ChunkSource):
    """Fixed-size CSR row chunks with ``ArrayChunkSource`` semantics.

    Every chunk's ``X`` is a host-side :class:`CsrMatrix` of exactly
    ``chunk_rows`` rows and ``nnz_cap`` stored slots — the largest
    per-chunk count of stored values over the whole matrix, fixed at
    construction. Tail rows own zero slots, surplus slots sit past
    ``indptr[-1]`` with value 0 and column 0, and ``n_valid`` masks the
    padded rows out of every reduction as in the dense sources.

    Accepts a :class:`CsrMatrix` or any scipy.sparse matrix; dense arrays
    belong in ``ArrayChunkSource``.
    """

    def __init__(self, X, y=None, chunk_rows: int = 4096):
        super().__init__(chunk_rows)
        if not isinstance(X, CsrMatrix):
            if hasattr(X, "tocsr"):
                X = CsrMatrix.from_scipy(X)
            else:
                raise TypeError(
                    f"SparseChunkSource needs a CsrMatrix or a scipy.sparse "
                    f"matrix, got {type(X).__name__}; dense arrays belong in "
                    "ArrayChunkSource")
        self._data = to_host(X.data)
        self._indices = to_host(X.indices).astype(np.int32, copy=False)
        self._indptr = to_host(X.indptr).astype(np.int32, copy=False)
        self._n_cols = int(X.n_cols)
        if not is_floating(self._data.dtype):
            raise ValueError(f"sparse source data must be floating, got "
                             f"dtype {self._data.dtype}")
        CsrMatrix(self._data, self._indices, self._indptr,
                  self._n_cols).validate()
        self.y = None if y is None else to_host(y)
        if self.y is not None and self.y.shape[0] != self.n_rows:
            raise ValueError(f"y has {self.y.shape[0]} rows but X has "
                             f"{self.n_rows}")
        r, n = self.chunk_rows, self.n_rows
        starts = np.arange(0, max(n, 1), r)
        ends = np.minimum(starts + r, n)
        per_chunk = self._indptr[ends] - self._indptr[starts]
        self.nnz_cap = int(max(1, per_chunk.max(initial=0)))

    @property
    def has_targets(self) -> bool:
        return self.y is not None

    @property
    def n_rows(self) -> int:
        return self._indptr.shape[0] - 1

    @property
    def n_cols(self) -> int:
        return self._n_cols

    def chunks(self) -> Iterator[Chunk]:
        r, n, cap = self.chunk_rows, self.n_rows, self.nnz_cap
        for start in range(0, max(n, 1), r):
            end = min(start + r, n)
            lo, hi = int(self._indptr[start]), int(self._indptr[end])
            data = self._data[lo:hi]
            indices = self._indices[lo:hi]
            indptr = (self._indptr[start:end + 1] - lo).astype(np.int32)
            if end - start < r:   # tail: padded rows own zero slots
                indptr = np.concatenate(
                    [indptr, np.full(r - (end - start), indptr[-1], np.int32)])
            pad = cap - data.shape[0]
            if pad:               # surplus slots sit past indptr[-1]
                data = np.concatenate([data, np.zeros(pad, data.dtype)])
                indices = np.concatenate([indices, np.zeros(pad, np.int32)])
            yb = None if self.y is None else pad_rows(self.y[start:end], r)
            yield Chunk(CsrMatrix(data, indices, indptr, self._n_cols), yb,
                        end - start, start)
