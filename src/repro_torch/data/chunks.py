"""Chunked row sources for out-of-core fitting (``SketchedKRR.fit(source)``).

The paper's pipeline — the Theorem-4 score pass and the Theorem-3 sketch
solve — touches the data only through O(n·p) row-block kernel
evaluations, so a fit never needs the whole ``(n, d)`` array on the card.
A :class:`ChunkSource` is "the training rows, one fixed-size block at a
time": every pass is a fresh ``chunks()`` iteration yielding
:class:`Chunk` values of one ``(chunk_rows, d)`` shape (the final tail
zero-padded, ``n_valid`` marking the real rows).

  :class:`ArrayChunkSource`      an in-memory array, re-chunked — the
                                 reference every other source is
                                 bit-identical to.
  :class:`GeneratorChunkSource`  a re-invocable factory of row blocks of
                                 any sizes, re-buffered into fixed chunks.
  :class:`MemmapChunkSource`     a memory-mapped ``.npy`` file; only the
                                 active chunk's rows are read.

Sources stay on the host and yield numpy blocks; the out-of-core driver
(``repro_torch.api.out_of_core``) moves one chunk at a time to the device
in the config's data dtype. ``repro_torch.data.sparse.SparseChunkSource``
is the CSR member of the family.
"""
from __future__ import annotations

import os
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np


class Chunk(NamedTuple):
    """One fixed-size row block of a :class:`ChunkSource` pass.

    Attributes:
      X:       ``(chunk_rows, d)`` rows (a ``CsrMatrix`` for a sparse
               source); rows past ``n_valid`` are zero padding.
      y:       ``(chunk_rows,)`` / ``(chunk_rows, k)`` targets padded the
               same way, or ``None`` for an X-only source.
      n_valid: number of real rows (< ``chunk_rows`` only on the tail).
      start:   global index of the chunk's first row.
    """

    X: object
    y: np.ndarray | None
    n_valid: int
    start: int


def pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """``arr`` zero-padded along axis 0 to exactly ``rows`` rows."""
    arr = np.asarray(arr)
    pad = rows - arr.shape[0]
    if pad <= 0:
        return arr
    return np.concatenate(
        [arr, np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)])


def to_host(a) -> np.ndarray:
    """A numpy view or copy of an array or tensor (sources live on the
    host; the driver moves one chunk at a time to the device)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def is_floating(dtype) -> bool:
    """True for a floating numpy dtype."""
    return np.issubdtype(np.dtype(dtype), np.floating)


def _validate_xy(X: np.ndarray, y: np.ndarray | None) -> None:
    """Shared source validation: 2-D float X, row-aligned y."""
    if X.ndim != 2:
        raise ValueError(f"chunk source X must be 2-D (n, d), got shape "
                         f"{X.shape}")
    if not is_floating(X.dtype):
        raise ValueError(f"chunk source X must be floating, got dtype "
                         f"{X.dtype}")
    if y is not None and y.shape[0] != X.shape[0]:
        raise ValueError(f"y has {y.shape[0]} rows but X has {X.shape[0]}")


class ChunkSource:
    """Base class: the training rows, one ``(chunk_rows, d)`` block at a
    time. Each ``chunks()`` call starts a fresh pass over the same rows in
    the same order; the driver makes several (diagonal, landmark gathers,
    Theorem-4 Gram, Theorem-4 scores, solver statistics)."""

    def __init__(self, chunk_rows: int):
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        self.chunk_rows = int(chunk_rows)

    @property
    def has_targets(self) -> bool:
        """Whether chunks carry a ``y`` block (required for fitting)."""
        raise NotImplementedError

    def chunks(self) -> Iterator[Chunk]:
        """A fresh pass of fixed-shape chunks covering every row once."""
        raise NotImplementedError


class ArrayChunkSource(ChunkSource):
    """In-memory ``(n, d)`` array re-chunked into fixed-size blocks — the
    source ``SketchedKRR.fit(X, y)`` wraps when ``chunk_rows`` is set."""

    def __init__(self, X, y=None, chunk_rows: int = 4096):
        super().__init__(chunk_rows)
        self.X = np.asarray(X)
        self.y = None if y is None else np.asarray(y)
        _validate_xy(self.X, self.y)

    @property
    def has_targets(self) -> bool:
        return self.y is not None

    @property
    def n_rows(self) -> int:
        return self.X.shape[0]

    def chunks(self) -> Iterator[Chunk]:
        r, n = self.chunk_rows, self.X.shape[0]
        for start in range(0, max(n, 1), r):
            xb = self.X[start:start + r]
            yb = None if self.y is None else self.y[start:start + r]
            yield Chunk(pad_rows(xb, r),
                        None if yb is None else pad_rows(yb, r),
                        xb.shape[0], start)


class GeneratorChunkSource(ChunkSource):
    """Row blocks from a re-invocable factory, re-buffered to fixed size.

    ``factory`` is a zero-argument callable returning an iterator of row
    blocks — ``X_block`` arrays or ``(X_block, y_block)`` pairs — of any
    (even zero) row counts. Each pass calls ``factory()`` afresh, so wrap
    the construction, not the iterator (``lambda: make_reader()``).
    """

    def __init__(self, factory: Callable[[], Iterable],
                 chunk_rows: int = 4096):
        super().__init__(chunk_rows)
        if not callable(factory):
            raise ValueError(
                "GeneratorChunkSource needs a zero-arg callable returning a "
                "fresh iterator per pass (the fit makes several passes); got "
                f"{type(factory).__name__}. Wrap the construction: "
                "lambda: make_blocks()")
        self._factory = factory
        self._has_targets: bool | None = None

    @property
    def has_targets(self) -> bool:
        if self._has_targets is None:  # peek one pass to learn the shape
            for _ in self.chunks():
                break
            if self._has_targets is None:
                raise ValueError("chunk source yielded no rows")
        return bool(self._has_targets)

    @staticmethod
    def _split(block) -> tuple[np.ndarray, np.ndarray | None]:
        if isinstance(block, tuple):
            xb, yb = block
            return np.asarray(xb), np.asarray(yb)
        return np.asarray(block), None

    def chunks(self) -> Iterator[Chunk]:
        r = self.chunk_rows
        buf_x: list[np.ndarray] = []
        buf_y: list[np.ndarray] = []
        buffered = start = 0
        dim: int | None = None
        for block in self._factory():
            xb, yb = self._split(block)
            if self._has_targets is None:
                self._has_targets = yb is not None
            elif (yb is not None) != self._has_targets:
                raise ValueError("generator blocks must consistently "
                                 "include or omit y")
            if xb.shape[0] == 0:
                continue
            _validate_xy(xb, yb)
            if dim is None:
                dim = xb.shape[1]
            elif xb.shape[1] != dim:
                raise ValueError(f"inconsistent block dims: {xb.shape[1]} "
                                 f"after {dim}")
            buf_x.append(xb)
            if yb is not None:
                buf_y.append(yb)
            buffered += xb.shape[0]
            while buffered >= r:
                X = np.concatenate(buf_x)
                y = np.concatenate(buf_y) if buf_y else None
                yield Chunk(X[:r], None if y is None else y[:r], r, start)
                start += r
                buf_x, buf_y = [X[r:]], ([] if y is None else [y[r:]])
                buffered -= r
        if buffered:
            X = np.concatenate(buf_x)
            y = np.concatenate(buf_y) if buf_y else None
            yield Chunk(pad_rows(X, r),
                        None if y is None else pad_rows(y, r), buffered, start)


class MemmapChunkSource(ChunkSource):
    """Memory-mapped ``.npy`` file(s): a pass reads only the active chunk's
    rows, so n is bounded by disk, not by host memory."""

    def __init__(self, x_path: str | os.PathLike,
                 y_path: str | os.PathLike | None = None,
                 chunk_rows: int = 4096):
        super().__init__(chunk_rows)
        self.x_path = os.fspath(x_path)
        self.y_path = None if y_path is None else os.fspath(y_path)
        X = np.load(self.x_path, mmap_mode="r")
        y = None if self.y_path is None else np.load(self.y_path,
                                                     mmap_mode="r")
        _validate_xy(X, y)
        self._shape = X.shape

    @property
    def has_targets(self) -> bool:
        return self.y_path is not None

    @property
    def n_rows(self) -> int:
        return self._shape[0]

    def chunks(self) -> Iterator[Chunk]:
        r = self.chunk_rows
        # a fresh memmap per pass: no file handle held between passes
        X = np.load(self.x_path, mmap_mode="r")
        y = None if self.y_path is None else np.load(self.y_path,
                                                     mmap_mode="r")
        n = X.shape[0]
        for start in range(0, max(n, 1), r):
            xb = np.asarray(X[start:start + r])     # reads ONE chunk
            yb = None if y is None else np.asarray(y[start:start + r])
            yield Chunk(pad_rows(xb, r),
                        None if yb is None else pad_rows(yb, r),
                        xb.shape[0], start)


def as_chunk_source(data, y=None, chunk_rows: int = 4096) -> ChunkSource:
    """Coerce ``data`` into a :class:`ChunkSource`: an existing source (as
    is), a ``.npy`` path (``y`` may be a second path), a zero-arg block
    factory, or an in-memory array (+ optional ``y``). Sparse input is
    refused here: it belongs in ``SparseChunkSource``."""
    if isinstance(data, ChunkSource):
        if y is not None:
            raise ValueError("y must ride inside the chunk source; passing "
                             "a separate y with a ChunkSource is ambiguous")
        return data
    if isinstance(data, (str, os.PathLike)):
        return MemmapChunkSource(data, y, chunk_rows)
    if callable(data):
        if y is not None:
            raise ValueError("a generator source yields (X, y) pairs "
                             "itself; separate y is not supported")
        return GeneratorChunkSource(data, chunk_rows)
    if hasattr(data, "tocsr") or hasattr(data, "indptr"):
        # np.asarray would densify a sparse matrix silently — the cost the
        # sparse subsystem exists to avoid
        raise TypeError(
            f"sparse input ({type(data).__name__}) would be densified "
            f"here; wrap it in repro_torch.data.SparseChunkSource (CsrMatrix"
            f".from_scipy accepts any scipy.sparse matrix) to keep the "
            f"fit in CSR form")
    return ArrayChunkSource(data, y, chunk_rows)


def gather_rows(source: ChunkSource, idx) -> np.ndarray:
    """Dense rows of the source at global indices ``idx``, in one pass.

    The driver's landmark gather: O(len(idx)·d) result, O(chunk) working
    set. Duplicates (draws are with replacement) are gathered once and
    fanned back out; a sparse chunk densifies only the selected rows."""
    idx = np.asarray(idx).reshape(-1)
    want = np.unique(idx)
    found: dict[int, np.ndarray] = {}
    n_total = 0
    for chunk in source.chunks():
        lo, hi = chunk.start, chunk.start + chunk.n_valid
        n_total = max(n_total, hi)
        sel = want[(want >= lo) & (want < hi)]
        if sel.size == 0:
            continue
        found.update(zip(sel.tolist(), to_host(chunk.X[sel - lo])))
    missing = [int(i) for i in want if int(i) not in found]
    if missing:
        raise IndexError(f"row indices {missing[:5]} out of range for "
                         f"source with {n_total} rows")
    return np.stack([found[int(i)] for i in idx])
