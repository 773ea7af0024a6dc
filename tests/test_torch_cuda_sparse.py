"""K3 ``sparse_cross`` against its plain version, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU; no JAX
import (run with ``--noconftest -m cuda``, see tests/test_torch_cuda.py).
Tolerances (tests/_torch_common.py): 1e-10 at float64, atol 2e-5 on float32
blocks; the mixed builds at the float32 tolerance. Landmarks come dense
(every column hot or listed in full) and as densified CSR rows, as the
sparse path makes them (most columns listed, a few hot).
"""
import numpy as np
import pytest
import torch
from _torch_common import DTYPES, close, cuda, normal, t, tol  # noqa: F401

from repro_torch.data import CsrMatrix
from repro_torch.kernels import ops, sparse_block

KINDS = {"rbf": dict(bandwidth=1.3), "linear": {},
         "poly": dict(degree=3, scale=1.0, offset=0.7)}
MIXED = [("float32", "float64"), ("float64", "float32")]


def _csr(n, d, dtype, seed=0):
    """n CSR rows over d columns, 0-40 values each (every 7th row empty),
    with 11 NaN padding slots past indptr[-1] that no kernel may read."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 41, n)
    lengths[::7] = 0
    lengths = np.minimum(lengths, d)
    cols = [np.sort(rng.choice(d, k, replace=False)) for k in lengths]
    indices = np.concatenate(cols + [np.zeros(11, np.int64)]).astype(np.int32)
    data = np.concatenate([rng.standard_normal(int(lengths.sum())) / 5.0,
                           np.full(11, np.nan)]).astype(dtype)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return CsrMatrix(data, indices, indptr, d)


def _landmarks(p, d, dtype, seed=1):
    """p densified rows of another such matrix: the sparse path's Z."""
    return _csr(p, d, dtype, seed).todense().numpy()


def _sparse(kind, X, Z, acc_dtype=None, prepared=None):
    return ops.sparse_block(X.data, X.indices, X.indptr, Z, kind=kind,
                            acc_dtype=acc_dtype, prepared=prepared,
                            **KINDS[kind])


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,d", [(1031, 257, 3000), (8, 8, 1),
                                   (300, 2048, 90)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sparse_cross_matches_plain(cuda, dtype, n, p, d):
    X = _csr(n, d, dtype)
    Z = normal((p, d), 1, dtype, 0.2)
    for kind in KINDS:
        before = sparse_block.sparse_cross.launches
        got = _sparse(kind, X.cast(device="cuda"), t(Z, "cuda"))
        assert sparse_block.sparse_cross.launches == before + 1, kind
        assert got.is_cuda and got.shape == (n, p), kind
        close(got, _sparse(kind, X.cast(), t(Z)), err_msg=kind, **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_sparse_cross_on_landmark_rows_matches_plain(cuda, dtype):
    """Z as densified CSR rows, prepared once and reused over the kinds:
    hot columns and listed ones both carry values."""
    X = _csr(1031, 3000, dtype, seed=2)
    Z = t(_landmarks(600, 3000, dtype), "cuda")
    prep = ops.sparse_landmarks(Z, getattr(torch, dtype))
    assert 0 < prep.hot.shape[0] <= sparse_block.max_hot(prep.acc)
    assert prep.ent_j.shape[0] > 0
    for kind in KINDS:
        got = _sparse(kind, X.cast(device="cuda"), Z, prepared=prep)
        close(got, _sparse(kind, X.cast(), Z.cpu()), err_msg=kind,
              **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,acc", MIXED)
def test_sparse_cross_mixed_accumulation_matches_plain(cuda, dtype, acc):
    X = _csr(1031, 3000, dtype, seed=2)
    for Z in (normal((257, 3000), 3, dtype, 0.2),
              _landmarks(257, 3000, dtype)):
        for kind in KINDS:
            got = _sparse(kind, X.cast(device="cuda"), t(Z, "cuda"), acc)
            assert got.dtype == getattr(torch, dtype), kind
            close(got, _sparse(kind, X.cast(), t(Z), acc), err_msg=kind,
                  **tol("float32"))


@pytest.mark.cuda
def test_sparse_cross_refuses_bf16_and_int64_structure(cuda):
    """bf16 values are taken since K3's bf16 instance exists (its blocks are
    held to the plain version in tests/test_torch_cuda_bf16.py), but not
    with a bf16 accumulator, nor float16 values; int64 structure is
    refused, and so are landmarks prepared for another accumulation, from
    another Z of the same shape, or from this Z before it changed."""
    X = _csr(16, 9, "float32").cast(device="cuda")
    Z = t(np.zeros((4, 9), np.float32), "cuda")
    with pytest.raises(TypeError, match="float32 or float64"):
        sparse_block.sparse_cross(X.data.bfloat16(), X.indices, X.indptr,
                                  Z.bfloat16())
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        sparse_block.sparse_cross(X.data.half(), X.indices, X.indptr,
                                  Z.half(), acc_dtype="float32")
    got = sparse_block.sparse_cross(X.data.bfloat16(), X.indices, X.indptr,
                                    Z.bfloat16(), acc_dtype="float32")
    assert got.dtype == torch.bfloat16 and bool(torch.all(got == 0))
    with pytest.raises(TypeError, match="int32"):
        sparse_block.sparse_cross(X.data, X.indices.long(), X.indptr, Z)
    other = sparse_block.prepare_landmarks(Z, torch.float64)
    with pytest.raises(ValueError, match="prepared landmarks"):
        sparse_block.sparse_cross(X.data, X.indices, X.indptr, Z,
                                  prepared=other)
    other = sparse_block.prepare_landmarks(Z.clone())
    with pytest.raises(ValueError, match="another Z"):
        sparse_block.sparse_cross(X.data, X.indices, X.indptr, Z,
                                  prepared=other)
    own = sparse_block.prepare_landmarks(Z)
    Z.add_(1.0)
    with pytest.raises(ValueError, match="another Z"):
        sparse_block.sparse_cross(X.data, X.indices, X.indptr, Z,
                                  prepared=own)
