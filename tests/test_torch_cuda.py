"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU. This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (tests/_torch_common.py): 1e-10 at float64, atol 2e-5 on
float32 blocks (dense and CSR) and rtol 2e-4 on float32 scores (K2's float32
build is 3xTF32 on the tensor cores, within about 1.4e-5 of IEEE float32 at
p = 2048 on an H100). A launch that mixes the two
dtypes (float32 data with float64 accumulation, or the reverse) is held at
the float32 tolerance: the float32 side sets its error.
"""
import numpy as np
import pytest
import torch
from _torch_common import DTYPES, close, cuda, normal, t, tol  # noqa: F401

from repro_torch.data import CsrMatrix
from repro_torch.kernels import ops, rbf_block, rls_scores, sparse_block

SHAPES = [(300, 90, 17), (257, 129, 33), (8, 8, 1), (1031, 2048, 90)]
KINDS = {"rbf": dict(bandwidth=1.3), "linear": {},
         "poly": dict(degree=3, scale=1.0, offset=0.7)}
# (data dtype, accumulation dtype) of the mixed builds, reached through
# acc_dtype when Precision.accum_dtype differs from the data dtype
MIXED = [("float32", "float64"), ("float64", "float32")]


def _block(kind, X, Z, acc_dtype=None):
    fn = {"rbf": ops.rbf_block, "linear": ops.linear_block,
          "poly": ops.poly_block}[kind]
    return fn(X, Z, acc_dtype=acc_dtype, **KINDS[kind])


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,d", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_block_matches_plain(cuda, dtype, n, p, d):
    X = normal((n, d), 0, dtype, d ** -0.5)
    Z = normal((p, d), 1, dtype, d ** -0.5)
    for kind in KINDS:
        before = rbf_block.kernel_block.launches
        got = _block(kind, t(X, "cuda"), t(Z, "cuda"))
        assert rbf_block.kernel_block.launches == before + 1, kind
        assert got.is_cuda and got.shape == (n, p), kind
        close(got, _block(kind, t(X), t(Z)), err_msg=kind, **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(300, 90), (257, 129), (8, 8), (5003, 600),
                                 (5003, 37), (5003, 2048)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rls_scores_matches_plain(cuda, dtype, n, p):
    """float32 runs on the tensor cores (3xTF32): p = 37 is ragged against
    the 32-deep slabs, the 256-column blocks and 16-byte copies."""
    B = normal((n, p), 2, "float64", p ** -0.5)
    M = np.linalg.inv(B.T @ B + n * 1e-3 * np.eye(p))
    B = B.astype(dtype)
    before = rls_scores.rls_scores_fused.launches
    got = ops.rls_scores(t(B, "cuda"), t(M, "cuda"))
    assert rls_scores.rls_scores_fused.launches == before + 1
    close(got, ops.rls_scores(t(B), t(M)), **tol(dtype, scores=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,acc", MIXED)
def test_kernel_block_mixed_accumulation_matches_plain(cuda, dtype, acc):
    n, p, d = 1031, 257, 90
    X = normal((n, d), 0, dtype, d ** -0.5)
    Z = normal((p, d), 1, dtype, d ** -0.5)
    for kind in KINDS:
        before = rbf_block.kernel_block.launches
        got = _block(kind, t(X, "cuda"), t(Z, "cuda"), acc)
        assert rbf_block.kernel_block.launches == before + 1, kind
        assert got.dtype == getattr(torch, dtype), kind
        close(got, _block(kind, t(X), t(Z), acc), err_msg=kind,
              **tol("float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,acc", MIXED)
def test_rls_scores_mixed_accumulation_matches_plain(cuda, dtype, acc):
    n, p = 5003, 600
    B = normal((n, p), 2, "float64", p ** -0.5)
    M = np.linalg.inv(B.T @ B + n * 1e-3 * np.eye(p))
    B = B.astype(dtype)
    before = rls_scores.rls_scores_fused.launches
    got = ops.rls_scores(t(B, "cuda"), t(M, "cuda"), acc_dtype=acc)
    assert rls_scores.rls_scores_fused.launches == before + 1
    assert got.dtype == getattr(torch, dtype)
    close(got, ops.rls_scores(t(B), t(M), acc_dtype=acc),
          **tol("float32", scores=True))


@pytest.mark.cuda
def test_kernel_block_refuses_bf16_on_the_card(cuda):
    X = t(np.zeros((4, 3)), "cuda").bfloat16()
    with pytest.raises(TypeError, match="bf16"):
        rbf_block.kernel_block(X, X)


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


def _sparse(kind, X, Z, acc_dtype=None):
    return ops.sparse_block(X.data, X.indices, X.indptr, Z, kind=kind,
                            acc_dtype=acc_dtype, **KINDS[kind])


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
@pytest.mark.parametrize("dtype,acc", MIXED)
def test_sparse_cross_mixed_accumulation_matches_plain(cuda, dtype, acc):
    X = _csr(1031, 3000, dtype, seed=2)
    Z = normal((257, 3000), 3, dtype, 0.2)
    for kind in KINDS:
        got = _sparse(kind, X.cast(device="cuda"), t(Z, "cuda"), acc)
        assert got.dtype == getattr(torch, dtype), kind
        close(got, _sparse(kind, X.cast(), t(Z), acc), err_msg=kind,
              **tol("float32"))


@pytest.mark.cuda
def test_sparse_cross_refuses_bf16_and_int64_structure(cuda):
    X = _csr(16, 9, "float32").cast(device="cuda")
    Z = t(np.zeros((4, 9), np.float32), "cuda")
    with pytest.raises(TypeError, match="bf16"):
        sparse_block.sparse_cross(X.data.bfloat16(), X.indices, X.indptr,
                                  Z.bfloat16())
    with pytest.raises(TypeError, match="int32"):
        sparse_block.sparse_cross(X.data, X.indices.long(), X.indptr, Z)
