"""K1 ``kernel_block`` against its plain version, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU; no JAX
import (run with ``--noconftest -m cuda``, see tests/test_torch_cuda.py).
float32 blocks run IEEE fma on the CUDA cores (atol 2e-5); float64 and
float32 data accumulated in float64 run on the FP64 tensor cores (1e-10 at
float64; the mixed builds at the float32 tolerance, which their float32
side sets). Rows that are mostly zeros make the tensor-core build skip
products of all-zero blocks; that must not change the result.
"""
import numpy as np
import pytest
import torch
from _torch_common import DTYPES, close, cuda, normal, t, tol  # noqa: F401

from repro_torch.kernels import ops, rbf_block

# (300, 257, 4099): d ragged against the 16-deep slabs and the 16-byte copies
SHAPES = [(300, 90, 17), (257, 129, 33), (8, 8, 1), (1031, 2048, 90),
          (300, 257, 4099)]
KINDS = {"rbf": dict(bandwidth=1.3), "linear": {},
         "poly": dict(degree=3, scale=1.0, offset=0.7)}
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
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_block_on_sparse_rows_matches_plain(cuda, dtype):
    """W = k(Z, Z) over rows that are 99 % zeros, as the sparse path's
    densified landmarks are, accumulated in float64 (the tensor-core
    build): the products of all-zero blocks that it skips change nothing,
    and nothing else the kernel sees is skipped."""
    rng = np.random.default_rng(4)
    Z = rng.normal(size=(300, 3000)) / 5.0
    Z[rng.random(Z.shape) > 0.01] = 0.0
    Z[::7] = 0.0                                   # whole zero rows
    Z = Z.astype(dtype)
    for kind in KINDS:
        got = _block(kind, t(Z, "cuda"), t(Z, "cuda"), "float64")
        close(got, _block(kind, t(Z), t(Z), "float64"), err_msg=kind,
              **tol(dtype))


@pytest.mark.cuda
def test_kernel_block_refuses_bf16_on_the_card(cuda):
    """Since K1's bf16 instance exists the card takes bf16 (its blocks are
    held to the plain version in tests/test_torch_cuda_bf16.py): a bf16
    block comes back in bf16, while float16 and a bf16 accumulator are
    refused before any build or launch."""
    X = t(np.zeros((4, 3)), "cuda")
    before = rbf_block.kernel_block.launches
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        rbf_block.kernel_block(X.half(), X.half())
    with pytest.raises(TypeError, match="float32 or float64"):
        rbf_block.kernel_block(X.bfloat16(), X.bfloat16(),
                               acc_dtype="bfloat16")
    assert rbf_block.kernel_block.launches == before
    got = rbf_block.kernel_block(X.bfloat16(), X.bfloat16())
    assert got.dtype == torch.bfloat16 and bool(torch.all(got == 1.0))
    assert rbf_block.kernel_block.launches == before + 1
