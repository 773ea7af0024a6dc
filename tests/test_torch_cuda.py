"""K2 ``rls_scores`` against its plain version, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU. This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda*.py

(K1 is in tests/test_torch_cuda_blocks.py, K3 in
tests/test_torch_cuda_sparse.py, K4 in tests/test_torch_cuda_attention.py,
the bf16 instances of K1-K3 in tests/test_torch_cuda_bf16.py.)
Tolerances (tests/_torch_common.py): 1e-10 at float64 and rtol 2e-4 on
float32 scores (K2's float32 build is 3xTF32 on the tensor cores, within
about 1.4e-5 of IEEE float32 at p = 2048 on an H100; it refuses p > 2048,
where its error was measured at 2.5e-5 and more). A launch that mixes the two dtypes (float32 data with
float64 accumulation, or the reverse) is held at the float32 tolerance: the
float32 side sets its error.
"""
import numpy as np
import pytest
import torch
from _torch_common import DTYPES, close, cuda, normal, t, tol  # noqa: F401

from repro_torch.kernels import ops, rls_scores

# (data dtype, accumulation dtype) of the mixed builds, reached through
# acc_dtype when Precision.accum_dtype differs from the data dtype
MIXED = [("float32", "float64"), ("float64", "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(300, 90), (257, 129), (8, 8), (5003, 600),
                                 (5003, 37), (5003, 2048), (5003, 4096),
                                 (5003, 8192)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rls_scores_matches_plain(cuda, dtype, n, p):
    """float32 runs on the tensor cores (3xTF32): p = 37 is ragged against
    the 32-deep slabs, the 256-column blocks and 16-byte copies. Past
    p = 2048 (``TF32X3_MAX_P``) the float32 build refuses, naming the
    float64-accumulating build, which then runs and matches."""
    B = normal((n, p), 2, "float64", p ** -0.5)
    M = np.linalg.inv(B.T @ B + n * 1e-3 * np.eye(p))
    B = B.astype(dtype)
    acc = None
    before = rls_scores.rls_scores_fused.launches
    if dtype == "float32" and p > rls_scores.TF32X3_MAX_P:
        with pytest.raises(ValueError, match='acc_dtype="float64"'):
            ops.rls_scores(t(B, "cuda"), t(M, "cuda"))
        assert rls_scores.rls_scores_fused.launches == before
        acc = "float64"
    got = ops.rls_scores(t(B, "cuda"), t(M, "cuda"), acc_dtype=acc)
    assert rls_scores.rls_scores_fused.launches == before + 1
    close(got, ops.rls_scores(t(B), t(M), acc_dtype=acc),
          **tol(dtype, scores=True))


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
