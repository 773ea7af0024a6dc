"""The bf16 instances of K1 ``kernel_block``, K2 ``rls_scores`` and K3
``sparse_cross`` against their plain versions, and the quantized serve path
through them, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU; no JAX
import (run with ``--noconftest -m cuda``, see tests/test_torch_cuda.py).
Tolerances, element by element, against the plain version on the same
bf16 inputs (one bf16 step beyond the float32 sum's order):

* K1 and K3: |got − plain| ≤ 2⁻⁷·|plain| + 2e-5 (the float32 block atol).
  K3, as its plain version and the reference's ``sparse_kernel_block``,
  rounds ‖x‖² and the cross product to bf16 before the rbf or poly
  epilogue.
* K2: rtol 2⁻⁷ + 2e-4, atol 1e-6.
* the quantized ``predict_batched`` on the card against the ``torch``
  backend's on the card: 2⁻⁷·Σ_j |K_ij β_j| + 1e-6, one bf16 step of each
  term.

All are inside the reference suite's bf16 bars (atol 3e-2 on K1 blocks,
rtol and atol 5e-2 end to end).
"""
import numpy as np
import pytest
import torch
from _torch_common import close, cuda, normal  # noqa: F401

from repro_torch.api import Precision, RBFKernel, SketchConfig, SketchedKRR
from repro_torch.data import CsrMatrix
from repro_torch.kernels import ops, rbf_block, rls_scores, sparse_block

STEP = 2.0 ** -7
KINDS = {"rbf": dict(bandwidth=1.3), "linear": {},
         "poly": dict(degree=3, scale=1.0, offset=0.7)}
# d odd (2-byte rows, no cp.async), d = 90 (4-byte, the MSD rows), d a
# multiple of 8 (16-byte); n and p ragged against the 128 x 128 tiles
SHAPES = [(300, 90, 17), (257, 129, 90), (8, 8, 1), (1031, 2048, 90),
          (300, 257, 4096), (1, 37, 90)]


def _bf(a, device="cuda"):
    return torch.as_tensor(np.asarray(a, np.float32)).to(device=device,
                                                        dtype=torch.bfloat16)


def _assert_bf16_close(got, want):
    """|got − want| ≤ 2⁻⁷|want| + 2e-5."""
    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    bound = STEP * want.abs() + 2e-5
    err = (got - want).abs()
    assert bool(torch.all(err <= bound)), float((err / bound).max())


def _block(kind, X, Z, acc_dtype=None):
    fn = {"rbf": ops.rbf_block, "linear": ops.linear_block,
          "poly": ops.poly_block}[kind]
    return fn(X, Z, acc_dtype=acc_dtype, **KINDS[kind])


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,d", SHAPES)
def test_kernel_block_bf16_matches_plain(cuda, n, p, d):
    """bf16 X and Z; float32 accumulation on the bf16 tensor cores, and
    float64 on the FP64 ones; the block in bf16."""
    X = normal((n, d), 0, "float32", d ** -0.5)
    Z = normal((p, d), 1, "float32", d ** -0.5)
    for acc in (None, "float64"):
        for kind in KINDS:
            before = rbf_block.kernel_block.launches
            got = _block(kind, _bf(X), _bf(Z), acc)
            assert rbf_block.kernel_block.launches == before + 1, kind
            assert got.dtype == torch.bfloat16 and got.shape == (n, p), kind
            _assert_bf16_close(got, _block(kind, _bf(X, "cpu"),
                                           _bf(Z, "cpu"), acc))


@pytest.mark.cuda
def test_kernel_block_bf16_on_sparse_rows_matches_plain(cuda):
    """W = k(Z, Z) over bf16 rows that are 99 % zeros, as the sparse
    path's densified landmarks are: the 16-value k-steps that the bf16
    build skips change nothing."""
    rng = np.random.default_rng(4)
    Z = rng.normal(size=(300, 3000)) / 5.0
    Z[rng.random(Z.shape) > 0.01] = 0.0
    Z[::7] = 0.0
    for kind in KINDS:
        _assert_bf16_close(_block(kind, _bf(Z), _bf(Z)),
                           _block(kind, _bf(Z, "cpu"), _bf(Z, "cpu")))


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(1031, 37), (300, 600), (5003, 2048),
                                 (8, 8), (777, 4096)])
def test_rls_scores_bf16_matches_plain(cuda, n, p):
    """bf16 B against M in the accumulation dtype: two TF32 products on
    the tensor cores (float32), SIMT fma (float64); p = 37 (2-byte rows),
    600 (4-byte), 2048 and 4096 (16-byte; the float32 build's p limit does
    not bind the bf16 one)."""
    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, p)) / np.sqrt(p)
    Bb = _bf(B, "cpu")
    G = Bb.double().T @ Bb.double()
    M = torch.linalg.inv(G + n * 1e-3 * torch.eye(p, dtype=torch.float64))
    for acc in (None, "float64"):
        before = rls_scores.rls_scores_fused.launches
        got = ops.rls_scores(Bb.cuda(), M.cuda(), acc_dtype=acc)
        assert rls_scores.rls_scores_fused.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == (n,)
        close(got.float(), ops.rls_scores(Bb, M, acc_dtype=acc).float(),
              rtol=STEP + 2e-4, atol=1e-6, err_msg=str(acc))


def _csr(n, d, seed=0):
    """n CSR rows over d columns, 0-40 bf16 values each (every 7th row
    empty), with 11 NaN padding slots past indptr[-1]."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 41, n)
    lengths[::7] = 0
    lengths = np.minimum(lengths, d)
    cols = [np.sort(rng.choice(d, k, replace=False)) for k in lengths]
    indices = np.concatenate(cols + [np.zeros(11, np.int64)]).astype(np.int32)
    data = np.concatenate([rng.standard_normal(int(lengths.sum())) / 5.0,
                           np.full(11, np.nan)]).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return CsrMatrix(data, indices, indptr, d)


def _sparse(kind, X, Z, acc_dtype="float32", prepared=None):
    return ops.sparse_block(X.data, X.indices, X.indptr, Z, kind=kind,
                            acc_dtype=acc_dtype, prepared=prepared,
                            **KINDS[kind])


@pytest.mark.cuda
@pytest.mark.parametrize("acc", ["float32", "float64"])
@pytest.mark.parametrize("landmark_rows", [False, True])
def test_sparse_cross_bf16_matches_plain(cuda, acc, landmark_rows):
    """bf16 values and landmarks, accumulated in ``acc``: against dense Z
    (every column hot or listed in full) and against densified landmark
    rows (most columns listed, a few hot), as the sparse path's Z. Both
    keep |x|² and |z|² of order 1, so the rbf block spans (0, 1]."""
    n, p, d = 1031, 600, 3000
    X = _csr(n, d)
    if landmark_rows:
        Z = _csr(p, d, seed=1).todense().numpy()
        Z = np.nan_to_num(Z)
    else:
        Z = normal((p, d), 1, "float32", d ** -0.5)
    Xc = X.cast(torch.bfloat16, "cuda")
    Xh = X.cast(torch.bfloat16)
    Zc, Zh = _bf(Z), _bf(Z, "cpu")
    prep = ops.sparse_landmarks(Zc, torch.bfloat16, acc_dtype=acc)
    for kind in KINDS:
        before = sparse_block.sparse_cross.launches
        got = _sparse(kind, Xc, Zc, acc, prepared=prep)
        assert sparse_block.sparse_cross.launches == before + 1, kind
        assert got.dtype == torch.bfloat16 and got.shape == (n, p), kind
        want = _sparse(kind, Xh, Zh, acc)
        if kind == "rbf":
            assert float(want.float().mean()) > 0.1
        _assert_bf16_close(got, want)


@pytest.mark.cuda
def test_quantized_predict_batched_on_the_card(cuda):
    """A float32 fit served in bf16 on the card: one bf16 K1 launch a
    batch, float32 predictions, against the ``torch`` backend serving the
    same β and landmarks on the card."""
    X = normal((4000, 90), 0, "float32", 90 ** -0.5)
    y = np.sin(3.0 * X[:, 0] * np.sqrt(90)).astype(np.float32)
    Xt = normal((777, 90), 1, "float32", 90 ** -0.5)
    cfg = SketchConfig(RBFKernel(1.0), p=256, lam=1e-4, seed=0,
                       precision=Precision(serve_dtype="bf16"))
    model = SketchedKRR(cfg).fit(X, y)
    plain = SketchedKRR(cfg.replace(backend="torch")).import_serving_state(
        model.export_serving_state())
    ops.reset_launch_counts()
    got = model.predict_batched(Xt, 256)
    assert ops.launch_counts()["kernel_block"] == 4
    want = plain.predict_batched(Xt, 256)
    assert got.dtype == torch.float32 and got.is_cuda
    st = model.export_serving_state()
    K = ops.rbf_block(torch.as_tensor(Xt), st.landmarks.cpu(), bandwidth=1.0)
    scale = K.double().abs() @ st.beta.cpu().double().abs()
    err = (got.double().cpu() - want.double().cpu()).abs()
    assert bool(torch.all(err <= STEP * scale + 1e-6))
