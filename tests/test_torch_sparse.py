"""The port's sparse (CSR) path against the JAX package: ``CsrMatrix``, the
row helpers, the plain K3 block, and the chunked fit → predict end to end
(CSR × {nystrom, nystrom_regularized}, and one dense ``chunk_rows`` cell,
in one module so that the JAX reference fits share their compilations).

The plain version of K3 (what a CPU tensor takes) is held against both JAX
routes: the XLA scan reference across kind × dtype on a matrix with empty
rows and padding slots past ``indptr[-1]``, and the Pallas body in
interpret mode. The end-to-end cells inject the reference's draws (its
Theorem-3 column sample, and the score landmarks re-drawn with the
driver's own key splits) into the port's fit. Tolerances: 1e-10 at f64
(tests/test_backends.py), 1e-5 at f32 (tests/test_sparse.py). Port-only
checks: bit identity across source kinds, ``partial_fit`` on one chunk,
and the refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from _torch_common import F64_TOL, close, t

from repro.api import SketchConfig as JConfig
from repro.api import SketchedKRR as JKRR
from repro.core import RBFKernel as JRBF
from repro.core.leverage import draw_landmarks as jdraw_landmarks
from repro.data.sparse import CsrMatrix as JCsr
from repro.kernels import sparse_block as jsb
from repro_torch.api import (CsrMatrix, RBFKernel, SketchConfig, SketchedKRR,
                             SparseChunkSource, as_chunk_source)
from repro_torch.core import kernels as tk
from repro_torch.core.backends import ops_for
from repro_torch.data import rcv1_like
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sparse_block as tsb

N, D, P = 157, 37, 11            # not aligned to any tile, as in test_sparse
KINDS = {"rbf": dict(bandwidth=1.7), "linear": {},
         "poly": dict(degree=3, scale=2.0, offset=0.5)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "float64": F64_TOL}


def _padded_csr(dtype="float64", seed=0):
    """N × D rows at 15 % density (every 10th row empty) with 9 padding
    slots past indptr[-1], as numpy arrays, plus Z (P, D)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    X[rng.random(X.shape) > 0.15] = 0.0
    X[::10] = 0.0
    c = CsrMatrix.from_dense(X)
    data = np.concatenate([c.data, rng.normal(size=9)]).astype(dtype)
    indices = np.concatenate([c.indices, rng.integers(0, D, 9)]).astype(
        np.int32)
    Z = rng.normal(size=(P, D)).astype(dtype)
    return data, indices, c.indptr, Z, X.astype(dtype)


# ------------------------------------------------------------ CsrMatrix

def test_csr_roundtrips_gather_and_validation():
    data, indices, indptr, _, X = _padded_csr()
    csr = CsrMatrix(data, indices, indptr, D)
    assert csr.shape == (N, D) and csr.nnz == data.shape[0]
    close(csr.todense(), X, rtol=0, atol=0)
    close(CsrMatrix.from_dense(X).todense(), X, rtol=0, atol=0)
    scipy_csr = CsrMatrix.from_scipy(sp.csr_matrix(X))
    close(scipy_csr.todense(), X, rtol=0, atol=0)
    idx = np.array([3, 0, 3, N - 1, 10])          # duplicates, empty row
    close(csr[idx], X[idx], rtol=0, atol=0)
    close(csr[-1], X[-1], rtol=0, atol=0)
    close(csr[torch.as_tensor(idx)], X[idx], rtol=0, atol=0)
    # the gather agrees with the reference's
    close(csr[idx], JCsr(data, indices, indptr, D)[jnp.asarray(idx)],
          rtol=0, atol=0)
    c32 = csr.cast(torch.float32)
    assert c32.dtype == torch.float32 and c32.indices.dtype == torch.int32
    assert csr.astype(np.float32).indptr is csr.indptr
    with pytest.raises(TypeError, match="row slicing"):
        csr[2:5]
    with pytest.raises(IndexError, match="out of range"):
        csr[[N]]
    with pytest.raises(ValueError, match="column ids"):
        CsrMatrix(data, np.where(indices == indices[0], D, indices),
                  indptr, D).validate()
    with pytest.raises(ValueError, match="indptr"):
        CsrMatrix(data, indices, indptr[::-1].copy(), D).validate()
    with pytest.raises(ValueError, match="2-D"):
        CsrMatrix.from_dense(np.zeros(5))


def test_row_ids_sqnorms_and_tile_match_reference():
    data, indices, indptr, _, X = _padded_csr()
    rows = tsb.sparse_row_ids(torch.as_tensor(indptr), data.shape[0])
    want = jsb.sparse_row_ids(jnp.asarray(indptr), data.shape[0])
    close(rows, want, rtol=0, atol=0)
    assert int(rows[-1]) == N                       # padding → row n_rows
    close(tsb.sparse_row_ids(torch.tensor([0, 2, 2, 5], dtype=torch.int32),
                             8), [0, 0, 2, 2, 2, 3, 3, 3], rtol=0, atol=0)
    sq = tsb.sparse_row_sqnorms(torch.as_tensor(data), torch.as_tensor(indptr))
    close(sq, jsb.sparse_row_sqnorms(jnp.asarray(data), jnp.asarray(indptr)),
          **F64_TOL)
    close(sq, np.sum(X * X, axis=1), **F64_TOL)
    for nnz, n in [(200, 48), (5000, 48), (7, 3), (100_000, 4096)]:
        assert tsb.sparse_tile(nnz, n) == jsb.sparse_tile(nnz, n)


# ----------------------------------------------- the plain K3 vs the JAX

@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_sparse_block_matches_reference_scan(kind, dtype):
    data, indices, indptr, Z, X = _padded_csr(dtype)
    got = kops.sparse_block(torch.as_tensor(data), torch.as_tensor(indices),
                            torch.as_tensor(indptr), torch.as_tensor(Z),
                            kind=kind, **KINDS[kind])
    want = jsb.sparse_kernel_block(jnp.asarray(data), jnp.asarray(indices),
                                   jnp.asarray(indptr), jnp.asarray(Z),
                                   kind=kind, **KINDS[kind])
    assert got.dtype == getattr(torch, dtype) and got.shape == (N, P)
    close(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_sparse_cross_matches_pallas_interpret(dtype):
    data, indices, indptr, Z, _ = _padded_csr(dtype, seed=1)
    got = kops.sparse_block(torch.as_tensor(data), torch.as_tensor(indices),
                            torch.as_tensor(indptr), torch.as_tensor(Z),
                            kind="linear")
    want = jsb.sparse_cross(jnp.asarray(data), jnp.asarray(indices),
                            jnp.asarray(indptr), jnp.asarray(Z),
                            use_pallas=True, interpret=True)
    close(got, want, **TOL[dtype])


def test_all_zero_matrix_and_padded_tail_rows_give_k_of_zero():
    Z = torch.as_tensor(np.random.default_rng(2).normal(size=(4, 6)))
    zero = torch.zeros(6, dtype=torch.float64)
    empty = CsrMatrix(np.zeros(3), np.zeros(3, np.int32),
                      np.zeros(6, np.int32), 6).cast()
    for kind, kernel in [("linear", tk.LinearKernel()),
                         ("rbf", tk.RBFKernel(1.3)),
                         ("poly", tk.PolynomialKernel(3, 2.0, 0.5))]:
        params = {k: getattr(kernel, k) for k in
                  ("bandwidth", "degree", "scale", "offset")
                  if hasattr(kernel, k)}
        got = kops.sparse_block(empty.data, empty.indices, empty.indptr, Z,
                                kind=kind, **params)
        close(got, kernel.gram(zero[None].expand(5, 6), Z), rtol=0, atol=0)
        close(got, jsb.sparse_kernel_block(
            jnp.zeros(3), jnp.zeros(3, jnp.int32), jnp.zeros(6, jnp.int32),
            jnp.asarray(Z.numpy()), kind=kind, **params), **F64_TOL)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(10, 6)) * (rng.random((10, 6)) < 0.4)
    tail = list(SparseChunkSource(CsrMatrix.from_dense(X),
                                  chunk_rows=8).chunks())[-1]
    assert tail.n_valid == 2
    block = tk.RBFKernel(1.3).gram(tail.X.cast(), Z)
    close(block[2:], tk.RBFKernel(1.3).gram(zero[None], Z).expand(6, 4),
          rtol=0, atol=0)


def test_kernels_and_backends_dispatch_csr():
    data, indices, indptr, Z, X = _padded_csr()
    csr = CsrMatrix(data, indices, indptr, D).cast()
    Zt, Xt = torch.as_tensor(Z), torch.as_tensor(X)
    for kernel in (tk.LinearKernel(), tk.RBFKernel(1.7),
                   tk.PolynomialKernel(3, 2.0, 0.5)):
        close(kernel.diag(csr), kernel.diag(Xt), **F64_TOL)
        for backend in ("torch", "hopper"):
            ops = ops_for(kernel, backend, device="cpu")
            close(ops.cross(csr, Zt), ops.cross(Xt, Zt), **F64_TOL)
            close(ops.matvec(csr, Zt, Zt[:, 0]), ops.matvec(Xt, Zt, Zt[:, 0]),
                  **F64_TOL)
    with pytest.raises(NotImplementedError, match="right-hand"):
        tk.RBFKernel().gram(Xt, csr)
    for call in (lambda: tk.BernoulliKernel().gram(csr, Zt[:, :1]),
                 lambda: tk.BernoulliKernel().diag(csr),
                 lambda: ops_for(tk.BernoulliKernel(), "hopper",
                                 device="cpu").cross(csr, Zt[:, :1])):
        with pytest.raises(NotImplementedError, match="no sparse"):
            call()


# ------------------------------------------------- end to end vs the JAX

def _problem():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(301 + 40, 23))
    X[rng.random(X.shape) > 0.2] = 0.0
    y = np.sin(X @ rng.normal(size=23)) + 0.1 * rng.normal(size=301 + 40)
    return X[:301], y[:301], X[301:]


COMMON = dict(p=24, p_scores=32, lam=1e-3, seed=3, sampler="rls_fast",
              chunk_rows=128)


@pytest.fixture(scope="module", params=[("csr", "nystrom"),
                                        ("csr", "nystrom_regularized"),
                                        ("dense", "nystrom_regularized")],
                ids=lambda p: "-".join(p))
def reference_chunked_fit(request):
    """The reference's chunked fit (xla, f64, 3 chunks of 128 rows) of CSR
    or dense rows, and its draws: the column sample, and the score
    landmarks re-drawn from the driver's own key splits."""
    layout, solver = request.param
    X, y, Xt = _problem()
    Xin = JCsr.from_dense(X) if layout == "csr" else jnp.asarray(X)
    ref = JKRR(JConfig(kernel=JRBF(2.0), solver=solver, backend="xla",
                       **COMMON)).fit(Xin, jnp.asarray(y))
    key_sample, _ = jax.random.split(jax.random.key(COMMON["seed"]))
    kd, _ = jax.random.split(key_sample)
    landmarks = jdraw_landmarks(kd, jnp.full((301,), 1.0 / 301),
                                COMMON["p_scores"], True)
    return dict(layout=layout, solver=solver, ref=ref, X=X, y=y, Xt=Xt,
                sample=[np.asarray(a) for a in ref.sample()],
                landmarks=np.asarray(landmarks),
                want=np.asarray(ref.predict(jnp.asarray(Xt))))


def test_chunked_fit_predict_matches_reference(reference_chunked_fit):
    r = reference_chunked_fit
    to_port = CsrMatrix.from_dense if r["layout"] == "csr" else np.asarray
    kops.reset_launch_counts()
    for backend in ("torch", "hopper"):
        cfg = SketchConfig(kernel=RBFKernel(2.0), solver=r["solver"],
                           backend=backend, device="cpu", **COMMON)
        model = SketchedKRR(cfg).fit(to_port(r["X"]), r["y"],
                                     sample=r["sample"],
                                     score_landmarks=r["landmarks"])
        close(model.scores(), r["ref"].scores(), **F64_TOL)
        close(model.state().beta, r["ref"].state().beta, **F64_TOL)
        close(model.predict(CsrMatrix.from_dense(r["Xt"])), r["want"],
              **F64_TOL)
        close(model.predict(r["Xt"]), r["want"], **F64_TOL)
    assert kops.launch_counts() == {"kernel_block": 0, "rls_scores": 0,
                                    "sparse_cross": 0,
                                    "flash_attention": 0}


def test_csr_fits_are_bit_identical_across_source_kinds():
    X, y, Xt = _problem()
    cfg = SketchConfig(kernel=RBFKernel(2.0), solver="nystrom_regularized",
                       device="cpu", **COMMON)
    csr = CsrMatrix.from_dense(X)
    fits = [SketchedKRR(cfg).fit(csr, y),
            SketchedKRR(cfg).fit(sp.csr_matrix(X), y),
            SketchedKRR(cfg).fit(SparseChunkSource(csr, y, chunk_rows=128))]
    base = fits[0].predict(Xt)
    for other in fits[1:]:
        assert torch.equal(other.state().beta, fits[0].state().beta)
        assert torch.equal(other.predict(Xt), base)
    # the landmark draw is the in-memory sampler's: same seed, same streams
    dense = SketchedKRR(cfg.replace(chunk_rows=None)).fit(X, y)
    assert torch.equal(dense.sample().idx, fits[0].sample().idx)
    close(dense.predict(Xt), base, rtol=1e-9, atol=1e-9)


def test_csr_partial_fit_on_one_chunk_matches_dense_fit():
    X, y, Xt = _problem()
    cfg = SketchConfig(kernel=RBFKernel(2.0), solver="nystrom", device="cpu",
                       **{**COMMON, "chunk_rows": None})
    pf = SketchedKRR(cfg).partial_fit(CsrMatrix.from_dense(X), y).finalize()
    dense = SketchedKRR(cfg).fit(X, y)
    assert torch.equal(pf.sample().idx, dense.sample().idx)
    close(pf.predict(Xt), dense.predict(Xt), rtol=1e-9, atol=1e-9)


def test_sparse_refusals():
    X, y, Xt = _problem()
    csr = CsrMatrix.from_dense(X)
    cfg = SketchConfig(kernel=RBFKernel(2.0), device="cpu", **COMMON)
    with pytest.raises(ValueError, match="buffers raw rows"):
        SketchedKRR(cfg.replace(solver="exact")).fit(csr, y)
    with pytest.raises(ValueError, match="buffers raw rows"):
        SketchedKRR(cfg.replace(solver="exact")).partial_fit(csr, y)
    with pytest.raises(TypeError, match="needs targets"):
        SketchedKRR(cfg).fit(csr)
    with pytest.raises(TypeError, match="densified"):
        as_chunk_source(sp.csr_matrix(X), y)
    model = SketchedKRR(cfg).fit(csr, y)
    with pytest.raises(TypeError, match="predict_batched"):
        model.predict_batched(CsrMatrix.from_dense(Xt))
    with pytest.raises(TypeError, match="dense arrays"):
        SparseChunkSource(X, y)
    with pytest.raises(ValueError, match="y has"):
        SparseChunkSource(csr, y[:-1])


def test_sparse_chunk_source_shapes_padding_and_replay():
    X, y, _ = _problem()
    src = SparseChunkSource(CsrMatrix.from_dense(X), y, chunk_rows=128)
    chunks = list(src.chunks())
    assert [c.n_valid for c in chunks] == [128, 128, 45]
    assert [c.start for c in chunks] == [0, 128, 256]
    assert all(c.X.shape == (128, 23) and c.X.nnz == src.nnz_cap
               for c in chunks)
    tail = chunks[-1].X
    assert np.all(tail.indptr[45:] == tail.indptr[45])   # tail rows own none
    assert np.all(tail.data[tail.indptr[-1]:] == 0)      # surplus slots
    assert np.all(chunks[-1].y[45:] == 0)
    for a, b in zip(chunks, src.chunks()):
        assert np.array_equal(a.X.data, b.X.data)
        assert np.array_equal(a.X.indptr, b.X.indptr)


def test_rcv1_like_rows():
    a, b = rcv1_like(500, dim=300, nnz_per_row=12, seed=5), \
        rcv1_like(500, dim=300, nnz_per_row=12, seed=5)
    assert np.array_equal(a["data"], b["data"])
    csr = CsrMatrix(a["data"], a["indices"], a["indptr"], 300).validate()
    lengths = np.diff(a["indptr"])
    assert lengths.min() >= 1 and 8 <= lengths.mean() <= 16
    for i in range(0, 500, 37):
        cols = a["indices"][a["indptr"][i]:a["indptr"][i + 1]]
        assert np.all(np.diff(cols) > 0)                 # sorted, distinct
    assert np.all(a["data"] > 0)
    close(tk.LinearKernel().diag(csr.cast()), np.ones(500), rtol=1e-12,
          atol=1e-12)
    assert abs(np.var(a["f_star"]) - 1.0) < 1e-12
    assert a["y"].shape == a["f_star"].shape == (500,)
    # Zipf: the most frequent column is far above the mean frequency
    counts = np.bincount(a["indices"], minlength=300)
    assert counts.max() > 10 * counts.mean()
    assert t(a["data"]).dtype == torch.float64
