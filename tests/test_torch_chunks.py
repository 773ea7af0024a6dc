"""The port's out-of-core layer: chunk sources, the chunked Theorem-4 core,
the ``*_beta_from_stats`` finalizers, and the driver's contracts.

``score_pass_core`` (on a healthy input and on one whose clean
factorization fails and takes the rescue) and both finalizers are held
against the JAX package at 1e-10 (f64). The driver's end-to-end parity with
the reference lives in tests/test_torch_sparse.py, beside the CSR cells,
so that the JAX fits share their compilations. The rest is port-only: the
chunked fit equals the in-memory one (1e-9, as tests/test_chunks.py),
source kinds are bit-identical, a one-shot iterator fails loudly, and the
unported samplers and solvers are refused with their ROADMAP item.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_common import F64_TOL, close

from repro.core.backends import score_pass_core as jscore_pass_core
from repro.core.nystrom import nystrom_beta_from_stats as jbeta
from repro.core.nystrom import \
    nystrom_regularized_beta_from_stats as jbeta_reg
from repro_torch.api import (ArrayChunkSource, CsrMatrix,
                             GeneratorChunkSource, MemmapChunkSource,
                             NotFittedError, RBFKernel, SketchConfig,
                             SketchedKRR, as_chunk_source, gather_rows)
from repro_torch.core.backends import score_pass_core
from repro_torch.core.nystrom import (nystrom_beta_from_stats,
                                      nystrom_regularized_beta_from_stats)

N, D, CHUNK = 300, 4, 64


def _problem(n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D))
    return X, np.sin(3.0 * X[:, 0]) + 0.2 * X[:, 1]


def _cfg(**kw):
    base = dict(kernel=RBFKernel(1.5), p=24, lam=1e-2, p_scores=32, seed=3,
                sampler="rls_fast", solver="nystrom_regularized",
                device="cpu")
    base.update(kw)
    return SketchConfig(**base)


@pytest.fixture()
def npy_pair(tmp_path):
    X, y = _problem()
    x_path, y_path = tmp_path / "X.npy", tmp_path / "y.npy"
    np.save(x_path, X)
    np.save(y_path, y)
    return os.fspath(x_path), os.fspath(y_path), X, y


# ----------------------------------------------------------------- sources

@pytest.mark.parametrize("n,valid", [(150, [64, 64, 22]), (128, [64, 64]),
                                     (10, [10])])
def test_array_source_fixed_shapes_and_tail(n, valid):
    X, y = _problem(n)
    src = ArrayChunkSource(X, y, chunk_rows=CHUNK)
    chunks = list(src.chunks())
    assert [c.n_valid for c in chunks] == valid
    assert all(c.X.shape == (CHUNK, D) and c.y.shape == (CHUNK,)
               for c in chunks)
    assert [c.start for c in chunks] == list(range(0, n, CHUNK))
    assert np.all(chunks[-1].X[valid[-1]:] == 0)
    assert np.all(chunks[-1].y[valid[-1]:] == 0)
    assert all(np.array_equal(a.X, b.X) for a, b in zip(chunks, src.chunks()))


def test_generator_memmap_and_array_sources_agree(npy_pair):
    x_path, y_path, X, y = npy_pair
    sizes = [0, 7, 50, 1, 100, 0, 142]

    def blocks():
        s = 0
        for k in sizes:
            yield X[s:s + k], y[s:s + k]
            s += k

    kinds = [ArrayChunkSource(X, y, CHUNK), MemmapChunkSource(x_path, y_path,
                                                              CHUNK),
             GeneratorChunkSource(blocks, CHUNK),
             as_chunk_source(x_path, y_path, CHUNK)]
    base = list(kinds[0].chunks())
    for src in kinds[1:]:
        got = list(src.chunks())
        assert [c.n_valid for c in got] == [c.n_valid for c in base]
        for a, b in zip(got, base):
            assert np.array_equal(a.X, b.X) and np.array_equal(a.y, b.y)


def test_gather_rows_dense_and_sparse_with_duplicates():
    X, y = _problem()
    X[X < 0.5] = 0.0
    idx = np.array([5, 299, 5, 0, 64, 63])
    for src in (ArrayChunkSource(X, y, CHUNK),
                as_chunk_source(lambda: iter([(X, y)]), chunk_rows=CHUNK)):
        assert np.array_equal(gather_rows(src, idx), X[idx])
    from repro_torch.api import SparseChunkSource
    sparse = SparseChunkSource(CsrMatrix.from_dense(X), y, chunk_rows=CHUNK)
    assert np.array_equal(gather_rows(sparse, idx), X[idx])
    with pytest.raises(IndexError, match="out of range"):
        gather_rows(sparse, [N])


def test_source_validation():
    X, y = _problem()
    with pytest.raises(ValueError, match="positive"):
        ArrayChunkSource(X, y, chunk_rows=0)
    with pytest.raises(ValueError, match="2-D"):
        ArrayChunkSource(X[:, 0], y)
    with pytest.raises(ValueError, match="floating"):
        ArrayChunkSource(X.astype(np.int64), y)
    with pytest.raises(ValueError, match="rows"):
        ArrayChunkSource(X, y[:-1])
    with pytest.raises(ValueError, match="zero-arg callable"):
        GeneratorChunkSource(iter([X]))
    with pytest.raises(ValueError, match="ambiguous"):
        as_chunk_source(ArrayChunkSource(X, y), y)
    with pytest.raises(ValueError, match="positive"):
        _cfg(chunk_rows=0)


# ------------------------------------------- the p×p core vs the reference

def _core_inputs(p=9, rescue=False):
    rng = np.random.default_rng(7)
    if rescue:
        # CᵀC indefinite by −1e-8 along one axis: the clean factor of
        # M = CᵀC + nλ·LcLcᵀ fails, the eps(f32)-scaled ridge covers it
        Lc = np.eye(p)
        CtC = np.diag(np.r_[np.ones(p - 1), -1e-8]).astype(np.float32)
        return Lc, CtC, 1e-12, 10
    A = rng.standard_normal((p, p))
    Lc = np.linalg.cholesky(A @ A.T + p * np.eye(p))
    C = rng.standard_normal((50, p))
    return Lc, C.T @ C, 1e-3, 50


@pytest.mark.parametrize("rescue", [False, True], ids=["healthy", "rescue"])
def test_score_pass_core_matches_reference(rescue):
    Lc, CtC, lam, n = _core_inputs(rescue=rescue)
    if rescue:
        M = torch.as_tensor(CtC, dtype=torch.float64) + n * lam * torch.eye(9)
        assert int(torch.linalg.cholesky_ex(M).info) != 0
    got = score_pass_core(torch.as_tensor(Lc), torch.as_tensor(CtC), lam, n)
    want = jscore_pass_core(jnp.asarray(Lc), jnp.asarray(CtC), lam, n)
    assert bool(torch.isfinite(got).all())
    close(got, want, **F64_TOL)


@pytest.mark.parametrize("regularized", [False, True],
                         ids=["nystrom", "nystrom_regularized"])
def test_beta_from_stats_matches_reference(regularized):
    rng = np.random.default_rng(8)
    p, n = 12, 200
    Z = rng.standard_normal((p, 3))
    W = np.exp(-((Z[:, None] - Z[None]) ** 2).sum(-1) / 2)
    C = rng.standard_normal((n, p))
    y = rng.standard_normal((n, 2))        # a multi-output y
    w = rng.uniform(0.5, 2.0, p)
    if regularized:
        Cs = C * w
        got = nystrom_regularized_beta_from_stats(
            *map(torch.as_tensor, (W, w, Cs.T @ Cs, Cs.T @ y)), n, 1e-2, 1e-3)
        want = jbeta_reg(*map(jnp.asarray, (W, w, Cs.T @ Cs, Cs.T @ y)), n,
                         1e-2, 1e-3)
    else:
        got = nystrom_beta_from_stats(
            *map(torch.as_tensor, (W, C.T @ C, C.T @ y[:, 0])), n, 1e-3)
        want = jbeta(*map(jnp.asarray, (W, C.T @ C, C.T @ y[:, 0])), n, 1e-3)
    close(got, want, **F64_TOL)


# ------------------------------------------------------------- the driver

@pytest.mark.parametrize("sampler,solver", [("rls_fast", "nystrom"),
                                            ("uniform", "exact")])
def test_chunked_fit_matches_in_memory_fit(sampler, solver):
    X, y = _problem()
    Xt, _ = _problem(40, seed=9)
    dense = SketchedKRR(_cfg(sampler=sampler, solver=solver)).fit(X, y)
    chunked = SketchedKRR(_cfg(sampler=sampler, solver=solver,
                               chunk_rows=CHUNK)).fit(X, y)
    if solver != "exact":
        assert torch.equal(dense.sample().idx, chunked.sample().idx)
    close(chunked.predict(Xt), dense.predict(Xt), rtol=1e-9, atol=1e-9)


def test_fit_is_bit_identical_across_source_kinds(npy_pair):
    x_path, y_path, X, y = npy_pair
    cfg = _cfg(chunk_rows=CHUNK)
    ref = SketchedKRR(cfg).fit(X, y)

    def blocks():
        for s in range(0, N, 100):
            yield X[s:s + 100], y[s:s + 100]

    for args in [(ArrayChunkSource(X, y, CHUNK),),
                 (MemmapChunkSource(x_path, y_path, CHUNK),),
                 (x_path, y_path), (blocks,)]:
        other = SketchedKRR(cfg).fit(*args)
        assert torch.equal(other.state().beta, ref.state().beta)


def test_one_shot_iterator_and_empty_or_target_free_sources_fail_loudly():
    X, y = _problem()
    gen = ((X[s:s + 100], y[s:s + 100]) for s in range(0, N, 100))
    with pytest.raises((ValueError, IndexError),
                       match="re-iterable|out of range|no rows"):
        SketchedKRR(_cfg()).fit(GeneratorChunkSource(lambda: gen, CHUNK))
    with pytest.raises(ValueError, match="no rows"):
        SketchedKRR(_cfg()).fit(GeneratorChunkSource(lambda: iter([]), CHUNK))
    with pytest.raises(ValueError, match="targets"):
        SketchedKRR(_cfg()).fit(ArrayChunkSource(X, chunk_rows=CHUNK))
    with pytest.raises(ValueError, match="drop the y"):
        SketchedKRR(_cfg()).fit(ArrayChunkSource(X, y, CHUNK), y)


def test_unported_and_unchunkable_entries_are_refused():
    X, y = _problem()
    with pytest.raises(ValueError, match="cannot run out-of-core"):
        SketchedKRR(_cfg(sampler="rls_exact", chunk_rows=CHUNK)).fit(X, y)
    with pytest.raises(ValueError, match="cannot run out-of-core"):
        SketchedKRR(_cfg(sampler="recursive_rls", chunk_rows=CHUNK)).fit(X, y)
    with pytest.raises(ValueError, match="does not support out-of-core"):
        SketchedKRR(_cfg(solver="dnc", chunk_rows=CHUNK)).fit(X, y)
    for field, name, item in [("solver", "distributed", 9),
                              ("backend", "sharded", 9)]:
        with pytest.raises(ValueError, match=f"ROADMAP item {item}"):
            _cfg(**{field: name, "chunk_rows": CHUNK})


def test_partial_fit_finalize_protocol():
    X, y = _problem(400)
    Xt, _ = _problem(20, seed=9)
    model = SketchedKRR(_cfg())
    with pytest.raises(NotFittedError, match="partial_fit"):
        model.finalize()
    model.partial_fit(X[:200], y[:200])
    with pytest.raises(NotFittedError, match="finalize"):
        model.predict(Xt)
    first = model.finalize().predict(Xt)
    again = model.finalize().predict(Xt)
    assert torch.equal(first, again)                  # finalize repeats
    second = model.partial_fit(X[200:], y[200:]).finalize().predict(Xt)
    assert bool(torch.isfinite(second).all())
    assert not torch.equal(first, second)             # new rows refine it
    for what in (lambda: model.risk(np.zeros(400), 0.1),
                 model.predict_train):
        with pytest.raises(RuntimeError, match="training factor"):
            what()
    exact = SketchedKRR(_cfg(solver="exact"))
    for s in range(0, 200, 64):
        exact.partial_fit(X[s:min(s + 64, 200)], y[s:min(s + 64, 200)])
    dense = SketchedKRR(_cfg(solver="exact")).fit(X[:200], y[:200])
    close(exact.finalize().predict(Xt), dense.predict(Xt), rtol=1e-9,
          atol=1e-9)
    # a new fit drops the partial state
    model.fit(X, y)
    assert model.state().approx is not None
