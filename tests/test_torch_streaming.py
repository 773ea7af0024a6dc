"""The port's ``streaming`` executor against the JAX package's.

Every protocol op of ``StreamingOps`` at ``block_rows`` = 64 (n = 301, so
the last tile is 45 rows, which the reference zero-pads and masks), on the
inputs of tests/_torch_ops_cases.py: ``(p, k)`` right-hand sides, the fused
``gram_matvec``, and the two score routes. Then the two-pass ``score_pass``
(scores and ‖B_i‖²), ``fast_ridge_leverage`` returning ``B=None``, a CSR X
(one direct block, equal to its dense rows' streamed ops), and
``SketchedKRR(backend="streaming")`` end to end with the reference's draws
injected. Tolerances: 1e-10 at f64
(tests/test_backends.py), the block / score bounds of
tests/test_kernels_pallas.py at f32.

The last test is the port's analogue of the reference's jaxpr audit: it
records every tile the executor evaluates and holds each to at most
``block_rows`` rows (W = k(Z, Z) aside).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_common import F64_TOL, close, tol
from _torch_ops_cases import DIM, KERNELS, LAM, N, inputs, kernels

from repro.api import SketchConfig as JConfig
from repro.api import SketchedKRR as JKRR
from repro.core import RBFKernel as JRBF
from repro.core import ops_for as jops_for
from repro.core.leverage import draw_landmarks as jdraw_landmarks
from repro_torch.api import (ColumnSample, CsrMatrix, RBFKernel,
                             SketchConfig, SketchedKRR)
from repro_torch.core import backends as tb
from repro_torch.core.leverage import fast_ridge_leverage
from repro_torch.kernels import ops as kops

BLOCK = 64


def _run(ops, arr, X, Z, v, u, B, idx):
    """Every protocol op of one executor, with (p, k) and (n, k) sides."""
    X, Z, v, u, B = arr(X), arr(Z), arr(v), arr(u), arr(B)
    stack = jnp.stack if isinstance(v, jax.Array) else torch.stack
    V, U = stack([v, -0.5 * v + 1.0], 1), stack([u, 2.0 * u], 1)
    return dict(cross=ops.cross(X, Z), columns=ops.columns(X, arr(idx)),
                matvec=ops.matvec(X, Z, v), matvec_k=ops.matvec(X, Z, V),
                rmatvec=ops.rmatvec(X, Z, u), rmatvec_k=ops.rmatvec(X, Z, U),
                gram_matvec=ops.gram_matvec(X, Z, v),
                gram_matvec_k=ops.gram_matvec(X, Z, V),
                leverage_scores=ops.leverage_scores(B, LAM, N),
                scores_given_gram=ops.scores_given_gram(B, B.T @ B, LAM, N))


@functools.lru_cache(maxsize=None)
def _reference_ops(name, dtype):
    ops = jops_for(kernels(name)[0], "streaming", BLOCK)
    out = jax.jit(lambda *a: _run(ops, lambda x: x, *a))(
        *(jnp.asarray(a) for a in inputs(name, dtype)))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name,dtype", [(k, "float64") for k in
                                        sorted(KERNELS)]
                         + [("rbf", "float32")])
def test_streaming_ops_match_reference(name, dtype):
    ops = tb.ops_for(kernels(name)[1], "streaming", device="cpu",
                     block_rows=BLOCK)
    assert isinstance(ops, tb.StreamingOps) and ops.block_rows == BLOCK
    got = _run(ops, torch.as_tensor, *inputs(name, dtype))
    want = _reference_ops(name, dtype)
    for op, value in got.items():
        assert value.dtype == getattr(torch, dtype), op
        assert tuple(value.shape) == want[op].shape, op
        close(value, want[op], err_msg=op,
              **tol(dtype, scores="scores" in op))


# ----------------------------------------------------------- score pass

def _score_inputs(dtype):
    """X and 37 distinct landmarks (a repeated one makes W singular, and
    the 1/jitter amplification would test the problem, not the code)."""
    X, *_ = inputs("rbf", dtype)
    return X, np.random.default_rng(5).choice(N, 37, replace=False)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_score_pass_matches_reference(dtype):
    X, idx = _score_inputs(dtype)
    jker, tker = kernels("rbf")
    jops = jops_for(jker, "streaming", BLOCK)
    want = jax.jit(lambda x, i: jops.score_pass(x, i, LAM, 1e-10))(
        jnp.asarray(X), jnp.asarray(idx))
    ops = tb.ops_for(tker, "streaming", device="cpu", block_rows=BLOCK)
    got = ops.score_pass(torch.as_tensor(X), torch.as_tensor(idx), LAM, 1e-10)
    for g, w in zip(got, want):
        assert g.shape == (N,) and g.dtype == getattr(torch, dtype)
        close(g, w, **tol(dtype, scores=True))


def test_fast_ridge_leverage_streams_without_b():
    X, idx = _score_inputs("float64")
    _, tker = kernels("rbf")
    Xt, it = torch.as_tensor(X), torch.as_tensor(idx)
    streamed = fast_ridge_leverage(
        tker, Xt, LAM, 37, idx=it,
        ops=tb.ops_for(tker, "streaming", device="cpu", block_rows=BLOCK))
    dense = fast_ridge_leverage(tker, Xt, LAM, 37, idx=it,
                                ops=tb.ops_for(tker, "torch", device="cpu"))
    assert streamed.B is None and dense.row_sq is None
    close(streamed.scores, dense.scores, **F64_TOL)
    close(streamed.row_sq, torch.sum(dense.B * dense.B, dim=1), **F64_TOL)
    close(streamed.d_eff_estimate, dense.d_eff_estimate, **F64_TOL)


def test_csr_rows_are_one_block_and_match_dense(monkeypatch):
    """A CSR X is one direct block (no row tiles), and every op, the score
    pass included, equals the dense rows' streamed ops, which the tests
    above hold against the reference."""
    X, Z, v, u, _, _ = inputs("rbf", "float64")
    _, idx = _score_inputs("float64")
    X = X.copy()
    # a fifth of the values zero: at d = 5 a sparser X has many zero rows,
    # equal landmarks among them, and a singular W whose 1/jitter
    # amplification would test the data, not the code
    X[np.random.default_rng(6).random(X.shape) > 0.8] = 0.0
    _, tker = kernels("rbf")
    ops = tb.ops_for(tker, "streaming", device="cpu", block_rows=BLOCK)
    csr = CsrMatrix.from_dense(X).cast()
    Xt, Zt, vt, ut, it = map(torch.as_tensor, (X, Z, v, u, idx))
    rows = []
    tile = tb.HopperOps.cross

    def recording(self, X_test, Z_, *, prepared=None):
        rows.append(X_test.shape[0])
        return tile(self, X_test, Z_, prepared=prepared)

    monkeypatch.setattr(tb.HopperOps, "cross", recording)
    for call in [lambda a: ops.cross(a, Zt), lambda a: ops.matvec(a, Zt, vt),
                 lambda a: ops.rmatvec(a, Zt, ut),
                 lambda a: ops.gram_matvec(a, Zt, vt),
                 lambda a: ops.score_pass(a, it, LAM, 1e-10)]:
        rows.clear()
        got = call(csr)
        assert N in rows and max(rows) == N         # one whole block
        for g, w in zip(*(((x,) if isinstance(x, torch.Tensor) else x)
                          for x in (got, call(Xt)))):
            close(g, w, **F64_TOL)


# ------------------------------------------------------------ end to end

def test_streaming_fit_matches_reference():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N + 40, DIM))
    y = np.sin(3.0 * X[:, 0]) + 0.2 * X[:, 1]
    # the sketch of tests/test_torch_iterative.py at the same shapes
    common = dict(p=37, lam=1e-3, seed=3, block_rows=BLOCK,
                  backend="streaming", solver="nystrom_regularized")
    ref = JKRR(JConfig(kernel=JRBF(1.5), **common)).fit(
        jnp.asarray(X[:N]), jnp.asarray(y[:N]))
    key_sample, _ = jax.random.split(jax.random.key(common["seed"]))
    kd, _ = jax.random.split(key_sample)
    landmarks = jdraw_landmarks(kd, jnp.full((N,), 1.0 / N), 37, True)
    sample = ColumnSample(*(torch.as_tensor(np.array(a))
                            for a in ref.sample()))
    kops.reset_launch_counts()
    model = SketchedKRR(SketchConfig(kernel=RBFKernel(1.5), device="cpu",
                                     **common)).fit(
        X[:N], y[:N], sample=sample,
        score_landmarks=torch.as_tensor(np.array(landmarks)))
    assert model.ops().name == "streaming"
    close(model.scores(), ref.scores(), **F64_TOL)
    close(model.state().beta, ref.state().beta, **F64_TOL)
    close(model.predict(X[N:]), ref.predict(jnp.asarray(X[N:])), **F64_TOL)
    assert sum(kops.launch_counts().values()) == 0   # CPU: plain versions


def test_streamed_tiles_stay_within_block_rows(monkeypatch):
    """No tile of the streamed ops has more than block_rows rows: every
    tile goes through HopperOps.cross, which is recorded here."""
    X, Z, v, u, _, idx = inputs("rbf", "float64")
    _, tker = kernels("rbf")
    rows = []
    tile = tb.HopperOps.cross

    def recording(self, X_test, Z_, *, prepared=None):
        rows.append((X_test.shape[0], Z_.shape[0]))
        return tile(self, X_test, Z_, prepared=prepared)

    monkeypatch.setattr(tb.HopperOps, "cross", recording)
    ops = tb.ops_for(tker, "streaming", device="cpu", block_rows=BLOCK)
    Xt, Zt = torch.as_tensor(X), torch.as_tensor(Z)
    idxt = torch.as_tensor(idx)
    calls = [lambda: ops.score_pass(Xt, idxt, LAM, 1e-10),
             lambda: ops.matvec(Xt, Zt, torch.as_tensor(v)),
             lambda: ops.rmatvec(Xt, Zt, torch.as_tensor(u)),
             lambda: ops.gram_matvec(Xt, Zt, torch.as_tensor(v))]
    for call in calls:
        rows.clear()
        call()
        tiles = [r for r in rows if r != (len(idx), len(idx))]  # W aside
        assert len(tiles) >= -(-N // BLOCK)
        assert max(r for r, _ in tiles) <= BLOCK
        assert sum(r for r, _ in tiles) in (N, 2 * N)   # one or two passes
