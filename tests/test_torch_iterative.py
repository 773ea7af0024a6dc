"""The port's iterative solvers against the JAX package: ``falkon_pcg`` and
``eigenpro``, the PCG engine and the EigenPro preconditioner beneath them,
and the multi-epoch ``end_pass`` protocol of the out-of-core driver.

The reference's fits (n = 301, p = 37, d = 5, RBF, ``xla``) are shared
through module-scoped fixtures, and their draws (the Theorem-3 column
sample and the Theorem-4 score landmarks) are injected into every port fit
that is compared with one. Bounds: 1e-10 at f64 for the p×p pieces
(``pcg_solve``, ``falkon_pcg_from_stats``, ``build_preconditioner``); 1e-8
for ``falkon_pcg``'s β against the reference's ``falkon_pcg`` (the same
iteration, to its 1e-6 stop, on blocks summed in another order), with
equal iteration counts; and the reference's own 1e-3 (relative l2) between
an iterative β and the direct ``nystrom_regularized`` β, in f32 and f64
(tests/test_iterative.py). Both dtypes are held to the reference's f64
direct β, with its draws: the reference's own f32 direct β lies 6.1e-6
from it here (same draws, CPU), so the f64 β is the sharper target.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_common import F64_TOL, close, n, t

from repro.api import SketchConfig as JConfig
from repro.api import SketchedKRR as JKRR
from repro.core import RBFKernel as JRBF
from repro.core import ops_for as jops_for
from repro.core import distributed as jdist
from repro.core import eigenpro as jep
from repro.core.leverage import draw_landmarks as jdraw_landmarks
from repro.data.sparse import CsrMatrix as JCsr
from repro_torch.api import (ArrayChunkSource, ColumnSample, CsrMatrix,
                             GeneratorChunkSource, Precision, RBFKernel,
                             SketchConfig, SketchedKRR)
from repro_torch.api.config import NOT_PORTED
from repro_torch.api.out_of_core import SPARSE_CHUNK_SOLVERS
from repro_torch.api.solvers import IterativeState
from repro_torch.core import distributed as tdist
from repro_torch.core import eigenpro as tep
from repro_torch.core.backends import ops_for

N, P, DIM, CHUNK, LAM, H = 301, 37, 5, 64, 1e-3, 1.5
REL_TOL = 1e-3        # tests/test_iterative.py: iterative β vs direct β
PCG_TOL = 1e-8        # the port's falkon_pcg β vs the reference's
# λ of the in-memory falkon_pcg comparison. At λ = 1e-3 CG on this system
# carries rounding forward about 10× an iteration from the 12th on: the
# reference's own xla and streaming backends, whose blocks differ in the
# last bits, then stop at different iterations (their residual histories
# part by 0.2 % at the 15th and 70 % at the 19th, CPU). At 3e-3 both
# implementations take 15 iterations and agree to 8e-15
FALKON_LAM = 3e-3
# a budget that makes eigenpro's mini-batches 32 rows: SGD epochs first
SGD_BUDGET_MB = 0.01
COMMON = dict(p=P, lam=LAM, seed=3, sampler="rls_fast")


def _problem():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N + 50, DIM))
    y = np.sin(3.0 * X[:, 0]) + 0.2 * X[:, 1]
    return X[:N], y[:N], X[N:]


def _rel(b, ref):
    return float(np.linalg.norm(n(b) - n(ref)) / np.linalg.norm(n(ref)))


def _landmarks():
    """The reference's rls_fast score landmarks (its key splits; RBF's
    constant diagonal makes the seed distribution uniform)."""
    key_sample, _ = jax.random.split(jax.random.key(COMMON["seed"]))
    kd, _ = jax.random.split(key_sample)
    return t(jdraw_landmarks(kd, jnp.full((N,), 1.0 / N), P, True))


def _draws(ref, dtype="float64"):
    """A reference fit's draws, its sketch weights in ``dtype``."""
    idx, probs, weights = (t(a) for a in ref.sample())
    return dict(sample=ColumnSample(idx, probs,
                                    weights.to(getattr(torch, dtype))),
                score_landmarks=_landmarks())


def _port(dtype="float64", **kw):
    prec = Precision(data_dtype="f32" if dtype == "float32" else None)
    return SketchConfig(kernel=RBFKernel(H), device="cpu", precision=prec,
                        **{**COMMON, "solver": "nystrom_regularized", **kw})


@pytest.fixture(scope="module")
def ref():
    """The reference's direct fit (f64) and its in-memory falkon_pcg fit,
    with the data."""
    X, y, Xt = _problem()
    direct = JKRR(JConfig(kernel=JRBF(H), solver="nystrom_regularized",
                          **COMMON)).fit(jnp.asarray(X), jnp.asarray(y))
    out = dict(X=X, y=y, Xt=Xt, beta=np.asarray(direct.state().beta),
               draws={dt: _draws(direct, dt) for dt in ("float32",
                                                        "float64")},
               predict=np.asarray(direct.predict(jnp.asarray(Xt))),
               predict_train=np.asarray(direct.predict_train()))
    falkon = JKRR(JConfig(kernel=JRBF(H), solver="falkon_pcg",
                          **{**COMMON, "lam": FALKON_LAM})
                  ).fit(jnp.asarray(X), jnp.asarray(y))
    out["falkon"] = dict(beta=np.asarray(falkon.state().beta),
                         iters=falkon.state().iters, draws=_draws(falkon))
    return out


# ------------------------------------------------------------ the engine

def _spd(p=P, seed=1):
    """An SPD operator with its spectrum in [1, 4] and a (p, 2) right-hand
    side: CG stops in 18 steps, well before the p steps after which
    rounding starts to steer two implementations apart."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((p, p)))
    H_ = (Q * np.geomspace(1.0, 4.0, p)) @ Q.T
    return H_, rng.standard_normal((p, 2))


def test_pcg_solve_matches_reference():
    """Two right-hand sides with per-column steps, Jacobi-preconditioned."""
    H_, b = _spd()
    d = np.diag(H_)[:, None]
    want = jdist.pcg_solve(lambda v: jnp.asarray(H_) @ v, jnp.asarray(b),
                           lambda r: r / jnp.asarray(d), tol=1e-9,
                           max_iters=200)
    Ht, dt = t(H_), t(d)
    got = tdist.pcg_solve(lambda v: Ht @ v, t(b), lambda r: r / dt,
                          tol=1e-9, max_iters=200)
    assert got[1] == want[1] and 5 < got[1] < P
    close(got[0], want[0], **F64_TOL)
    close(got[2], want[2], rtol=1e-6, atol=0)
    assert got[2].shape == (got[1],) and float(got[2][-1]) <= 1e-9


def test_falkon_pcg_from_stats_matches_reference():
    """At λ = γ = 1e-2 (11 iterations). At λ = 1e-3 the system is
    conditioned so that the two implementations' last-bit differences
    grow to 2.4e-10 (relative l2) over 18 iterations; the whole fit's
    bound below (PCG_TOL) covers that regime."""
    rng = np.random.default_rng(2)
    X, Z = rng.standard_normal((200, DIM)), rng.standard_normal((P, DIM))
    kernel = RBFKernel(H)
    W, C = (n(kernel.gram(t(a), t(Z))) for a in (Z, X))
    w = rng.uniform(0.5, 2.0, P)
    Cs = C * w
    args = (W, w, Cs.T @ Cs, Cs.T @ rng.standard_normal((200, 2)))
    got = tdist.falkon_pcg_from_stats(*map(t, args), 200, 1e-2, 1e-2)
    want = jdist.falkon_pcg_from_stats(*map(jnp.asarray, args), 200, 1e-2,
                                       1e-2)
    assert got.iters == want.iters > 0
    close(got.beta, want.beta, **F64_TOL)


def test_build_preconditioner_matches_reference():
    rng = np.random.default_rng(3)
    Xs, Z = rng.standard_normal((120, DIM)), rng.standard_normal((P, DIM))
    w = rng.uniform(0.5, 2.0, P)
    W = n(RBFKernel(H).gram(t(Z), t(Z)))
    A = n(tep.regularized_penalty(t(W), t(w), N, LAM))
    close(A, jep.regularized_penalty(jnp.asarray(W), jnp.asarray(w), N, LAM),
          **F64_TOL)
    got = tep.build_preconditioner(ops_for(RBFKernel(H), "torch",
                                           device="cpu"),
                                   t(Xs), t(Z), t(w), t(A), LAM, 8,
                                   torch.float64)
    build = jax.jit(jep.build_preconditioner, static_argnums=(0, 6, 7))
    want = build(jops_for(JRBF(H), "xla"), *map(jnp.asarray, (Xs, Z, w, A)),
                 LAM, 8, jnp.float64)
    assert got.k == 8
    for field in ("tail", "bound", "damp"):
        close(getattr(got, field), getattr(want, field), err_msg=field,
              **F64_TOL)
    deflate = [n(pre.Q) @ np.diag(n(pre.damp)) @ n(pre.Q).T
               for pre in (got, want)]
    close(deflate[0], deflate[1], **F64_TOL)


def test_step_machinery_matches_reference():
    for args in [(10**7, 37, 8, 1.0), (10**7, 37, 8, 1e-4), (100, 37, 8, 1.0),
                 (16, 37, 8, 1.0), (463_715, 2048, 4, 64.0)]:
        assert tep.auto_batch_rows(*args) == jep.auto_batch_rows(*args)
    assert tep.auto_batch_rows(463_715, 2048, 4, 64.0) == 2048
    for args in [(20, 301, 301), (20, 64, 301), (1, 64, 301), (7, 32, 10)]:
        assert tep.sgd_epoch_budget(*args) == jep.sgd_epoch_budget(*args)
    f64 = dict(dtype=torch.float64)
    pre_t = tep.EigenProPrecond(torch.zeros(3, 1, **f64),
                                torch.zeros(1, **f64),
                                torch.tensor(0.01, **f64),
                                torch.tensor(5.0, **f64), 1)
    pre_j = jep.EigenProPrecond(jnp.zeros((3, 1)), jnp.zeros((1,)),
                                jnp.asarray(0.01), jnp.asarray(5.0), 1)
    for m in (1, 32, 10**9):
        assert float(tep.step_size(pre_t, m)) == pytest.approx(
            float(jep.step_size(pre_j, m)), rel=1e-12)
    tops = ops_for(RBFKernel(H), "torch", device="cpu")
    jops = jops_for(JRBF(H), "xla")
    for tdt, jdt in [(torch.float32, jnp.float32),
                     (torch.float64, jnp.float64),
                     (torch.bfloat16, jnp.bfloat16)]:
        got = tep.landmark_solve_dtypes(tops, tdt)
        want = jep.landmark_solve_dtypes(jops, jnp.dtype(jdt))
        assert [str(d).removeprefix("torch.") for d in got] == \
            [jnp.dtype(d).name for d in want]


# --------------------------------------------------------------- falkon

def test_falkon_pcg_in_memory_matches_reference(ref):
    X, y = ref["X"], ref["y"]
    model = SketchedKRR(_port(solver="falkon_pcg", lam=FALKON_LAM)).fit(
        X, y, **ref["falkon"]["draws"])
    state = model.state()
    assert isinstance(state, IterativeState)
    assert state.approx is None and state.alpha is None
    assert state.iters == ref["falkon"]["iters"]
    assert state.residuals.shape == (state.iters,)
    assert float(state.residuals[-1]) <= 1e-6
    assert _rel(state.beta, ref["falkon"]["beta"]) <= PCG_TOL


def test_preconditioning_beats_plain_cg(ref):
    X, y = t(ref["X"]), t(ref["y"])
    sample = ref["falkon"]["draws"]["sample"]
    ops = ops_for(RBFKernel(H), "torch", device="cpu")
    runs = [tdist.falkon_pcg_krr(ops, X, y, X[sample.idx], sample.weights,
                                 FALKON_LAM, FALKON_LAM, tol=1e-3,
                                 max_iters=500,
                                 precondition=pre) for pre in (True, False)]
    assert runs[0].iters <= 50 and runs[0].iters < runs[1].iters


def test_csr_falkon_out_of_core_matches_reference(ref):
    """The problem's rows with a fifth of the values zeroed, as CSR, in
    three chunks of 128 rows (a padded tail)."""
    X = ref["X"].copy()
    X[np.random.default_rng(4).random(X.shape) > 0.8] = 0.0
    Xt = ref["Xt"].copy()
    Xt[np.random.default_rng(5).random(Xt.shape) > 0.8] = 0.0
    common = dict(COMMON, solver="falkon_pcg", chunk_rows=128)
    jfit = JKRR(JConfig(kernel=JRBF(H), **common)).fit(
        JCsr.from_dense(X), jnp.asarray(ref["y"]))
    draws = dict(sample=ColumnSample(*(t(a) for a in jfit.sample())),
                 score_landmarks=_landmarks())
    want = jfit.predict(jnp.asarray(Xt))
    for backend in ("torch", "hopper"):
        model = SketchedKRR(SketchConfig(
            kernel=RBFKernel(H), backend=backend, device="cpu",
            **common)).fit(CsrMatrix.from_dense(X), ref["y"], **draws)
        assert model.state().iters == jfit.state().iters
        assert _rel(model.state().beta, jfit.state().beta) <= PCG_TOL
        close(model.predict(CsrMatrix.from_dense(Xt)), want, rtol=1e-7,
              atol=1e-7)
    assert "falkon_pcg" in SPARSE_CHUNK_SOLVERS


# ------------------------------------------ both solvers vs the direct β

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("solver,budget", [("falkon_pcg", 64.0),
                                           ("eigenpro", 64.0),
                                           ("eigenpro", SGD_BUDGET_MB)],
                         ids=["falkon_pcg", "eigenpro", "eigenpro-sgd"])
def test_iterative_beta_matches_direct(ref, solver, budget, dtype):
    X, y = ref["X"], ref["y"]
    model = SketchedKRR(_port(dtype, solver=solver,
                              batch_budget_mb=budget)).fit(
        X, y, **ref["draws"][dtype])
    beta = model.state().beta
    assert beta.dtype == getattr(torch, dtype)
    assert _rel(beta, ref["beta"]) <= REL_TOL
    if budget == SGD_BUDGET_MB:     # 10 SGD epochs of 32-row batches first
        assert tep.auto_batch_rows(N, P, beta.element_size(), budget) == 32
        assert model.state().iters > 10


@pytest.mark.parametrize("solver", ["falkon_pcg", "eigenpro"])
def test_chunk_source_fit_matches_direct(ref, solver):
    """fit(ArrayChunkSource): one pass of statistics for falkon_pcg, a pass
    a epoch for eigenpro (the end_pass protocol)."""
    src = ArrayChunkSource(ref["X"], ref["y"], chunk_rows=CHUNK)
    model = SketchedKRR(_port(solver=solver)).fit(src,
                                                  **ref["draws"]["float64"])
    assert _rel(model.state().beta, ref["beta"]) <= REL_TOL


def test_generator_source_streams_eigenpro_epochs(ref):
    """A block factory is called once per pass: the sampling passes, the
    collect pass and at least one epoch."""
    X, y = ref["X"], ref["y"]
    calls = []

    def factory():
        calls.append(1)
        for s in range(0, N, CHUNK):
            yield X[s:s + CHUNK], y[s:s + CHUNK]

    model = SketchedKRR(_port(solver="eigenpro")).fit(
        GeneratorChunkSource(factory, chunk_rows=CHUNK),
        **ref["draws"]["float64"])
    assert len(calls) >= 4 + model.state().iters
    assert model.state().iters >= 1
    assert _rel(model.state().beta, ref["beta"]) <= REL_TOL
    # a source that stops replaying after the collect pass (uniform
    # sampling: the diagonal pass, the landmark gather, then the collect)

    class Drying(ArrayChunkSource):
        passes = 0

        def chunks(self):
            self.passes += 1
            return super().chunks() if self.passes <= 3 else iter(())

    with pytest.raises(ValueError, match="went dry on epoch 2"):
        SketchedKRR(_port(solver="eigenpro", sampler="uniform")).fit(
            Drying(X, y, chunk_rows=CHUNK))


@pytest.mark.parametrize("solver", ["falkon_pcg", "eigenpro"])
def test_multi_output_y(ref, solver):
    """(n, k) targets share each iteration, with per-column steps."""
    X, y = ref["X"], ref["y"]
    Y = np.stack([y, -0.5 * y + 1.0], axis=1)
    direct = SketchedKRR(_port()).fit(X, Y)
    model = SketchedKRR(_port(solver=solver)).fit(X, Y)
    assert model.state().beta.shape == direct.state().beta.shape == (P, 2)
    assert _rel(model.state().beta, direct.state().beta) <= REL_TOL


def test_predictions_and_empirical_risk(ref):
    for solver in ("falkon_pcg", "eigenpro"):
        model = SketchedKRR(_port(solver=solver)).fit(
            ref["X"], ref["y"], **ref["draws"]["float64"])
        close(model.predict(ref["Xt"]), ref["predict"], rtol=1e-3, atol=1e-3)
        close(model.predict_batched(ref["Xt"], batch_size=16),
              ref["predict"], rtol=1e-3, atol=1e-3)
        train = model.predict_train()
        close(train, ref["predict_train"], rtol=1e-3, atol=1e-3)
        # no closed form: the empirical risk at the training points
        f_star = np.sin(3.0 * ref["X"][:, 0])
        report = model.risk(f_star, 0.1)
        close(report.risk, torch.mean((train - t(f_star)) ** 2), **F64_TOL)
        assert bool(torch.isnan(report.bias_sq)) and bool(
            torch.isnan(report.variance))


def test_partial_fit_falkon_matches_direct_and_eigenpro_refuses(ref):
    X, y = ref["X"], ref["y"]
    betas = {}
    for solver in ("nystrom_regularized", "falkon_pcg"):
        m = SketchedKRR(_port(solver=solver))
        m.partial_fit(X[:150], y[:150]).partial_fit(X[150:], y[150:])
        betas[solver] = m.finalize().state().beta
    assert _rel(betas["falkon_pcg"], betas["nystrom_regularized"]) <= REL_TOL
    m = SketchedKRR(_port(solver="eigenpro")).partial_fit(X[:150], y[:150])
    with pytest.raises(RuntimeError, match="falkon_pcg"):
        m.finalize()


def test_config_fields_are_validated():
    cfg = _port(solver="eigenpro", backend="streaming")
    assert (cfg.block_rows, cfg.epochs, cfg.batch_budget_mb, cfg.solver_iters,
            cfg.solver_tol, cfg.precond_k, cfg.precond_subsample) == \
        (4096, 20, 64.0, 100, 1e-6, None, None)
    for field in ("block_rows", "epochs", "batch_budget_mb", "solver_iters",
                  "solver_tol", "precond_k", "precond_subsample"):
        with pytest.raises(ValueError, match=f"{field} must be positive"):
            _port(**{field: 0})
    for kind, names in NOT_PORTED.items():
        assert not {"eigenpro", "falkon_pcg", "streaming"} & set(names)
    for field, name in [("solver", "distributed"), ("backend", "sharded")]:
        with pytest.raises(ValueError, match="ROADMAP item"):
            _port(**{field: name})
