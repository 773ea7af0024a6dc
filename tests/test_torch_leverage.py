"""The PyTorch port's paper math against the JAX package: exact and fast
ridge-leverage scores, the Nyström factors and the KRR solves.

The reference's landmark draw is injected into the port (``idx=``), since
PyTorch cannot reproduce JAX's random streams. Tolerances
(tests/_torch_common.py): 1e-10 at float64; atol 2e-5 on float32 blocks,
rtol 2e-4 on float32 scores.

The last test is the reference's fault R1 (ROADMAP): on that f32 cell the
reference's score pass NaNs; the port's must not.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_common import DTYPES, close, normal, t, tol

from repro.core import RBFKernel as JRBF
from repro.core import krr as jkrr
from repro.core import leverage as jlev
from repro.core import nystrom as jny
from repro.core import ops_for as jops_for
from repro_torch.api import SketchConfig, SketchedKRR
from repro_torch.core import RBFKernel, krr, leverage, nystrom, ops_for
from repro_torch.core.backends import TorchOps, jittered_cholesky_ex
from repro_torch.core.precision import Precision, dtype_jitter_floor

N, DIM, P, LAM, H = 301, 5, 37, 1e-3, 1.3


def _X(dtype="float64", n=N):
    return normal((n, DIM), 0, dtype)


def _reference_fast(X, p=P, lam=LAM, seed=1):
    return jlev.fast_ridge_leverage(JRBF(H), jnp.asarray(X), lam, p,
                                    jax.random.key(seed),
                                    ops=jops_for(JRBF(H), "xla"))


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fast_leverage_with_reference_landmarks(dtype, backend):
    X = _X(dtype)
    want = _reference_fast(X)
    got = leverage.fast_ridge_leverage(
        RBFKernel(H), t(X), LAM, P, idx=t(want.landmarks),
        ops=ops_for(RBFKernel(H), backend, device="cpu"))
    assert torch.equal(got.landmarks, t(want.landmarks))
    close(got.B, want.B, **tol(dtype))
    close(got.scores, want.scores, **tol(dtype, scores=True))
    close(got.d_eff_estimate, want.d_eff_estimate, **tol(dtype, scores=True))


def test_theorem4_upper_bound_and_additive_error():
    """l_i − 2ε ≤ l̃_i ≤ l_i with the theorem's p, the reference's draw."""
    X = normal((400, DIM), 3)
    lam, eps, rho = 1e-2, 0.4, 0.1
    K = RBFKernel(2.0).gram(t(X), t(X))
    p = min(leverage.theorem4_sample_size(float(torch.trace(K)), 400, lam,
                                          eps, rho), 399)
    ref = jlev.fast_ridge_leverage(JRBF(2.0), jnp.asarray(X), lam, p,
                                   jax.random.key(1))
    fast = leverage.fast_ridge_leverage(RBFKernel(2.0), t(X), lam, p,
                                        idx=t(ref.landmarks))
    exact = leverage.ridge_leverage_scores(K, lam)
    assert float(torch.max(fast.scores - exact)) <= 1e-6         # upper bound
    assert float(torch.max(exact - fast.scores)) <= 2 * eps + 1e-6


def test_exact_scores_and_dimensions_match_reference():
    X = _X()
    K = RBFKernel(H).gram(t(X), t(X))
    jK = JRBF(H).gram(jnp.asarray(X), jnp.asarray(X))
    want = jax.jit(jlev.ridge_leverage_scores)(jK, LAM)
    close(leverage.ridge_leverage_scores(K, LAM), want, **tol("float64"))
    close(leverage.ridge_leverage_scores_eig(K, LAM),
          leverage.ridge_leverage_scores(K, LAM), rtol=1e-8, atol=1e-10)
    # the reference defines d_eff = Σ l_i and d_mof = n·max l_i
    close(leverage.effective_dimension(K, LAM), jnp.sum(want),
          **tol("float64"))
    close(leverage.max_degrees_of_freedom(K, LAM), N * jnp.max(want),
          **tol("float64"))
    assert leverage.theorem3_sample_size(12.5, N) == \
        jlev.theorem3_sample_size(12.5, N)


def test_draws_are_seeded_and_precision_independent():
    probs = torch.as_tensor(np.random.default_rng(5).dirichlet(np.ones(N)))
    draw = [leverage.draw_landmarks(torch.Generator().manual_seed(7),
                                    probs.to(dt), 50)
            for dt in (torch.float64, torch.float32, torch.float64)]
    assert torch.equal(draw[0], draw[1]) and torch.equal(draw[0], draw[2])
    cols = nystrom.draw_columns(torch.Generator().manual_seed(7), probs, 50)
    close(cols.weights, 1.0 / np.sqrt(50 * probs.numpy()[cols.idx.numpy()]),
          **tol("float64"))


# --------------------------------------------------------- Nyström / KRR

@functools.lru_cache(maxsize=None)
def _columns():
    X = _X()
    idx = np.asarray(_reference_fast(X).landmarks)
    C = TorchOps(RBFKernel(H)).columns(t(X), t(idx))
    return C, idx, JRBF(H).gram(jnp.asarray(X), jnp.asarray(X[idx]))


def test_nystrom_factors_match_reference():
    C, idx, jC = _columns()
    F, G = nystrom.nystrom_factors(C, t(idx))
    jF, jG = jny.nystrom_factors(jC, jnp.asarray(idx))
    # eigenvectors are defined up to sign: compare the invariants
    close(F @ F.T, jF @ jF.T, **tol("float64"))
    close(G @ G.T, jG @ jG.T, **tol("float64"))
    close(F, C @ G, **tol("float64"))


def test_regularized_factors_and_woodbury_match_reference():
    C, idx, jC = _columns()
    w = normal(P, 4) ** 2 + 0.5
    F, L = nystrom.nystrom_regularized_factors(C, t(idx), t(w), N, LAM)
    jF, jL = jny.nystrom_regularized_factors(jC, jnp.asarray(idx),
                                             jnp.asarray(w), N, LAM)
    close(F, jF, **tol("float64"))
    close(L, jL, **tol("float64"))
    y = normal(N, 5)
    close(krr.woodbury_solve(F, N * LAM, t(y)),
          jkrr.woodbury_solve(jF, N * LAM, jnp.asarray(y)), **tol("float64"))
    G_F, b_F = F.T @ F, F.T @ t(y)
    close(krr.woodbury_dual_from_stats(G_F, b_F, N * LAM),
          jkrr.woodbury_dual_from_stats(jF.T @ jF, jF.T @ jnp.asarray(y),
                                        N * LAM), **tol("float64"))


def test_krr_fits_and_risks_match_reference():
    X, y, f = _X(), normal(N, 6), normal(N, 7)
    K = RBFKernel(H).gram(t(X), t(X))
    jK = JRBF(H).gram(jnp.asarray(X), jnp.asarray(X))
    close(krr.krr_fit(K, t(y), LAM), jkrr.krr_fit(jK, jnp.asarray(y), LAM),
          **tol("float64"))
    for got, want in zip(krr.risk_exact(K, t(f), LAM, 0.1),
                         jkrr.risk_exact(jK, jnp.asarray(f), LAM, 0.1)):
        close(got, want, **tol("float64"))
    C, idx, jC = _columns()
    F, _ = nystrom.nystrom_factors(C, t(idx))
    jF, _ = jny.nystrom_factors(jC, jnp.asarray(idx))
    approx = nystrom.NystromApprox(F, None)
    japprox = jny.NystromApprox(jF, None)
    for got, want in zip(krr.risk_nystrom(approx, t(f), LAM, 0.1),
                         jkrr.risk_nystrom(japprox, jnp.asarray(f), LAM, 0.1)):
        close(got, want, **tol("float64"))


# ------------------------------------------------------------- fault R1

def test_r1_cell_is_finite_and_close_to_float64():
    """The cell of tests/test_bless.py where the reference's f32 score pass
    NaNs: RBF h=2, n=301, d=3, seed 4, p_scores=64 with 59 unique landmarks.
    W is exactly singular and its f32 rounding is negative beyond the f64
    jitter floor; the port re-factors at the f32 floor and stays finite."""
    X = np.array(jax.random.normal(jax.random.key(0), (N, 3), jnp.float32))
    f_star = np.sin(2.0 * X[:, 0]) + 0.3 * X[:, 1] ** 2
    y = f_star + 0.1 * np.array(jax.random.normal(jax.random.key(9), (N,),
                                                  jnp.float32))
    # the reference's rls_fast landmark draw for seed 4
    key_sample, _ = jax.random.split(jax.random.key(4))
    kd, _ = jax.random.split(key_sample)
    idx = t(jlev.draw_landmarks(kd, jnp.full((N,), 1.0 / N, jnp.float32), 64))
    assert int(torch.unique(idx).numel()) == 59

    C = TorchOps(RBFKernel(2.0)).columns(t(X), idx)
    _, info = jittered_cholesky_ex(C[idx].double(), 1e-10)
    assert int(info) > 0          # the reference's factorization fails here

    cfg = SketchConfig(RBFKernel(2.0), p=48, lam=1e-3, seed=4,
                       precision=Precision(data_dtype="float32"),
                       p_scores=64, device="cpu",
                       solver="nystrom_regularized")
    m32 = SketchedKRR(cfg).fit(X, y, score_landmarks=idx)
    assert bool(torch.isfinite(m32.scores()).all())
    assert bool(torch.isfinite(m32.predict(X)).all())
    m64 = SketchedKRR(cfg.replace(
        precision=Precision(data_dtype="float64"),
        jitter=dtype_jitter_floor("float32"))).fit(
        X.astype("float64"), y.astype("float64"), score_landmarks=idx)
    rel = (m32.scores().double() - m64.scores()).abs() / m64.scores().abs()
    assert float(rel.max()) <= 1e-4


def test_own_draws_rank_and_risk_like_the_exact_oracle():
    """The port's own draws, checked in distribution (ROADMAP P2), as
    tests/test_concentration.py checks the reference's on the same problem:
    its rls_fast scores rank the rows like the exact Definition-1 scores
    (Spearman ≥ 0.9), and its rls_fast fit reaches risk parity (≤ 1.05×,
    the mean over 3 seeds) with the rls_exact-sampled oracle at the same p.
    No reference draw is injected; torch only."""
    n, d, lam = 301, 40, 1e-2
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d))
    X[rng.random(X.shape) > 0.12] = 0.0
    w1, w2 = rng.normal(size=d), rng.normal(size=d)
    f_star = (np.sin(2.0 * (X @ w1) / np.sqrt(d))
              + 0.3 * (X @ w2) / np.sqrt(d))
    y = f_star + 0.1 * rng.normal(size=n)
    kernel = RBFKernel(4.0)
    cfg = SketchConfig(kernel, p=48, p_scores=96, lam=lam, device="cpu",
                       solver="nystrom_regularized")
    fast = SketchedKRR(cfg.replace(seed=2)).fit(X, y).scores()
    exact = leverage.ridge_leverage_scores(kernel.gram(t(X), t(X)),
                                           lam * cfg.eps)
    ranks = [np.argsort(np.argsort(s.numpy())) for s in (fast, exact)]
    assert float(np.corrcoef(*ranks)[0, 1]) >= 0.9
    risk = {"rls_fast": 0.0, "rls_exact": 0.0}
    for seed in range(3):
        for sampler in risk:
            model = SketchedKRR(cfg.replace(seed=seed, sampler=sampler))
            pred = model.fit(X, y).predict(X).numpy()
            risk[sampler] += float(np.mean((pred - f_star) ** 2)) / 3
    assert risk["rls_fast"] <= 1.05 * risk["rls_exact"], risk
