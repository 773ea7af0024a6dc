"""The port's recursive ridge-leverage sampler, divide-and-conquer solver and
Theorem-2 machinery against the JAX package.

``recursive_ridge_leverage`` runs with the reference's per-level draws
injected (recorded with ``monkeypatch`` around
``repro.core.recursive_rls.fast_ridge_leverage``, which is called through
unchanged), ``dnc_fit`` and the ``dnc`` solver with the reference's
partitions injected, and the five ``concentration`` functions on the same
numpy inputs. Bound: 1e-10 at f64 (tests/test_backends.py's bar).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_common import F64_TOL, close, n, t

import repro.core.concentration as jconc
import repro.core.dnc as jdnc
import repro.core.recursive_rls as jrec
from repro.api import SketchConfig as JConfig
from repro.api import SketchedKRR as JKRR
from repro.core import RBFKernel as JRBF
from repro.core import gram_matrix as jgram
from repro.core import ridge_leverage_scores as jrls
from repro_torch.api import RBFKernel, SketchConfig, SketchedKRR
from repro_torch.core import concentration as tconc
from repro_torch.core import dnc as tdnc
from repro_torch.core import recursive_rls as trec
from repro_torch.core.backends import ops_for
from repro_torch.core.leverage import ridge_leverage_scores

N, DIM, LAM, H, P = 300, 4, 1e-3, 1.0, 40


def _clustered():
    """tests/test_recursive_rls.py's problem: a tight cluster and 20
    outliers, so leverage varies."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((N - 20, DIM)) * 0.3
    outl = rng.standard_normal((20, DIM)) * 3.0 + 4.0
    X = np.vstack([base, outl])
    return X, np.sin(X[:, 0]) + 0.1 * rng.standard_normal(N)


@pytest.fixture(scope="module")
def reference_levels():
    """Three levels of the reference's recursive pass, with its draws (the
    sampler test below runs the same shapes, so the reference compiles
    them once)."""
    X, _ = _clustered()
    mp = pytest.MonkeyPatch()
    seen = []
    inner = jrec.fast_ridge_leverage

    def recording(*a, **kw):
        out = inner(*a, **kw)
        seen.append(np.asarray(out.landmarks))
        return out
    try:
        mp.setattr(jrec, "fast_ridge_leverage", recording)
        res = jrec.recursive_ridge_leverage(JRBF(H), jnp.asarray(X), LAM, P,
                                            jax.random.key(0), n_levels=3)
    finally:
        mp.undo()
    return X, res, seen


def test_recursive_ridge_leverage_matches_reference(reference_levels):
    X, want, draws = reference_levels
    got = trec.recursive_ridge_leverage(
        RBFKernel(H), t(X), LAM, P, n_levels=3,
        ops=ops_for(RBFKernel(H), "torch", device="cpu"),
        levels_idx=[t(d) for d in draws])
    assert [len(d) for d in draws] == [P] * 3
    close(got.scores, want.scores, **F64_TOL)
    for g, w in zip(got.levels, want.levels):
        close(g.scores, w.scores, **F64_TOL)
        close(g.B, w.B, **F64_TOL)
    for g, w in zip(got.sampling_scores, want.sampling_scores):
        close(g, w, **F64_TOL)
    close(got.d_eff_estimates, want.d_eff_estimates, **F64_TOL)
    with pytest.raises(ValueError, match="3 levels"):
        trec.recursive_ridge_leverage(RBFKernel(H), t(X), LAM, P,
                                      n_levels=3, levels_idx=draws[:2])


def test_sampling_beta_matches_reference(reference_levels):
    X, want, _ = reference_levels
    exact = jrls(jgram(JRBF(H), jnp.asarray(X)), LAM)
    exact_t = ridge_leverage_scores(RBFKernel(H).gram(t(X), t(X)), LAM)
    close(exact_t, exact, **F64_TOL)
    for approx in (want.levels[0].scores, want.sampling_scores[0]):
        close(trec.sampling_beta(t(approx), exact_t),
              jrec.sampling_beta(approx, exact), **F64_TOL)
    # the overestimate never starves a row; raw scores can
    assert float(trec.sampling_beta(t(want.sampling_scores[0]), exact_t)) \
        > float(trec.sampling_beta(t(want.levels[0].scores), exact_t))


def test_recursive_rls_sampler_matches_reference(reference_levels):
    """The registered sampler (λε, ``p_scores``, ``rls_levels``) with the
    reference's level draws and column sample injected, against the
    reference's registered sampler on the same key."""
    import repro.api.samplers as jsamplers
    from repro_torch.api import SAMPLERS, ColumnSample
    from repro_torch.api.samplers import streams
    X, _, draws = reference_levels
    common = dict(p=30, p_scores=P, lam=LAM * 2, seed=1,
                  sampler="recursive_rls", rls_levels=3)
    mp = pytest.MonkeyPatch()
    seen = []
    inner = jrec.fast_ridge_leverage
    try:
        mp.setattr(jrec, "fast_ridge_leverage", lambda *a, **kw: (
            seen.append(inner(*a, **kw)) or seen[-1]))
        want = jsamplers.recursive_rls(jax.random.key(0), JRBF(H),
                                       jnp.asarray(X),
                                       JConfig(kernel=JRBF(H), **common))
    finally:
        mp.undo()
    got = SAMPLERS.get("recursive_rls")(
        tuple(streams(1, 2)), RBFKernel(H), t(X),
        SketchConfig(RBFKernel(H), device="cpu", **common),
        landmarks=[t(r.landmarks) for r in seen],
        sample=ColumnSample(*(t(a) for a in want.sample)))
    assert len(seen) == 3
    close(got.scores, want.scores, **F64_TOL)
    assert torch.equal(got.sample.idx, t(want.sample.idx))


# ---------------------------------------------------- divide and conquer

@pytest.fixture(scope="module")
def reference_dnc():
    X, y = _clustered()
    cfg = JConfig(kernel=JRBF(H), p=8, lam=LAM, seed=4, solver="dnc",
                  partitions=5)
    ref = JKRR(cfg).fit(jnp.asarray(X), jnp.asarray(y))
    return X, y, ref


def test_dnc_core_matches_reference(reference_dnc):
    X, y, ref = reference_dnc
    want = ref.state().model
    ops = ops_for(RBFKernel(H), "torch", device="cpu")
    got = tdnc.dnc_fit(RBFKernel(H), t(X), t(y), LAM, 5,
                       partitions=t(want.partitions), ops=ops)
    assert torch.equal(got.partitions, t(want.partitions))
    close(got.alphas, want.alphas, **F64_TOL)
    Xt = X[::7]
    close(tdnc.dnc_predict(RBFKernel(H), t(X), got, t(Xt), ops=ops),
          jdnc.dnc_predict(JRBF(H), jnp.asarray(X), want, jnp.asarray(Xt)),
          **F64_TOL)
    close(tdnc.dnc_predict_train(RBFKernel(H), t(X), got, ops=ops),
          jdnc.dnc_predict_train(JRBF(H), jnp.asarray(X), want), **F64_TOL)
    assert tdnc.dnc_kernel_evals(463_715, 35) == \
        jdnc.dnc_kernel_evals(463_715, 35) == 6_143_760_035
    with pytest.raises(ValueError, match="divisible"):
        tdnc.dnc_fit(RBFKernel(H), t(X), t(y), LAM, 7)
    with pytest.raises(ValueError, match="partitions must be"):
        tdnc.dnc_fit(RBFKernel(H), t(X), t(y), LAM, 5,
                     partitions=t(want.partitions)[:, :10])


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_dnc_solver_matches_reference(reference_dnc, backend):
    """solver="dnc" through SketchedKRR with the reference's partitions:
    predictions, training predictions and the empirical risk (no closed
    form, as in the reference)."""
    X, y, ref = reference_dnc
    cfg = SketchConfig(RBFKernel(H), p=8, lam=LAM, seed=4, solver="dnc",
                       partitions=5, device="cpu", backend=backend)
    model = SketchedKRR(cfg).fit(
        X, y, partitions=np.asarray(ref.state().model.partitions))
    Xt = X[::5]
    close(model.predict(Xt), ref.predict(jnp.asarray(Xt)), **F64_TOL)
    close(model.predict_train(), ref.predict_train(), **F64_TOL)
    close(model.predict_batched(Xt, 16), ref.predict_batched(
        jnp.asarray(Xt), 16), **F64_TOL)
    f_star = np.sin(X[:, 0])
    close(model.risk(t(f_star), 0.1).risk,
          ref.risk(jnp.asarray(f_star), 0.1).risk, **F64_TOL)
    assert SketchedKRR(cfg).fit(X, y).state().model.partitions.shape == \
        (5, N // 5)
    with pytest.raises(TypeError, match="make_batched_predict"):
        model.export_serving_state()
    with pytest.raises(ValueError, match="dnc solver's draw"):
        SketchedKRR(cfg.replace(solver="nystrom")).fit(
            X, y, partitions=np.asarray(ref.state().model.partitions))


# ------------------------------------------------ Theorem-2 machinery

def _psi_problem():
    """An RBF(1.0) Gram of 60 points, made with numpy."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((60, 3))
    sq = np.sum((X[:, None, :] - X[None, :, :]) ** 2, axis=-1)
    return np.exp(-sq / 2.0)


@pytest.mark.parametrize("fn", ["bernstein_tail", "theorem2_required_p",
                                "beta_of_distribution", "psi_matrix",
                                "sketch_deviation"])
def test_concentration_matches_reference(fn):
    if fn == "bernstein_tail":
        for args in [(0.5, 500, 0.9, 20.0, 1.0, 100),
                     (0.1, 64, 1.0, 3.5, 0.25, 7)]:
            assert tconc.bernstein_tail(*args) == pytest.approx(
                jconc.bernstein_tail(*args), rel=1e-15)
        return
    if fn == "theorem2_required_p":
        for args in [(0.5, 1.0, 20.0, 1.0, 100, 0.1),
                     (0.5, 1.0, 20.0, 0.25, 100, 0.1)]:
            assert tconc.theorem2_required_p(*args) == \
                jconc.theorem2_required_p(*args)
        return
    K = _psi_problem()
    Psi_j = jconc.psi_matrix(jnp.asarray(K), 1e-2)
    if fn == "psi_matrix":
        Psi = tconc.psi_matrix(t(K), 1e-2)
        # eigenvectors are fixed up to sign: compare ΨᵀΨ and the column norms
        close(Psi.T @ Psi, np.asarray(Psi_j).T @ np.asarray(Psi_j),
              **F64_TOL)
        close(torch.sum(Psi ** 2, 0),
              ridge_leverage_scores(t(K), 1e-2), **F64_TOL)
        return
    norms = np.asarray(jnp.sum(Psi_j ** 2, axis=0))
    if fn == "beta_of_distribution":
        for probs in (norms / norms.sum(), np.full(60, 1 / 60)):
            close(tconc.beta_of_distribution(t(probs), t(norms)),
                  jconc.beta_of_distribution(jnp.asarray(probs),
                                             jnp.asarray(norms)), **F64_TOL)
        return
    S = np.zeros((60, 40))
    idx = np.random.default_rng(3).integers(0, 60, 40)
    S[idx, np.arange(40)] = 1.0 / np.sqrt(40 * norms[idx] / norms.sum())
    close(tconc.sketch_deviation(t(np.asarray(Psi_j)), t(S)),
          jconc.sketch_deviation(Psi_j, jnp.asarray(S)), **F64_TOL)
    assert n(tconc.sketch_deviation(t(np.asarray(Psi_j)), t(S))).shape == ()
