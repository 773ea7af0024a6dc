"""The port's bf16 KRR paths against the JAX package, on the CPU: bf16
blocks with float32 accumulation (the counterparts of
tests/test_backends.py::TestBf16Accum), the quantized serve path
(``Precision(serve_dtype="bf16")``), fits from bf16 storage
(``Precision(data_dtype="bf16", solve_dtype="f64")``, ``falkon_pcg`` and
``eigenpro``), a chunked bf16 CSR fit, and fault R5 of the reference, which
the port keeps.

Inputs are made with numpy and handed to both packages as the same bf16
values; the reference's draws are injected. Tolerances, from the bf16 step
(2⁻⁸ relative, one unit in the last place at most 2⁻⁷):

* blocks: rtol 2⁻⁷ + the float32 block atol 2e-5. Both packages sum in
  float32, in other orders, and round once to bf16, so an element differs
  by at most one bf16 step where the two float32 sums straddle a rounding
  boundary. Against the float32 reference: the reference's own 5e-2.
* a contraction of bf16 blocks against a wider vector (and a prediction):
  element i within 2⁻⁷·Σ_j |K_ij v_j| + 1e-6, one bf16 step of each term;
* scores (bf16, rounded once from float32 sums of solves whose inputs are
  the same bf16 blocks): rtol 2⁻⁷, atol 1e-6.
* a fit's β and predictions, from bf16 blocks through float64 solves (or
  the float32 iterations of ``falkon_pcg`` and ``eigenpro``): within 2⁻⁷
  of their scale (max |·|), one bf16 step carried through the solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_common import close, n

from repro.api import ServingState as JServingState
from repro.api import SketchConfig as JConfig
from repro.api import SketchedKRR as JKRR
from repro.core import LinearKernel as JLinear
from repro.core import RBFKernel as JRBF
from repro.core import ops_for as jops_for
from repro.core.leverage import draw_landmarks as jdraw_landmarks
from repro.core.precision import Precision as JPrecision
from repro.data.sparse import CsrMatrix as JCsr
from repro.serve import ModelSlot as JModelSlot
from repro_torch.api import (ColumnSample, CsrMatrix, Precision, SketchConfig,
                             SketchedKRR, serving_state_from_reference)
from repro_torch.core import LinearKernel, RBFKernel
from repro_torch.core.backends import ops_for
from repro_torch.kernels import ops as kops
from repro_torch.runtime import KRRRequest, KRRServeEngine
from repro_torch.serve import ModelSlot

N, P, DIM, BLOCK_ROWS = 301, 37, 5, 64
STEP = 2.0 ** -7
BLOCK_TOL = dict(rtol=STEP, atol=2e-5)
REF_TOL = dict(rtol=5e-2, atol=5e-2)          # tests/test_backends.py:243
SCORE_TOL = dict(rtol=STEP, atol=1e-6)
KERNELS = {"rbf": (RBFKernel(1.3), JRBF(1.3)),
           "linear": (LinearKernel(), JLinear())}
BF16 = Precision(data_dtype="bf16", solve_dtype="f64")
JBF16 = JPrecision(data_dtype="bf16", solve_dtype="f64")


def _x(rows=N, seed=0, dim=DIM):
    return np.random.default_rng(seed).standard_normal((rows, dim)).astype(
        np.float32)


def _bf(a):
    """Exact bf16 values of ``a`` (numpy float32 or a JAX bf16 array) as a
    torch bf16 tensor."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f64(a):
    return np.asarray(n(a.float()) if isinstance(a, torch.Tensor)
                      and a.dtype == torch.bfloat16 else n(a), np.float64)


def _close_scaled(got, want, scale, rel=STEP):
    """|got − want| ≤ rel·scale + 1e-6, element by element."""
    err = np.abs(_f64(got) - _f64(want))
    bound = rel * np.asarray(scale, np.float64) + 1e-6
    assert np.all(err <= bound), float(np.max(err / bound))


def _close_to_scale(got, want):
    """Within one bf16 step of the result's scale."""
    w = _f64(want)
    _close_scaled(got, w, np.full(w.shape, np.max(np.abs(w))))


def _jax_landmarks(seed, rows, p):
    """The reference's in-memory rls_fast score landmarks (its key splits;
    RBF's constant diagonal makes the seed distribution uniform)."""
    key_sample, _ = jax.random.split(jax.random.key(seed))
    kd, _ = jax.random.split(key_sample)
    return np.asarray(jdraw_landmarks(kd, jnp.full((rows,), 1.0 / rows), p,
                                      True))


def _sample(ref):
    """A reference fit's column sample, its bf16 weights kept in bf16."""
    idx, probs, weights = ref.sample()
    conv = [torch.as_tensor(np.asarray(idx))]
    for a in (probs, weights):
        a = np.asarray(a)
        conv.append(_bf(a) if a.dtype.itemsize == 2 else torch.as_tensor(a))
    return ColumnSample(*conv)


# ------------------------------------------------------------ blocks


@pytest.mark.parametrize("kernel_name,backend,jax_backend", [
    ("rbf", "hopper", "pallas"), ("linear", "hopper", "xla"),
    ("rbf", "streaming", "xla"), ("linear", "streaming", "xla")])
def test_columns_and_cross(kernel_name, backend, jax_backend):
    """bf16 blocks in, float32 accumulation, bf16 blocks out, against the
    reference on the same bf16 values (and its float32 result within its
    own bf16 bar). The rbf hopper cell is held to the Pallas kernel in
    interpret mode."""
    tk, jk = KERNELS[kernel_name]
    X = _x()
    Xb = jnp.asarray(X).astype(jnp.bfloat16)
    idx = np.random.default_rng(1).integers(0, N, P)
    ops = ops_for(tk, backend, device="cpu", block_rows=BLOCK_ROWS)
    jops = jops_for(jk, jax_backend, block_rows=BLOCK_ROWS)
    Z = _x(P, seed=2)
    for got, want, f32 in [
            (ops.columns(_bf(X), torch.as_tensor(idx)),
             jops.columns(Xb, jnp.asarray(idx)),
             jops_for(jk, "xla").columns(jnp.asarray(X), jnp.asarray(idx))),
            (ops.cross(_bf(X), _bf(Z)), jops.cross(Xb, jnp.asarray(Z).astype(
                jnp.bfloat16)), jops_for(jk, "xla").cross(jnp.asarray(X),
                                                          jnp.asarray(Z)))]:
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert np.all(np.isfinite(_f64(got)))
        close(_f64(got), np.asarray(want, np.float64), **BLOCK_TOL)
        close(_f64(got), np.asarray(f32, np.float64), **REF_TOL)


@pytest.mark.parametrize("backend", ["hopper", "streaming"])
def test_contractions_promote_as_the_reference(backend):
    """matvec, rmatvec and gram_matvec of bf16 blocks against a float32
    vector accumulate in float32 and return float32; against a float64 β
    they return float64 (fault F1: torch does not promote a bf16 @ f32
    product by itself)."""
    tk, jk = KERNELS["rbf"]
    X, Z = _x(), _x(P, seed=2)
    rng = np.random.default_rng(3)
    ops = ops_for(tk, backend, device="cpu", block_rows=BLOCK_ROWS)
    jops = jops_for(jk, "xla")
    Xb, Zb = jnp.asarray(X).astype(jnp.bfloat16), jnp.asarray(Z).astype(
        jnp.bfloat16)
    K = np.abs(_f64(ops.cross(_bf(X), _bf(Z))))
    for vdt in (np.float32, np.float64):
        v = rng.standard_normal(P).astype(vdt)
        u = rng.standard_normal(N).astype(vdt)
        cells = [("matvec", v, K @ np.abs(v)),
                 ("rmatvec", u, K.T @ np.abs(u)),
                 ("gram_matvec", v, K.T @ (K @ np.abs(v)))]
        for name, w, scale in cells:
            got = getattr(ops, name)(_bf(X), _bf(Z), torch.as_tensor(w))
            want = getattr(jops, name)(Xb, Zb, jnp.asarray(w))
            assert got.dtype == getattr(torch, np.dtype(vdt).name), name
            assert str(want.dtype) == np.dtype(vdt).name, name
            _close_scaled(got, want, 2.0 * scale)


# --------------------------------------------------------------- the paths

COMMON = dict(p=P, p_scores=48, lam=1e-3, seed=3)


def _problem():
    X = _x(N + 77, seed=5)
    y = (np.sin(2.0 * X[:, 0]) + 0.3 * X[:, 1] ** 2).astype(np.float32)
    return X[:N], y[:N], X[N:]


@pytest.fixture(scope="module")
def reference_fit():
    """The reference's fits of ``_problem``, one per (precision, solver,
    backend), shared by every cell that holds the port to one."""
    cache = {}

    def fit(jprecision, solver, jax_backend):
        key = (jprecision, solver, jax_backend)
        if key not in cache:
            X, y, _ = _problem()
            cache[key] = JKRR(JConfig(
                kernel=JRBF(1.5), solver=solver, backend=jax_backend,
                precision=jprecision, **COMMON)).fit(jnp.asarray(X),
                                                     jnp.asarray(y))
        return cache[key]

    return fit


def _fit_pair(reference_fit, precision, jprecision, solver="nystrom",
              backend="hopper", jax_backend="xla"):
    """The reference's fit and the port's with its draws injected."""
    X, y, Xt = _problem()
    ref = reference_fit(jprecision, solver, jax_backend)
    port = SketchedKRR(SketchConfig(
        kernel=RBFKernel(1.5), solver=solver, backend=backend, device="cpu",
        precision=precision, **COMMON)).fit(
        X, y, sample=_sample(ref),
        score_landmarks=_jax_landmarks(COMMON["seed"], N, COMMON["p_scores"]))
    return ref, port, Xt


def test_quantized_predict_batched_matches_reference():
    """A float32 model served in bf16 (``serve_dtype``) by both packages:
    the port's float32 fit installed in the reference, whose exported β and
    landmarks are moved back (``serving_state_from_reference``); bf16
    blocks, the contraction in float32, float32 predictions. The port's
    ModelSlot and KRRServeEngine serve exactly its predict_batched."""
    X, y, Xt = _problem()
    q = Precision(serve_dtype="bf16")
    fitted = SketchedKRR(SketchConfig(kernel=RBFKernel(1.5), device="cpu",
                                      sampler="uniform", **COMMON)).fit(X, y)
    st = fitted.export_serving_state()
    assert st.beta.dtype == torch.float32
    ref = JKRR(JConfig(kernel=JRBF(1.5), backend="xla", sampler="uniform",
                       precision=JPrecision(serve_dtype="bf16"), **COMMON)
               ).import_serving_state(JServingState(
                   beta=jnp.asarray(n(st.beta)),
                   landmarks=jnp.asarray(n(st.landmarks)),
                   col_weights=(None if st.col_weights is None
                                else jnp.asarray(n(st.col_weights))),
                   solver=st.solver))
    serving = ref.export_serving_state()
    port = SketchedKRR(SketchConfig(kernel=RBFKernel(1.5), precision=q,
                                    sampler="uniform", device="cpu",
                                    **COMMON)
                       ).import_serving_state(serving_state_from_reference(
                           {k: (None if v is None else np.asarray(v))
                            for k, v in serving._asdict().items()},
                           device="cpu"))
    want = ref.predict_batched(jnp.asarray(Xt), 32)
    got = port.predict_batched(Xt, 32)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    Z = np.asarray(serving.landmarks, np.float32)
    K = _f64(ops_for(RBFKernel(1.5), "torch", device="cpu").cross(
        torch.as_tensor(Xt), torch.as_tensor(Z)))
    _close_scaled(got, want, np.abs(K) @ np.abs(np.asarray(serving.beta)))
    # the float32 server on the same β is within that step too
    full = fitted.predict_batched(Xt, 32)
    _close_scaled(got, full, np.abs(K) @ np.abs(np.asarray(serving.beta)))
    assert torch.equal(torch.as_tensor(
        ModelSlot(port).current().predict_padded(Xt[:20], 32)), got[:20])
    eng = KRRServeEngine(port, batch_size=32)
    for i in range(len(Xt)):
        eng.submit(KRRRequest(i, Xt[i]))
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert eng.serve_dtype == "bfloat16"
    assert [r.y_hat for r in done] == got.tolist()
    want_slot = JModelSlot(ref).current().predict_padded(Xt[:20], 32)
    close(want_slot, want[:20], rtol=0, atol=0)


@pytest.mark.parametrize("backend,jax_backend", [
    ("torch", "xla"), ("hopper", "xla"), ("streaming", "streaming")])
def test_bf16_storage_nystrom_fit_with_f64_solves(reference_fit, backend,
                                                  jax_backend):
    """bf16 storage, float32 accumulation, float64 solves (the setting in
    which both packages fit; R5 is the default's), with the reference's
    draws: the Theorem-4 scores in bf16, finite and in [0, 1.05] (the
    reference's assertion, tests/test_backends.py::TestBf16Accum) and close
    to the reference's; β and ``predict`` in float64, as the reference
    returns them. ``streaming`` runs the score pass in two streamed passes
    (CᵀC, then triangular solves) and K2 not at all, as the reference's
    ``streaming`` backend does."""
    ref, port, Xt = _fit_pair(reference_fit, BF16, JBF16, backend=backend,
                              jax_backend=jax_backend)
    scores = port.scores()
    s = _f64(scores)
    assert scores.dtype == torch.bfloat16
    assert np.all(np.isfinite(s)) and s.min() >= 0.0 and s.max() <= 1.05
    close(s, np.asarray(ref.scores(), np.float64), **SCORE_TOL)
    assert port.state().beta.dtype == torch.float64
    _close_to_scale(port.state().beta, ref.state().beta)
    got, want = port.predict(Xt), ref.predict(jnp.asarray(Xt))
    assert got.dtype == torch.float64 and want.dtype == jnp.float64
    _close_to_scale(got, want)


@pytest.mark.parametrize("solver", ["falkon_pcg", "eigenpro"])
def test_bf16_storage_iterative_fit(reference_fit, solver):
    """``falkon_pcg`` and ``eigenpro`` from bf16 storage (fault F1 raised in
    falkon's CᵀC·v): β in bf16 and predictions in float32, as the
    reference's."""
    ref, port, Xt = _fit_pair(reference_fit, BF16, JBF16, solver=solver)
    beta = port.state().beta
    assert beta.dtype == torch.bfloat16
    _close_to_scale(beta, ref.state().beta)
    got, want = port.predict(Xt), ref.predict(jnp.asarray(Xt))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close_to_scale(got, want)


def test_chunked_bf16_csr_fit_matches_reference():
    """A CSR fit in chunks of 128 rows from bf16 values (K3's bf16
    instance on the card; its plain version here): scores, β and the
    predictions of CSR test rows against the reference's chunked fit.
    ``hopper`` is held to the reference's ``pallas`` backend, whose CSR
    blocks are K3's function (``sparse_kernel_block``: the cross product
    rounded to bf16 before the rbf epilogue). The ``xla`` backend's plain
    ``kernel.gram`` under the policy rounds only the block; that one step,
    carried through the solves, parts the two backends' scores by 3.3 %
    here, in both packages."""
    rng = np.random.default_rng(6)
    Xs = np.where(rng.random((N + 77, 40)) < 0.15,
                  rng.standard_normal((N + 77, 40)), 0.0).astype(np.float32)
    ys = np.tanh(Xs @ rng.standard_normal(40)).astype(np.float32)
    chunked = dict(COMMON, chunk_rows=128)
    ref = JKRR(JConfig(kernel=JRBF(2.0), backend="pallas",
                       precision=JBF16, **chunked)).fit(
        JCsr.from_dense(Xs[:N]), jnp.asarray(ys[:N]))
    kops.reset_launch_counts()
    port = SketchedKRR(SketchConfig(kernel=RBFKernel(2.0), backend="hopper",
                                    device="cpu", precision=BF16, **chunked)
                       ).fit(CsrMatrix.from_dense(Xs[:N]), ys[:N],
                             sample=_sample(ref),
                             score_landmarks=_jax_landmarks(
                                 COMMON["seed"], N, COMMON["p_scores"]))
    close(_f64(port.scores()), np.asarray(ref.scores(), np.float64),
          **SCORE_TOL)
    _close_to_scale(port.state().beta, ref.state().beta)
    got = port.predict(CsrMatrix.from_dense(Xs[N:]))
    want = ref.predict(JCsr.from_dense(Xs[N:]))
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    _close_to_scale(got, want)
    assert sum(kops.launch_counts().values()) == 0


@pytest.mark.parametrize("solver", ["nystrom", "nystrom_regularized"])
def test_r5_default_bf16_in_memory_fit_raises_in_both(solver):
    """Fault R5 of the reference: bf16 storage with no ``solve_dtype``
    factors a bf16 p×p system, which neither package can (eigh / cholesky
    have no bf16); the port raises where the reference raises, and gains
    no feature the reference lacks."""
    X, y, _ = _problem()
    with pytest.raises(NotImplementedError):
        JKRR(JConfig(kernel=JRBF(1.5), solver=solver, backend="xla",
                     precision=JPrecision(data_dtype="bf16"), **COMMON)
             ).fit(jnp.asarray(X), jnp.asarray(y))
    with pytest.raises((NotImplementedError, RuntimeError),
                       match="BFloat16"):
        SketchedKRR(SketchConfig(kernel=RBFKernel(1.5), solver=solver,
                                 device="cpu",
                                 precision=Precision(data_dtype="bf16"),
                                 **COMMON)).fit(X, y)
