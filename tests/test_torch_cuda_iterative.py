"""The iterative solvers and the streaming executor on the card: ``hopper``
(and ``streaming``, whose tiles are hopper's) against ``torch``.

Every test here is marked ``cuda`` and skips where there is no GPU; no JAX
import (run with ``--noconftest -m cuda``, see tests/test_torch_cuda.py).
Both sides fit on the card with the same draws (``falkon_pcg`` and
``eigenpro`` also with the same seed, so the same preconditioner
subsample); the launch counts show that ``hopper`` and ``streaming`` took
K1 (K3 for CSR rows) and ``torch`` no kernel. Tolerances: float64 1e-8
(relative l2 of β, where the system is conditioned so that the iterations
do not carry the blocks' last-bit differences forward: see
tests/test_torch_iterative.py), float32 2e-3 on predictions (relative to
their largest magnitude) and β, about the float32 Woodbury system's
amplification of one rounding of the blocks (chip_smoke.PARITY_TOL's
reasoning at 1/10 of its margin).
"""
import numpy as np
import pytest
import torch
from _torch_common import DTYPES, close, cuda, normal  # noqa: F401

from repro_torch.api import (CsrMatrix, Precision, RBFKernel, SketchConfig,
                             SketchedKRR)
from repro_torch.core import backends as tb
from repro_torch.core.leverage import draw_landmarks
from repro_torch.kernels import ops as kops

N, N_TEST, DIM, P = 3000, 500, 20, 96
BETA_TOL = {"float64": 1e-8, "float32": 2e-3}


def _data(dtype):
    X = normal((N + N_TEST, DIM), 0, dtype, DIM ** -0.5)
    y = np.sin(3.0 * X[:, 0]) + np.cos(2.0 * X[:, 1])
    return X[:N], y[:N].astype(dtype), X[N:]


def _cfg(dtype, **kw):
    prec = Precision(data_dtype="f32" if dtype == "float32" else "f64")
    kw.setdefault("device", "cuda")
    return SketchConfig(kernel=RBFKernel(1.0), p=P, lam=1e-3, seed=2,
                        precision=prec, **kw)


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _landmarks():
    return draw_landmarks(torch.Generator().manual_seed(1),
                          torch.full((N,), 1.0 / N), P).cuda()


def _pair(dtype, **kw):
    """(hopper-side model, torch model, launches of the hopper-side fit)."""
    X, y, _ = _data(dtype)
    idx = _landmarks()
    fast_backend = kw.pop("backend", "hopper")
    kops.reset_launch_counts()
    fast = SketchedKRR(_cfg(dtype, backend=fast_backend, **kw)).fit(
        X, y, score_landmarks=idx)
    counts = kops.launch_counts()
    kops.reset_launch_counts()
    plain = SketchedKRR(_cfg(dtype, backend="torch", **kw)).fit(
        X, y, score_landmarks=idx, sample=fast.sample())
    assert sum(kops.launch_counts().values()) == 0
    return fast, plain, counts


def _close_fits(fast, plain, dtype):
    _, _, Xt = _data(dtype)
    assert _rel(fast.state().beta, plain.state().beta) <= BETA_TOL[dtype]
    yf, yp = fast.predict(Xt), plain.predict(Xt)
    assert yf.is_cuda and bool(torch.isfinite(yf).all())
    err = float((yf - yp).abs().max() / yp.abs().max())
    assert err <= BETA_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_falkon_pcg_hopper_matches_torch(cuda, dtype):
    fast, plain, counts = _pair(dtype, solver="falkon_pcg")
    st = fast.state()
    # the score pass's columns, W, Csᵀy, one gram_matvec an iteration
    assert counts["kernel_block"] == st.iters + 3 and st.iters > 0
    assert counts["rls_scores"] == 1
    _close_fits(fast, plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("budget", [64.0, 0.05], ids=["polish", "sgd"])
def test_eigenpro_hopper_matches_torch(cuda, dtype, budget):
    fast, plain, counts = _pair(dtype, solver="eigenpro",
                                batch_budget_mb=budget)
    st = fast.state()
    assert st.iters == plain.state().iters
    assert counts["kernel_block"] >= 3 + st.iters
    _close_fits(fast, plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_streaming_fit_matches_torch(cuda, dtype):
    """The streamed fit against torch's dense one on the card (β and
    predictions), and its scores against the same streamed route on the
    CPU through the kernels' plain versions. In float32 the streamed route
    reads its float32 CᵀC through L⁻¹, so one rounding of the blocks moves
    its scores by 1.5e-4 at n = 20,000 (tools/iter_parity_probe.py, CPU);
    the bound is chip_smoke.ITER_PARITY_SCORES_TOL's."""
    fast, plain, counts = _pair(dtype, backend="streaming", block_rows=512)
    tiles = -(-N // 512)
    # W, then the two passes of the score pass and the solver's columns
    assert counts["kernel_block"] == 1 + 3 * tiles
    assert counts["rls_scores"] == 0
    X, y, _ = _data(dtype)
    sample = fast.sample()
    cpu = SketchedKRR(_cfg(dtype, backend="streaming", block_rows=512,
                           device="cpu")).fit(
        X, y, score_landmarks=_landmarks().cpu(),
        sample=type(sample)(*(a.cpu() for a in sample)))
    s_f, s_c = fast.scores().cpu(), cpu.scores()
    rtol = 1e-10 if dtype == "float64" else 2e-3
    assert float(((s_f - s_c).abs() / s_c.abs()).max()) <= rtol
    _close_fits(fast, plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_streaming_ops_tile_through_k1(cuda, dtype):
    X, _, _ = _data(dtype)
    Z = X[:P]
    rng = np.random.default_rng(3)
    v = rng.standard_normal((P, 2)).astype(dtype)
    u = rng.standard_normal((N, 2)).astype(dtype)
    ops = tb.ops_for(RBFKernel(1.0), "streaming", device="cuda",
                     block_rows=512)
    plain = tb.ops_for(RBFKernel(1.0), "torch", device="cpu")
    tiles = -(-N // 512)
    on = {k: torch.as_tensor(a, device="cuda") for k, a in
          dict(X=X, Z=Z, v=v, u=u).items()}
    off = {k: torch.as_tensor(a) for k, a in dict(X=X, Z=Z, v=v, u=u).items()}
    atol = 1e-10 if dtype == "float64" else 2e-4
    for name, call in [("cross", lambda o, a: o.cross(a["X"], a["Z"])),
                       ("matvec", lambda o, a: o.matvec(a["X"], a["Z"],
                                                        a["v"])),
                       ("rmatvec", lambda o, a: o.rmatvec(a["X"], a["Z"],
                                                          a["u"])),
                       ("gram_matvec", lambda o, a: o.gram_matvec(
                           a["X"], a["Z"], a["v"]))]:
        kops.reset_launch_counts()
        got = call(ops, on)
        assert kops.launch_counts()["kernel_block"] == tiles, name
        want = call(plain, off)
        scale = float(want.abs().max())
        close(got, want, rtol=0, atol=atol * max(scale, 1.0), err_msg=name)


@pytest.mark.cuda
def test_csr_falkon_out_of_core_launches_k3(cuda):
    """λ = 1e-2: at 1e-3 PCG on this system carries the blocks' last-bit
    differences forward to 1.1e-5 of β (measured on the card), as it does
    between the JAX package's own backends (tests/test_torch_iterative.py);
    the direct β with the same draws bounds both at the reference's 1e-3."""
    rng = np.random.default_rng(4)
    X = rng.random((N, 400)) * (rng.random((N, 400)) < 0.05)
    X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    y = X @ rng.standard_normal(400)
    cfg = SketchConfig(kernel=RBFKernel(1.0), p=P, lam=1e-2, seed=2,
                       device="cuda", chunk_rows=1024, solver="falkon_pcg")
    kops.reset_launch_counts()
    fast = SketchedKRR(cfg.replace(backend="hopper")).fit(
        CsrMatrix.from_dense(X), y)
    counts = kops.launch_counts()
    assert counts["sparse_cross"] == 3 * 3 and counts["kernel_block"] >= 1
    plain = SketchedKRR(cfg.replace(backend="torch")).fit(
        CsrMatrix.from_dense(X), y, sample=fast.sample())
    direct = SketchedKRR(cfg.replace(backend="torch",
                                     solver="nystrom_regularized")).fit(
        CsrMatrix.from_dense(X), y, sample=fast.sample())
    assert fast.state().iters > 0
    assert _rel(fast.state().beta, plain.state().beta) <= BETA_TOL["float64"]
    assert _rel(fast.state().beta, direct.state().beta) <= 1e-3
