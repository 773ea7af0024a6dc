"""The samplers, the divide-and-conquer solver and the serve plane on the
card: ``hopper`` against ``torch`` with the same draws, and the engine's
answers against ``predict``.

Every test here is marked ``cuda`` and skips where there is no GPU; no JAX
import (run with ``--noconftest -m cuda``, see tests/test_torch_cuda.py).
The launch counts show that the hopper side took K1 (with f64
accumulation for the bless stages: ``widen_bless_accum``) and K2's mixed
build. Tolerances: float64 1e-10; float32 scores rtol 2e-4 (K2's), float32
predictions 2e-3 relative to their largest magnitude (chip_smoke's
PARITY_TOL reasoning at a tenth of its margin, as
tests/test_torch_cuda_iterative.py holds them).
"""
import numpy as np
import pytest
import torch
from _torch_common import cuda, normal  # noqa: F401

from repro_torch.api import Precision, RBFKernel, SketchConfig, SketchedKRR
from repro_torch.core import bless as tbless
from repro_torch.core.backends import ops_for
from repro_torch.kernels import ops as kops
from repro_torch.serve import AsyncServeEngine, BatchPolicy, ModelSlot

pytestmark = pytest.mark.cuda

N, N_TEST, DIM, P = 3000, 500, 20, 96


def _data(dtype):
    X = normal((N + N_TEST, DIM), 0, dtype, DIM ** -0.5)
    y = np.sin(3.0 * X[:, 0]) + np.cos(2.0 * X[:, 1])
    return X[:N], y[:N].astype(dtype), X[N:]


def _cfg(dtype, **kw):
    prec = Precision(data_dtype="f32" if dtype == "float32" else "f64")
    return SketchConfig(kernel=RBFKernel(1.0), p=P, lam=1e-3, seed=2,
                        precision=prec, device="cuda", **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bless_stages_on_the_card_match_torch(cuda, dtype, monkeypatch):
    """Three bless stages through hopper (K1 with f64 accumulation and K2's
    mixed build for float32 data), then through torch with hopper's stage
    dictionaries injected."""
    X, _, _ = _data(dtype)
    Xc = torch.as_tensor(X, device=cuda)
    dicts = []
    inner = tbless.fast_ridge_leverage

    def recording(*a, **kw):
        out = inner(*a, **kw)
        dicts.append(out.landmarks)
        return out
    monkeypatch.setattr(tbless, "fast_ridge_leverage", recording)
    kops.reset_launch_counts()
    hop = tbless.bless_leverage(RBFKernel(1.0), Xc, 5e-4,
                                torch.Generator().manual_seed(1),
                                stages=3, q_max=P,
                                ops=ops_for(RBFKernel(1.0), "hopper"))
    counts = kops.launch_counts()
    plain = tbless.bless_leverage(RBFKernel(1.0), Xc, 5e-4, stages=3,
                                  q_max=P,
                                  ops=ops_for(RBFKernel(1.0), "torch"),
                                  dictionaries=list(dicts))
    assert counts["kernel_block"] == 3 and counts["rls_scores"] == 3
    rtol = 1e-10 if dtype == "float64" else 2e-4
    torch.testing.assert_close(hop.scores, plain.scores, rtol=rtol,
                               atol=1e-12)
    assert [s.dict_size for s in hop.stages] == \
        [s.dict_size for s in plain.stages]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_samplers_and_dnc_on_the_card_match_torch(cuda, dtype):
    X, y, Xt = _data(dtype)
    for kw in (dict(sampler="bless", solver="nystrom_regularized"),
               dict(sampler="recursive_rls"),
               dict(solver="dnc", partitions=5)):
        kops.reset_launch_counts()
        fast = SketchedKRR(_cfg(dtype, backend="hopper", **kw)).fit(X, y)
        counts = kops.launch_counts()
        extra = {}
        if kw.get("solver") == "dnc":
            extra["partitions"] = fast.state().model.partitions
        plain = SketchedKRR(_cfg(dtype, backend="torch", **kw)).fit(
            X, y, sample=None if kw.get("solver") == "dnc"
            else fast.sample(), **extra)
        assert counts["kernel_block"] >= 1
        if kw.get("solver") != "dnc":
            assert counts["rls_scores"] >= 1
        y_h, y_t = fast.predict(Xt), plain.predict(Xt)
        err = float((y_h - y_t).abs().max() / y_t.abs().max())
        assert err <= (1e-10 if dtype == "float64" else 2e-3), (kw, err)


def test_engine_on_the_card_answers_like_predict(cuda):
    X, y, Xt = _data("float32")
    model = SketchedKRR(_cfg("float32")).fit(X, y)
    slot = ModelSlot(model)
    entry = slot.current()
    kops.reset_launch_counts()
    with AsyncServeEngine(model, policy=BatchPolicy(
            max_batch=64, buckets=(64,), max_wait_ms=2.0)) as eng:
        futs = [eng.submit(Xt[i]) for i in range(200)]
        got = np.array([f.result(30).y_hat for f in futs])
    stats = eng.stats()
    assert kops.launch_counts()["kernel_block"] == stats.batches
    want = model.predict(Xt[:200]).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-3 * np.abs(want).max())
    # a row's answer depends only on that row at a fixed bucket
    for i in (0, 17, 199):
        assert got[i] == float(entry.predict_padded(Xt[i][None], 64)[0])
