"""The PyTorch port end to end against the JAX package: fit → predict.

The reference fits at n = 300 (RBF, float64, the ``xla`` backend); its
Theorem-3 column draw (``sample()``) and, for ``rls_fast``, its Theorem-4
score-pass landmarks are injected into the port's fit, since PyTorch
cannot reproduce JAX's random streams. β (α for ``exact``), ``predict``,
``predict_batched`` and the sampler's scores must then agree to 1e-10, the
bar tests/test_backends.py sets between the JAX backends. Also here: the
reference's exported serving state served by the port, and the port's
device and configuration rules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_common import close, normal, t, tol

from repro.api import SketchConfig as JConfig
from repro.api import SketchedKRR as JKRR
from repro.core import RBFKernel as JRBF
from repro.core.leverage import draw_landmarks as jdraw_landmarks
from repro_torch.api import (ColumnSample, RBFKernel, SketchConfig,
                             SketchedKRR, serving_state_from_reference)
from repro_torch.kernels import ops as kops

N, N_TEST, DIM, P, P_SCORES, H, LAM = 300, 77, 4, 40, 50, 1.5, 1e-3
CELLS = [("rls_fast", "exact"), ("rls_fast", "nystrom"),
         ("rls_fast", "nystrom_regularized"),
         ("uniform", "nystrom_regularized"),
         ("diagonal", "nystrom_regularized"),
         ("rls_exact", "nystrom_regularized")]
F64 = tol("float64")


def _data():
    X = normal((N + N_TEST, DIM), 0)
    y = np.sin(2.0 * X[:, 0]) + 0.3 * X[:, 1] ** 2 + 0.1 * normal(N + N_TEST, 1)
    return X[:N], y[:N], X[N:]


def _configs(sampler, solver, **port):
    common = dict(p=P, lam=LAM, p_scores=P_SCORES, seed=0, sampler=sampler,
                  solver=solver)
    return (JConfig(kernel=JRBF(H), backend="xla", **common),
            SketchConfig(kernel=RBFKernel(H), device="cpu", **common, **port))


def _reference_draws(ref_model, X):
    """The reference fit's column sample and rls_fast score landmarks."""
    sample = ColumnSample(*(t(a) for a in ref_model.sample()))
    key_sample, _ = jax.random.split(jax.random.key(0))
    kd, _ = jax.random.split(key_sample)
    landmarks = jdraw_landmarks(kd, jnp.full((N,), 1.0 / N), P_SCORES)
    return sample, t(landmarks)


def _fit_pair(sampler, solver, **port):
    X, y, Xt = _data()
    jcfg, cfg = _configs(sampler, solver, **port)
    ref = JKRR(jcfg).fit(jnp.asarray(X), jnp.asarray(y))
    sample, landmarks = _reference_draws(ref, X)
    model = SketchedKRR(cfg).fit(X, y, sample=sample,
                                 score_landmarks=landmarks)
    return ref, model, Xt


@pytest.mark.parametrize("sampler,solver", CELLS)
def test_fit_predict_matches_reference(sampler, solver):
    ref, model, Xt = _fit_pair(sampler, solver)
    dual = "alpha" if solver == "exact" else "beta"
    close(getattr(model.state(), dual), getattr(ref.state(), dual), **F64)
    close(model.predict(Xt), ref.predict(jnp.asarray(Xt)), **F64)
    close(model.predict_batched(Xt, batch_size=32),
          ref.predict_batched(jnp.asarray(Xt), batch_size=32), **F64)
    close(model.scores(), ref.scores(), **F64)


def test_main_path_through_hopper_backend_on_cpu():
    """The default path with backend "hopper": on CPU tensors its kernel
    calls take the plain versions, launch nothing, and agree with the
    reference."""
    kops.reset_launch_counts()
    ref, model, Xt = _fit_pair("rls_fast", "nystrom", backend="hopper")
    assert model.ops().name == "hopper"
    close(model.state().beta, ref.state().beta, **F64)
    close(model.predict_batched(Xt, batch_size=32), ref.predict(
        jnp.asarray(Xt)), **F64)
    assert kops.launch_counts() == {"kernel_block": 0, "rls_scores": 0,
                                    "sparse_cross": 0,
                                    "flash_attention": 0}


@pytest.mark.parametrize("solver", ["nystrom", "nystrom_regularized"])
def test_reference_serving_state_serves_identically(solver):
    X, y, Xt = _data()
    jcfg, cfg = _configs("rls_fast", solver)
    ref = JKRR(jcfg).fit(jnp.asarray(X), jnp.asarray(y))
    exported = ref.export_serving_state()
    fields = {"beta": np.asarray(exported.beta),
              "landmarks": np.asarray(exported.landmarks),
              "col_weights": (None if exported.col_weights is None
                              else np.asarray(exported.col_weights)),
              "solver": exported.solver}
    served = SketchedKRR(cfg).import_serving_state(
        serving_state_from_reference(fields, device="cpu"))
    close(served.predict(Xt), ref.predict(jnp.asarray(Xt)), **F64)
    close(served.predict_batched(Xt, batch_size=16),
          ref.predict(jnp.asarray(Xt)), **F64)
    with pytest.raises(RuntimeError, match="training factor"):
        served.predict_train()


def test_own_draws_are_seeded_and_predict_train_matches_predict():
    X, y, _ = _data()
    _, cfg = _configs("rls_fast", "nystrom_regularized")
    a, b = SketchedKRR(cfg).fit(X, y), SketchedKRR(cfg).fit(X, y)
    assert torch.equal(a.sample().idx, b.sample().idx)
    close(a.predict_train(), a.predict(X), **F64)
    report = a.risk(np.sin(2.0 * X[:, 0]), 0.1)
    assert float(report.risk) == pytest.approx(
        float(report.bias_sq + report.variance))


def test_export_import_roundtrip_and_guards():
    X, y, Xt = _data()
    _, cfg = _configs("rls_fast", "nystrom")
    model = SketchedKRR(cfg).fit(X, y)
    served = SketchedKRR(cfg).import_serving_state(
        model.export_serving_state())
    assert torch.equal(served.predict(Xt), model.predict(Xt))
    with pytest.raises(ValueError, match="not portable"):
        SketchedKRR(cfg.replace(solver="nystrom_regularized")
                    ).import_serving_state(model.export_serving_state())
    exact = SketchedKRR(cfg.replace(solver="exact")).fit(X, y)
    with pytest.raises(TypeError, match="no O\\(p\\) landmark dual"):
        exact.export_serving_state()


# ------------------------------------------------- device and config rules

def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SketchConfig(RBFKernel(), p=4)
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SketchedKRR(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_state_from_reference(
            {"beta": np.zeros(2), "landmarks": np.zeros((2, 1)),
             "solver": "nystrom"})


def test_auto_resolves_to_torch_on_cpu():
    assert SketchedKRR(SketchConfig(RBFKernel(), p=4, device="cpu")
                       ).ops().name == "torch"


@pytest.mark.parametrize("field,name,match", [
    ("solver", "distributed", "ROADMAP item 9"),
    ("backend", "sharded", "ROADMAP item 9"),
    ("backend", "pallas", "JAX backend"),
    ("backend", "xla", "JAX backend"),
])
def test_unported_entries_are_refused_at_construction(field, name, match):
    with pytest.raises(ValueError, match=match):
        SketchConfig(RBFKernel(), p=4, device="cpu", **{field: name})
    # the samplers and the solver of ROADMAP item 7 are ported
    for kw in ({"sampler": "bless"}, {"sampler": "recursive_rls"},
               {"solver": "dnc"}):
        SketchConfig(RBFKernel(), p=4, device="cpu", **kw)
