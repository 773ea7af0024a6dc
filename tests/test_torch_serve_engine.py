"""The port's ``AsyncServeEngine``, ``BackgroundRefresher`` and
``KRRServeEngine``, ported from tests/test_serve.py: parity with the
estimator, fill-or-timeout batches, deadlines (a miss is descriptive,
never a drop), shedding, multi-model routing with a fallback, a loud stop,
the hot swap end to end, and one parity case against the JAX package's own
serve plane (f64, 1e-10).

The port's fits run on the CPU at tests/test_serve.py's size. Every
``Future.result``, ``join`` and wait has a timeout of 30 s or less, and
every batch window is 50 ms or less: the tests that need a longer window
drive the engine with a clock that moves only when the test moves it.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_common import F64_TOL, close, normal

from repro.api import SketchConfig as JConfig
from repro.api import SketchedKRR as JKRR
from repro.core import RBFKernel as JRBF
from repro.serve import ModelSlot as JModelSlot
from repro_torch.api import (SketchConfig, SketchedKRR,
                             serving_state_from_reference)
from repro_torch.core import RBFKernel
from repro_torch.runtime import KRRRequest, KRRServeEngine
from repro_torch.serve import (AsyncServeEngine, BackgroundRefresher,
                               BatchPolicy, DeadlineMissError,
                               EngineStoppedError, ModelSlot, QueueFullError,
                               UnknownModelError)

TIMEOUT = 30.0


def _cfg(seed=5, solver="nystrom_regularized"):
    return SketchConfig(kernel=RBFKernel(1.2), p=32, lam=1e-2, seed=seed,
                        sampler="rls_fast", solver=solver, device="cpu")


def _data(n=400, d=6):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d))
    return X, np.sin(X[:, 0]) + 0.3 * X[:, 1]


@pytest.fixture(scope="module")
def fitted():
    X, y = _data()
    return SketchedKRR(_cfg()).fit(X, y), X


class ManualClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _one(model, x):
    return float(model.predict(x[None])[0])


def test_serves_everything_with_estimator_parity(fitted):
    model, X = fitted
    with AsyncServeEngine(model, policy=BatchPolicy(max_batch=8,
                                                    max_wait_ms=2.0)) as eng:
        futs = [eng.submit(X[i]) for i in range(30)]
        got = np.array([f.result(TIMEOUT).y_hat for f in futs])
    close(got, model.predict(X[:30]), rtol=1e-12, atol=1e-12)
    stats = eng.stats()
    assert stats.served == 30 and stats.misses == 0 and stats.shed == 0
    assert stats.p50() <= stats.p99() and sum(stats.batch_sizes) == 30
    assert set(stats.buckets) <= {1, 2, 4, 8}


def test_fill_or_timeout(fitted):
    """A partial batch leaves when its window elapses; a full one leaves at
    once, whatever the window (here the clock never moves, so only the
    fill can release it)."""
    model, X = fitted
    with AsyncServeEngine(model, policy=BatchPolicy(
            max_batch=8, max_wait_ms=30.0)) as eng:
        for f in [eng.submit(X[i]) for i in range(3)]:
            f.result(TIMEOUT)
    assert eng.stats().batch_sizes == [3]
    eng = AsyncServeEngine(model, policy=BatchPolicy(max_batch=4,
                                                     max_wait_ms=50.0),
                           clock=ManualClock())
    futs = [eng.submit(X[i]) for i in range(4)]
    with eng:
        for f in futs:
            f.result(TIMEOUT)
    assert eng.stats().batch_sizes == [4]


def test_deadlines_are_met_early_or_missed_loudly(fitted):
    model, X = fitted
    clock = ManualClock()
    eng = AsyncServeEngine(model, clock=clock)       # not started yet
    doomed = eng.submit(X[0], deadline_ms=20.0)
    alive = eng.submit(X[1])                         # no deadline
    clock.now += 0.08                                # expires while queued
    with eng:
        with pytest.raises(DeadlineMissError) as exc:
            doomed.result(TIMEOUT)
        assert alive.result(TIMEOUT).y_hat == pytest.approx(
            _one(model, X[1]), rel=1e-12)
    msg = str(exc.value)
    assert "missed its deadline" in msg and "waited 80.0 ms" in msg
    assert "budget" in msg and "max_wait_ms" in msg
    assert eng.stats().misses == 1
    # a window that never elapses (frozen clock) must not sit on a deadline
    # that is already inside the guard: the batch leaves at once
    eng = AsyncServeEngine(model, policy=BatchPolicy(max_batch=64,
                                                     max_wait_ms=50.0),
                           clock=ManualClock())
    with eng:
        res = eng.submit(X[0], deadline_ms=4.0).result(TIMEOUT)
    assert res.y_hat == pytest.approx(_one(model, X[0]), rel=1e-12)
    assert eng.stats().misses == 0


def test_multi_model_routing_and_fallback(fitted):
    m_a, X = fitted
    m_b = SketchedKRR(_cfg(seed=11)).fit(*_data())
    x = X[0]
    with AsyncServeEngine({"a": m_a, "b": m_b}) as eng:
        ra = eng.predict(x, model="a", timeout=TIMEOUT)
        rb = eng.predict(x, model="b", timeout=TIMEOUT)
        assert (ra.model, rb.model) == ("a", "b") and ra.y_hat != rb.y_hat
        assert ra.y_hat == pytest.approx(_one(m_a, x), rel=1e-12)
        with pytest.raises(UnknownModelError, match="'a', 'b'"):
            eng.submit(x, model="nope").result(TIMEOUT)
        with pytest.raises(UnknownModelError, match="needs model="):
            eng.submit(x).result(TIMEOUT)
        assert eng.publish(m_b, key="shadow") == 1
        assert eng.predict(x, model="shadow", timeout=TIMEOUT).model == \
            "shadow"
        with pytest.raises(ValueError, match="ambiguous"):
            eng.publish(m_a)
    assert eng.models() == {"a": 1, "b": 1, "shadow": 1}
    with AsyncServeEngine({"prod": m_a}, fallback_model="prod") as eng:
        assert eng.predict(x, model="typo", timeout=TIMEOUT).model == "prod"
    with pytest.raises(ValueError, match="fallback_model"):
        AsyncServeEngine({"prod": m_a}, fallback_model="ghost")
    with pytest.raises(ValueError, match="at least one"):
        AsyncServeEngine({})


def test_stop_fails_queued_requests_and_depth_sheds(fitted):
    model, X = fitted
    eng = AsyncServeEngine(model)          # never started: nothing drains
    futs = [eng.submit(X[i]) for i in range(3)]
    eng.stop()
    for f in futs:
        with pytest.raises(EngineStoppedError, match="still queued"):
            f.result(TIMEOUT)
    eng = AsyncServeEngine(model, policy=BatchPolicy(max_queue_depth=2))
    kept = [eng.submit(X[i]) for i in range(2)]
    shed = [eng.submit(X[i]) for i in range(2, 5)]
    for f in shed:                         # shed fail at once...
        with pytest.raises(QueueFullError, match="max_depth=2"):
            f.result(TIMEOUT)
    with eng:                              # ...kept ones still serve
        got = [f.result(TIMEOUT).y_hat for f in kept]
    close(got, model.predict(X[:2]), rtol=1e-12, atol=1e-12)
    assert (eng.stats().shed, eng.stats().served) == (3, 2)


def test_dnc_and_exact_serve_through_the_batched_predict():
    X, y = _data(200)
    for solver in ("dnc", "exact"):
        model = SketchedKRR(_cfg(solver=solver)).fit(X, y)
        with AsyncServeEngine(model) as eng:
            got = [eng.predict(X[i], timeout=TIMEOUT).y_hat
                   for i in range(3)]
        close(got, model.predict(X[:3]), rtol=1e-12, atol=1e-12)


def test_continuous_serving_across_published_swaps():
    """The hot swap end to end: concurrent submissions while a background
    partial_fit → finalize refresher publishes three swaps — every response
    bit-equal to the published model its result names, none dropped, no
    deadline missed."""
    rng = np.random.default_rng(42)
    n, d, chunk = 400, 6, 100
    X = rng.normal(size=(n, d))
    y = np.sin(X[:, 0]) + 0.3 * X[:, 1]
    chunks = [(X[i:i + chunk], y[i:i + chunk]) for i in range(0, n, chunk)]
    model = SketchedKRR(_cfg())
    model.partial_fit(*chunks[0])
    model.finalize()
    # a replica replays the refresher's chunks to capture every version's
    # dual (partial_fit → finalize is deterministic), served by a probe
    # slot at the engine's one bucket
    replica = SketchedKRR(_cfg())
    probes = {}
    for v, (Xc, yc) in enumerate(chunks, start=1):
        replica.partial_fit(Xc, yc)
        replica.finalize()
        probes[v] = ModelSlot(SketchedKRR(_cfg()).import_serving_state(
            replica.export_serving_state()))
    BUCKET = 16
    policy = BatchPolicy(max_batch=BUCKET, max_wait_ms=2.0,
                         buckets=(BUCKET,), default_deadline_ms=5_000.0)
    Xq = rng.normal(size=(60, d))
    with AsyncServeEngine(model, policy=policy) as eng:
        wave_a = [f.result(TIMEOUT) for f in
                  [eng.submit(Xq[i]) for i in range(12)]]
        refresher = BackgroundRefresher(eng, model)
        refresher.start(chunks[1:])
        futs = []
        for i in range(12, 48):
            futs.append(eng.submit(Xq[i]))
            time.sleep(0.002)
        wave_b = [f.result(TIMEOUT) for f in futs]
        refresher.join(timeout=TIMEOUT)
        wave_c = [f.result(TIMEOUT) for f in
                  [eng.submit(Xq[i]) for i in range(48, 60)]]
    results = wave_a + wave_b + wave_c
    assert refresher.versions == [2, 3, 4]
    assert all(r.version == 1 for r in wave_a)
    assert all(r.version == 4 for r in wave_c)
    for i, r in enumerate(results):
        want = probes[r.version].current().predict_padded(Xq[i][None],
                                                          BUCKET)[0]
        assert r.y_hat == float(want), (i, r.version)
    stats = eng.stats()
    assert stats.misses == 0 and stats.served == 60
    assert set(stats.buckets) == {BUCKET} and eng.models()["default"] == 4


def test_krr_serve_engine_drains_in_fixed_micro_batches(fitted):
    model, X = fitted
    eng = KRRServeEngine(model, batch_size=16)
    assert eng.batch_size == 16 and eng.serve_dtype is None
    for i in range(37):
        eng.submit(KRRRequest(i, X[i]))
    done = eng.run()
    assert [r.uid for r in done] == list(range(37))
    assert all(r.done for r in done)
    close([r.y_hat for r in done], model.predict_batched(X[:37], 16),
          rtol=0, atol=0)
    refreshed = SketchedKRR(_cfg()).partial_fit(X[:100], _data()[1][:100])
    assert eng.publish(refreshed.finalize()) == 2
    eng.submit(KRRRequest(99, X[0]))
    assert eng.step()[0].y_hat == float(refreshed.predict_batched(
        X[:1], 16)[0])
    assert eng.step() == []


def test_reference_serving_state_served_by_the_port_engine():
    """A JAX fit's O(p) serving state, served by the port's engine, against
    the JAX package's own PublishedModel.predict_padded (f64). The fit is
    tests/test_torch_estimator.py's uniform / nystrom_regularized cell."""
    X = normal((377, 4), 0)
    y = np.sin(2.0 * X[:300, 0]) + 0.3 * X[:300, 1] ** 2
    common = dict(p=40, lam=1e-3, p_scores=50, seed=0, sampler="uniform",
                  solver="nystrom_regularized")
    ref = JKRR(JConfig(kernel=JRBF(1.5), backend="xla", **common)).fit(
        jnp.asarray(X[:300]), jnp.asarray(y))
    serving = ref.export_serving_state()
    port = SketchedKRR(SketchConfig(RBFKernel(1.5), device="cpu", **common)
                       ).import_serving_state(serving_state_from_reference(
                           {k: (None if v is None else np.asarray(v))
                            for k, v in serving._asdict().items()},
                           device="cpu"))
    Xq = X[300:]
    want = np.concatenate([JModelSlot(ref).current().predict_padded(
        Xq[i:i + 32], 32) for i in range(0, 77, 32)])
    with AsyncServeEngine(port, policy=BatchPolicy(
            max_batch=32, buckets=(32,), max_wait_ms=5.0)) as eng:
        futs = [eng.submit(Xq[i]) for i in range(77)]
        got = [f.result(TIMEOUT).y_hat for f in futs]
    close(got, want, **F64_TOL)
    close(ModelSlot(port).current().predict_padded(Xq[:32], 32), want[:32],
          **F64_TOL)
    assert torch.is_tensor(port.state().beta)
