"""The port's serve-plane primitives, ported from tests/test_serve.py:
``FifoQueue`` batch formation (fill, partial on timeout, deadline-aware
early serve, stop, kick, bounded depth), ``BatchPolicy`` buckets, the O(p)
serving state's export and import, ``solver_state_from_serving``,
``make_batched_predict`` and ``ModelSlot`` (a republish builds no new
function, snapshots are decoupled from the live estimator).

Torch only, on the CPU: the port's fits at tests/test_serve.py's size
(n = 400, d = 6, p = 32). Every wait has a timeout of 30 s or less and
every batch window is 50 ms or less; the tests that need a window longer
than that drive the queue with a clock that does not move.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.api import (NotFittedError, ServingState, SketchConfig,
                             SketchedKRR, solver_state_from_serving)
from repro_torch.api.solvers import SOLVERS
from repro_torch.core import RBFKernel
from repro_torch.serve import (BatchPolicy, FifoQueue, ModelSlot,
                               QueueFullError)


def _fit(solver="nystrom_regularized", seed=5, n=400, d=6, p=32):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d))
    y = np.sin(X[:, 0]) + 0.3 * X[:, 1]
    cfg = SketchConfig(kernel=RBFKernel(1.2), p=p, lam=1e-2, seed=seed,
                       sampler="rls_fast", solver=solver, device="cpu")
    return SketchedKRR(cfg).fit(X, y), X, y


@pytest.fixture(scope="module")
def fitted():
    return _fit()


class FrozenClock:
    """A clock that moves only when told to."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


# ------------------------------------------------------------- FifoQueue

def test_fifo_order_and_non_blocking_ops():
    q = FifoQueue()
    for i in range(5):
        q.push(i)
    assert len(q) == 5 and q.pop() == 0
    assert q.take(2) == [1, 2]
    assert q.oldest_age() is not None
    assert q.drain() == [3, 4]
    assert q.pop() is None and q.take(3) == [] and q.oldest_age() is None


def test_full_batch_returns_without_waiting_out_the_window():
    q = FifoQueue(clock=FrozenClock())      # the window can never elapse
    for i in range(4):
        q.push(i)
    assert q.next_batch(4, max_wait=0.05) == [0, 1, 2, 3]


def test_partial_batch_after_timeout():
    q = FifoQueue()
    q.push("a")
    t0 = time.monotonic()
    assert q.next_batch(8, max_wait=0.03) == ["a"]
    assert 0.02 <= time.monotonic() - t0 < 5.0


def test_deadline_forces_early_partial_batch():
    clock = FrozenClock()
    q = FifoQueue(clock=clock)
    q.push(("a", 0.004))                   # deadline inside the guard
    # the oldest item has waited 0 of a 10 s window; its deadline is
    # 4 ms away, under the 5 ms guard: serve now
    out = q.next_batch(8, max_wait=10.0, deadline_of=lambda it: it[1])
    assert out == [("a", 0.004)]


def test_stop_and_kick():
    q = FifoQueue()
    stop = threading.Event()
    stop.set()
    q.push(1)
    assert q.next_batch(4, 0.01, stop=stop) == [] and len(q) == 1
    q2 = FifoQueue()
    stop2 = threading.Event()
    got = []
    th = threading.Thread(target=lambda: got.append(
        q2.next_batch(4, 0.01, stop=stop2, idle_wait=30.0)))
    th.start()
    time.sleep(0.02)
    stop2.set()
    q2.kick()                              # wakes the 30 s idle wait
    th.join(5.0)
    assert not th.is_alive() and got == [[]]


def test_bounded_queue_sheds_at_max_depth():
    q = FifoQueue(max_depth=2)
    q.push(1)
    q.push(2)
    with pytest.raises(QueueFullError, match="max_depth=2"):
        q.push(3)
    assert q.drain() == [1, 2]
    with pytest.raises(ValueError, match="max_depth"):
        FifoQueue(max_depth=0)


# ------------------------------------------------------------ BatchPolicy

def test_batch_policy_buckets_and_validation():
    pol = BatchPolicy(max_batch=64)
    assert [pol.bucket_for(k) for k in (1, 2, 3, 5, 33, 64)] == \
        [1, 2, 4, 8, 64, 64]
    ex = BatchPolicy(max_batch=8, buckets=(2, 8))
    assert [ex.bucket_for(k) for k in (1, 2, 3, 8)] == [2, 2, 8, 8]
    assert BatchPolicy(max_batch=8).bucket_for(3, n_shards=3) == 6
    for kw, match in [({"max_batch": 0}, "max_batch"),
                      ({"max_wait_ms": -1.0}, "max_wait_ms"),
                      ({"buckets": (8, 4)}, "ascending"),
                      ({"max_batch": 16, "buckets": (4, 8)}, "largest"),
                      ({"max_queue_depth": 0}, "max_queue_depth")]:
        with pytest.raises(ValueError, match=match):
            BatchPolicy(**kw)
    with pytest.raises(ValueError, match="k >= 1"):
        pol.bucket_for(0)


# --------------------------------------------- serving state, batched

@pytest.mark.parametrize("solver", ["nystrom", "nystrom_regularized",
                                    "falkon_pcg"])
def test_serving_state_round_trip_predicts_bit_equal(solver):
    model, X, _ = _fit(solver=solver)
    other = SketchedKRR(model.config).import_serving_state(
        model.export_serving_state())
    Xq = X[:37]
    assert torch.equal(other.predict(Xq), model.predict(Xq))
    assert torch.equal(other.predict_batched(Xq, 16),
                       model.predict_batched(Xq, 16))
    state = solver_state_from_serving(model.export_serving_state())
    assert state.approx is None and state.alpha is None
    got = SOLVERS.get(solver).predict(model.config, state,
                                      torch.as_tensor(Xq))
    assert torch.equal(got, model.predict(Xq))


def test_serving_state_refusals(fitted):
    model, X, y = fitted
    exact, _, _ = _fit(solver="exact")
    with pytest.raises(TypeError, match="make_batched_predict"):
        exact.export_serving_state()
    with pytest.raises(ValueError, match="not portable"):
        SketchedKRR(model.config.replace(solver="nystrom")
                    ).import_serving_state(model.export_serving_state())
    with pytest.raises(NotFittedError):
        SketchedKRR(model.config).export_serving_state()
    imported = SketchedKRR(model.config).import_serving_state(
        model.export_serving_state())
    assert isinstance(model.export_serving_state(), ServingState)
    with pytest.raises(RuntimeError, match="training factor"):
        imported.risk(y, 0.1)
    with pytest.raises(NotFittedError, match="sampler diagnostics"):
        imported.scores()


def test_make_batched_predict_is_cached_until_the_next_fit(fitted):
    model, X, y = fitted
    fn = model.make_batched_predict()
    assert model.make_batched_predict() is fn
    Xb = torch.as_tensor(X[:16])
    assert torch.equal(fn(Xb), model.predict(Xb))
    assert torch.equal(model.predict_batched(X[:21], 8),
                       model.predict(X[:21]))
    refit = _fit()[0]
    f2 = refit.make_batched_predict()
    refit.fit(X, y)
    assert refit.make_batched_predict() is not f2
    with pytest.raises(NotFittedError):
        SketchedKRR(model.config).make_batched_predict()


# ------------------------------------------------------------- ModelSlot

def test_slot_versions_and_empty_slot_is_loud(fitted):
    model, _, _ = fitted
    empty = ModelSlot()
    assert empty.version == 0
    with pytest.raises(RuntimeError, match="no published model"):
        empty.current()
    slot = ModelSlot(model)
    assert slot.version == 1
    assert slot.publish(model) == 2
    assert slot.current().version == 2
    with pytest.raises(ValueError, match="exceeds bucket"):
        slot.current().predict_padded(np.zeros((5, 6)), 4)


def test_republish_builds_no_new_predict(fitted):
    # the state is an argument of one function per config: a hot swap of
    # the same config builds nothing
    model, X, y = fitted
    slot = ModelSlot(model)
    fn1 = slot.current().predict_fn
    refreshed = _fit()[0]
    refreshed.partial_fit(X[:200], y[:200]).finalize()
    slot.publish(refreshed)
    assert slot.current().predict_fn is fn1
    assert slot.current().state is not None
    # dnc has no O(p) dual: it serves through make_batched_predict
    dnc, _, _ = _fit(solver="dnc")
    dslot = ModelSlot(dnc)
    assert dslot.current().state is None
    Xq = X[:5]
    np.testing.assert_array_equal(dslot.current().predict_padded(Xq, 8),
                                  dnc.predict_batched(Xq, 8).numpy())


def test_snapshot_is_decoupled_from_the_live_estimator():
    model, X, y = _fit()
    slot = ModelSlot(model)
    frozen = slot.current()
    Xq = np.asarray(X[:16])
    before = frozen.predict_padded(Xq, 16)
    np.testing.assert_array_equal(before, model.predict(Xq).numpy())
    model.partial_fit(X[:200], y[:200])
    model.finalize()
    np.testing.assert_array_equal(frozen.predict_padded(Xq, 16), before)
    slot.publish(model)
    after = slot.current().predict_padded(Xq, 16)
    assert not np.array_equal(after, before)   # the refresh is real
    # a row's result depends only on that row at a fixed bucket
    np.testing.assert_array_equal(
        slot.current().predict_padded(Xq[3:4], 16)[0], after[3])


def test_unfitted_model_fails_fast_at_publish(fitted):
    model, _, _ = fitted
    with pytest.raises(NotFittedError):
        ModelSlot(SketchedKRR(model.config))
