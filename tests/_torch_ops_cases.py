"""Shared inputs of the ``KernelOps`` parity tests of the PyTorch port
(tests/test_torch_backends.py, tests/test_torch_backends_pallas.py,
tests/test_torch_foundation.py): 4 kernels × {f32, f64} at n = 301,
p = 37, the non-tile-aligned cell of tests/test_backends.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_common import close, tol

from repro.core import kernels as jk
from repro.core import ops_for as jops_for
from repro_torch.core import backends as tb
from repro_torch.core import kernels as tk

N, P_COLS, DIM, LAM = 301, 37, 5, 1e-3
KERNELS = {
    "linear": ({}, "LinearKernel"),
    "rbf": (dict(bandwidth=1.3), "RBFKernel"),
    # scale ≈ dim keeps poly values O(1), as in tests/test_backends.py
    "poly": (dict(degree=2, scale=float(DIM), offset=0.7),
             "PolynomialKernel"),
    "bernoulli": (dict(b=1), "BernoulliKernel"),
}


def kernels(name):
    kw, cls = KERNELS[name]
    return getattr(jk, cls)(**kw), getattr(tk, cls)(**kw)


def inputs(name, dtype):
    rng = np.random.default_rng(0)
    if name == "bernoulli":   # 1-D kernel on [0, 1]
        X, Z = rng.uniform(size=(N, 1)), rng.uniform(size=(P_COLS, 1))
    else:
        X, Z = rng.standard_normal((N, DIM)), rng.standard_normal((P_COLS, DIM))
    idx = rng.integers(0, N, P_COLS)
    v, u = rng.standard_normal(P_COLS), rng.standard_normal(N)
    # the scores take a well-conditioned factor: the raw columns of a
    # rank-5 linear kernel make the f32 fused form cancel to 2e-3 in JAX's
    # own pallas-vs-xla comparison, which would test the problem, not code
    B = rng.standard_normal((N, P_COLS)) / np.sqrt(P_COLS)
    return tuple(a.astype(dtype) for a in (X, Z, v, u, B)) + (idx,)


def _run(ops, arr, X, Z, v, u, B, idx):
    """Every protocol op of one executor on one input set."""
    X, Z, v, u, B = arr(X), arr(Z), arr(v), arr(u), arr(B)
    return dict(cross=ops.cross(X, Z), columns=ops.columns(X, arr(idx)),
                matvec=ops.matvec(X, Z, v), rmatvec=ops.rmatvec(X, Z, u),
                leverage_scores=ops.leverage_scores(B, LAM, N),
                scores_given_gram=ops.scores_given_gram(B, B.T @ B, LAM, N))


@functools.lru_cache(maxsize=None)
def _reference(name, dtype, backend):
    ops = jops_for(kernels(name)[0], backend)
    run = jax.jit(lambda *a: _run(ops, lambda x: x, *a))
    out = run(*(jnp.asarray(a) for a in inputs(name, dtype)))
    return {k: np.asarray(v) for k, v in out.items()}


def check_against_reference(name, dtype, port_backend, jax_backend):
    """Every protocol op of the port's executor against the reference's."""
    _, tker = kernels(name)
    got = _run(tb.ops_for(tker, port_backend, device="cpu"),
               torch.as_tensor, *inputs(name, dtype))
    want = _reference(name, dtype, jax_backend)
    for op, value in got.items():
        assert value.dtype == getattr(torch, dtype), op
        close(value, want[op], err_msg=op,
              **tol(dtype, scores=op.endswith("scores")
                    or op == "scores_given_gram"))
