"""K2 ``rls_scores`` of the PyTorch port against the JAX package.

On the CPU the port's wrapper takes its plain version; these tests hold it
against the reference's Pallas kernel in interpret mode and its jnp oracle.
Tolerances (tests/_torch_common.py): 1e-10 at float64, rtol 2e-4 on
float32 scores, because the two frameworks sum in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_common import DTYPES, close, normal, t, tol

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

SHAPES = [(300, 90), (257, 129), (8, 8)]


def _scores_problem(n, p, dtype):
    B = normal((n, p), 2, "float64", p ** -0.5)
    M = np.linalg.inv(B.T @ B + n * 1e-3 * np.eye(p))
    return B.astype(dtype), M


@pytest.mark.parametrize("n,p", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_plain_matches_pallas_interpret(dtype, n, p):
    # M arrives in float64 even for float32 B, as the pallas backend's
    # scores_given_gram hands it over; both sides read it in f32 then
    B, M = _scores_problem(n, p, dtype)
    got = ops.rls_scores(t(B), t(M))
    assert got.dtype == getattr(torch, dtype) and got.shape == (n,)
    close(got, jops.rls_scores(jnp.asarray(B), jnp.asarray(M)),
          **tol(dtype, scores=True))
    close(got, jref.rls_scores_ref(jnp.asarray(B),
                                   jnp.asarray(M.astype(dtype))),
          **tol(dtype, scores=True))
