"""K1 ``kernel_block`` of the PyTorch port against the JAX package.

On the CPU the port's kernel wrappers take their plain versions, so these
tests hold that arithmetic (``repro_torch.kernels.ops``) against the
reference's Pallas kernel run in interpret mode, as
tests/test_kernels_pallas.py runs it, and against the reference's jnp
oracles. Tolerances (tests/_torch_common.py): 1e-10 at float64, atol 2e-5
on float32 blocks, because the two frameworks sum in different orders.
K2 is tests/test_torch_rls_scores.py; the kernels themselves are held
against their plain versions on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import pytest
import torch
from _torch_common import DTYPES, close, normal, t, tol

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

SHAPES = [(300, 90, 17), (257, 129, 33), (8, 8, 1)]
KINDS = {"rbf": dict(bandwidth=1.3), "linear": {},
         "poly": dict(degree=3, scale=1.0, offset=0.7)}


def _xz(n, p, d, dtype):
    # N(0, 1/d) rows keep every kind's values O(1), so one absolute
    # tolerance per dtype is meaningful
    return (normal((n, d), 0, dtype, d ** -0.5),
            normal((p, d), 1, dtype, d ** -0.5))


def _port_block(kind, X, Z):
    fn = {"rbf": ops.rbf_block, "linear": ops.linear_block,
          "poly": ops.poly_block}[kind]
    return fn(X, Z, **KINDS[kind])


def _jax_block(kind, X, Z):
    fn = {"rbf": jops.rbf_block, "linear": jops.linear_block,
          "poly": jops.poly_block}[kind]
    return fn(X, Z, **KINDS[kind])


@pytest.mark.parametrize("n,p,d", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_k1_plain_matches_pallas_interpret(kind, dtype, n, p, d):
    X, Z = _xz(n, p, d, dtype)
    got = _port_block(kind, t(X), t(Z))
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, p)
    close(got, _jax_block(kind, jnp.asarray(X), jnp.asarray(Z)), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_plain_matches_jnp_oracle(dtype):
    X, Z = _xz(300, 90, 17, dtype)
    oracle = {"rbf": lambda x, z: jref.rbf_block_ref(x, z, 1.3),
              "linear": jref.linear_block_ref,
              "poly": lambda x, z: jref.poly_block_ref(x, z, 3, 1.0, 0.7)}
    for kind, fn in oracle.items():
        close(_port_block(kind, t(X), t(Z)),
              fn(jnp.asarray(X), jnp.asarray(Z)), err_msg=kind, **tol(dtype))


def test_acc_dtype_override_widens_plain_arithmetic():
    X, Z = _xz(64, 16, 9, "float32")
    wide = ops.rbf_block(t(X), t(Z), bandwidth=1.3, acc_dtype="float64")
    assert wide.dtype == torch.float32
    expect = ref.rbf_block_ref(t(X).double(), t(Z).double(), 1.3).float()
    assert torch.equal(wide, expect)
