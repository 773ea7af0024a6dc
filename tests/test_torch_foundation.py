"""The PyTorch port's foundation against the JAX package: kernels
(``gram``/``diag``), sparse-input refusal, and the precision policy.
Tolerances (tests/_torch_common.py): 1e-10 at float64, 2e-5 at float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from _torch_common import DTYPES, close, t, tol
from _torch_ops_cases import KERNELS, inputs, kernels

from repro.core import precision as jp
from repro_torch.core import kernels as tk
from repro_torch.core import precision as tp
from repro_torch.data import CsrMatrix


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_gram_and_diag_match_reference(name, dtype):
    jker, tker = kernels(name)
    X, Z, *_ = inputs(name, dtype)
    close(tker.gram(t(X), t(Z)),
          jax.jit(jker.gram)(jnp.asarray(X), jnp.asarray(Z)), **tol(dtype))
    close(tker.diag(t(X)), jax.jit(jker.diag)(jnp.asarray(X)), **tol(dtype))
    assert tker.diag(t(X)).dtype == getattr(torch, dtype)


def test_sparse_inputs_name_their_roadmap_item():
    # ROADMAP item 8 is ported: CSR rows are a CsrMatrix, which the kernels
    # evaluate without densifying; PyTorch's own sparse layouts are refused
    # with a pointer to it
    X = torch.eye(4, dtype=torch.float64)
    csr = CsrMatrix.from_dense(X).cast()
    assert torch.equal(tk.RBFKernel().gram(csr, X), tk.RBFKernel().gram(X, X))
    with pytest.raises(NotImplementedError, match="CsrMatrix"):
        tk.RBFKernel().gram(X.to_sparse(), X)


# -------------------------------------------------------------- precision

@pytest.mark.parametrize("dtype", ["float64", "float32", "float16",
                                   "bfloat16"])
def test_jitter_floors_match_reference(dtype):
    assert tp.dtype_jitter_floor(dtype) == pytest.approx(
        jp.dtype_jitter_floor(jnp.dtype(dtype)), rel=1e-12)
    for jitter in (0.0, 1e-10, 1e-2):
        assert tp.floored_jitter(jitter, dtype) == pytest.approx(
            jp.floored_jitter(jitter, jnp.dtype(dtype)), rel=1e-12)
        assert tp.storage_floored_jitter(jitter, dtype) == pytest.approx(
            jp.storage_floored_jitter(jitter, jnp.dtype(dtype)), rel=1e-12)


POLICIES = [dict(), dict(accum_dtype="f64"), dict(solve_dtype="fp32"),
            dict(data_dtype="bf16", serve_dtype="f32")]


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_precision_resolutions_match_reference(policy):
    tpol, jpol = tp.Precision(**policy), jp.Precision(**policy)
    assert tpol.is_default == jpol.is_default

    def name(dt):
        return None if dt is None else str(jnp.dtype(dt) if not isinstance(
            dt, torch.dtype) else dt).removeprefix("torch.")

    assert name(tpol.data()) == name(jpol.data())
    assert name(tpol.serve()) == name(jpol.serve())
    for dtype in ("float64", "float32", "bfloat16"):
        assert name(tpol.accum_for(dtype)) == name(jpol.accum_for(dtype))
        assert name(tpol.solve_for(dtype)) == name(jpol.solve_for(dtype))
    assert dataclasses.asdict(tpol) == dataclasses.asdict(jpol)
    assert (dataclasses.asdict(tpol.for_serving())
            == dataclasses.asdict(jpol.for_serving()))
    with pytest.raises(ValueError):
        tp.Precision(accum_dtype="int32")
