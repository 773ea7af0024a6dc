"""Kernel functions k(x, x') and kernel matrices (dense tensors).

Every kernel exposes a pairwise ``gram(X, Z)`` (the n×m cross kernel
matrix) and a ``diag(X)`` (K_ii, needed by the Theorem-4 squared-length
sampler p_i = K_ii / Tr(K)). These are the plain PyTorch formulas: the
``torch`` backend calls them directly, and the ``hopper`` backend replaces
the rbf/linear/poly blocks with the ``kernel_block`` CUDA kernel.

Kernels implemented:
  * ``LinearKernel``          k(x,z) = x.z
  * ``RBFKernel``             k(x,z) = exp(-||x-z||^2 / (2 h^2))
  * ``PolynomialKernel``      k(x,z) = (x.z / h + c)^d
  * ``BernoulliKernel``       the paper's synthetic-experiment kernel on [0,1]:
        k(x,z) = B_{2b}(x - z - floor(x - z)) / (2b)!

A ``CsrMatrix`` left operand (a sparse row block against a dense (p, d)
landmark block Z) takes the plain sparse contraction
(``kernels.ref.sparse_kernel_block_ref``) for linear, rbf and poly; the
``hopper`` backend replaces it with the K3 ``sparse_cross`` CUDA kernel.
``BernoulliKernel`` has no sparse evaluation and raises.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Protocol

import torch
from torch import Tensor

from ..data.sparse import CsrMatrix
from ..kernels.ref import sparse_kernel_block_ref


class Kernel(Protocol):
    def gram(self, X: Tensor, Z: Tensor) -> Tensor: ...

    def diag(self, X: Tensor) -> Tensor: ...


def _sparse_lhs(X, Z) -> CsrMatrix | None:
    """The CSR left operand of a sparse×dense block, else None. Sparse
    blocks are always k(X_csr, Z) with Z the dense (p, d) landmark block;
    PyTorch's own sparse layouts are refused, pointing at ``CsrMatrix``."""
    if any(getattr(a, "layout", torch.strided) != torch.strided
           for a in (X, Z)):
        raise NotImplementedError(
            "PyTorch sparse tensors are not kernel operands; pass the rows "
            "as a repro_torch.data.CsrMatrix (CsrMatrix.from_scipy / "
            "from_dense) or as a dense tensor")
    if isinstance(Z, CsrMatrix):
        raise NotImplementedError(
            "sparse right-hand kernel operands are not supported: blocks "
            "are k(X, Z) with Z a dense (p, d) landmark block — densify "
            "it (CsrMatrix.todense() / CsrMatrix[idx]) or keep landmarks "
            "dense")
    return X if isinstance(X, CsrMatrix) else None


def _sparse_block(X: CsrMatrix, Z: Tensor, kind: str, **params) -> Tensor:
    return sparse_kernel_block_ref(X.data, X.indices, X.indptr, Z, kind=kind,
                                   **params)


def _sparse_row_sqnorms(X: CsrMatrix) -> Tensor:
    # imported here: kernels.sparse_block imports core (precision), so a
    # module-level import would make importing it first a cycle
    from ..kernels.sparse_block import sparse_row_sqnorms
    return sparse_row_sqnorms(X.data, X.indptr)


def _sqdist(X: Tensor, Z: Tensor) -> Tensor:
    """Pairwise squared euclidean distances, numerically clamped at 0."""
    xx = torch.sum(X * X, dim=-1)[:, None]
    zz = torch.sum(Z * Z, dim=-1)[None, :]
    return torch.clamp_min(xx + zz - 2.0 * (X @ Z.T), 0.0)


@dataclasses.dataclass(frozen=True)
class LinearKernel:
    def gram(self, X: Tensor, Z: Tensor) -> Tensor:
        xs = _sparse_lhs(X, Z)
        if xs is not None:
            return _sparse_block(xs, Z, "linear")
        return X @ Z.T

    def diag(self, X: Tensor) -> Tensor:
        if isinstance(X, CsrMatrix):
            return _sparse_row_sqnorms(X)
        return torch.sum(X * X, dim=-1)


@dataclasses.dataclass(frozen=True)
class RBFKernel:
    bandwidth: float = 1.0

    def gram(self, X: Tensor, Z: Tensor) -> Tensor:
        xs = _sparse_lhs(X, Z)
        if xs is not None:
            return _sparse_block(xs, Z, "rbf", bandwidth=self.bandwidth)
        return torch.exp(-_sqdist(X, Z) / (2.0 * self.bandwidth**2))

    def diag(self, X: Tensor) -> Tensor:
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device)


@dataclasses.dataclass(frozen=True)
class PolynomialKernel:
    degree: int = 2
    scale: float = 1.0
    offset: float = 1.0

    def gram(self, X: Tensor, Z: Tensor) -> Tensor:
        xs = _sparse_lhs(X, Z)
        if xs is not None:
            return _sparse_block(xs, Z, "poly", degree=self.degree,
                                 scale=self.scale, offset=self.offset)
        return (X @ Z.T / self.scale + self.offset) ** self.degree

    def diag(self, X: Tensor) -> Tensor:
        if isinstance(X, CsrMatrix):
            sq = _sparse_row_sqnorms(X)
            return (sq / self.scale + self.offset) ** self.degree
        return (torch.sum(X * X, dim=-1) / self.scale
                + self.offset) ** self.degree


@functools.lru_cache(maxsize=None)
def _bernoulli_poly_coeffs(m: int) -> tuple[float, ...]:
    """Coefficients (ascending powers) of the Bernoulli polynomial B_m(x):
    B_m(x) = Σ_k C(m,k) B_{m-k} x^k with B_j the Bernoulli numbers."""
    B = [1.0]
    for j in range(1, m + 1):
        s = 0.0
        for k in range(j):
            s += math.comb(j + 1, k) * B[k]
        B.append(-s / (j + 1))
    return tuple(math.comb(m, k) * B[m - k] for k in range(m + 1))


_NO_SPARSE_BERNOULLI = (
    "BernoulliKernel is a scalar grid kernel with no sparse evaluation; use "
    "linear/rbf/poly for CsrMatrix inputs")


@dataclasses.dataclass(frozen=True)
class BernoulliKernel:
    """k(x,z) = B_{2b}(frac(x - z)) * (-1)^{b-1} / (2b)! on scalars in [0,1]
    — the reproducing kernel of the periodic Sobolev space with b
    square-integrable derivatives (PSD for all b)."""

    b: int = 1

    def _k1d(self, d: Tensor) -> Tensor:
        m = 2 * self.b
        frac = d - torch.floor(d)
        acc = torch.zeros_like(frac)
        for c in reversed(_bernoulli_poly_coeffs(m)):
            acc = acc * frac + c
        sign = (-1.0) ** (self.b - 1)
        return sign * acc / math.factorial(m)

    def gram(self, X: Tensor, Z: Tensor) -> Tensor:
        if isinstance(X, CsrMatrix) or isinstance(Z, CsrMatrix):
            raise NotImplementedError(_NO_SPARSE_BERNOULLI)
        return self._k1d(X.reshape(-1)[:, None] - Z.reshape(-1)[None, :])

    def diag(self, X: Tensor) -> Tensor:
        if isinstance(X, CsrMatrix):
            raise NotImplementedError(_NO_SPARSE_BERNOULLI)
        return self._k1d(torch.zeros_like(X.reshape(-1)))


def gram_matrix(kernel: Kernel, X: Tensor, Z: Tensor | None = None) -> Tensor:
    """Full (or cross) kernel matrix. O(n m d) — use only for n,m ≲ 10^4."""
    return kernel.gram(X, X if Z is None else Z)


def kernel_columns(kernel: Kernel, X: Tensor, idx: Tensor, *,
                   ops=None) -> Tensor:
    """C = K[:, idx] — only the sampled columns, never forming K (§3.5).

    ``ops`` is an optional ``KernelOps`` executor; when omitted this is the
    dense plain evaluation."""
    if ops is not None:
        return ops.columns(X, idx)
    return kernel.gram(X, X[idx])
