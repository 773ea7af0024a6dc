"""The arithmetic of the port's CUDA kernels, emulated in plain torch on the
CPU and held against the JAX package (the kernels themselves are checked on
the card, in tests/test_torch_cuda*.py).

K2 ``rls_scores``' bf16 build runs B·M on the tensor cores as two TF32
products: a bf16 value is a TF32 value exactly, so B has no low part, and
M is split into M_hi (its 13 low mantissa bits cleared) and the TF32 value
of M − M_hi (the tensor cores read a register's top 19 bits). Every such
product is exact in float32; ``k2_bf16_emulation`` repeats them, summed in
float64, where the card sums in float32 (that error is measured on the card,
``chip_smoke.py`` phase ``limits``).

K3 ``sparse_cross`` splits the landmarks' feature columns (``prepare_landmarks``):
a hot column's values add v·(its dense Zᵀ row) into one accumulator, every
other value scatters v·z over the non-zeros of Z in its column into a
second, each in CSR order, and the two are summed at the end.
``k3_split_emulation`` repeats that order over the port's own prepared
landmarks (mul, then add: the CPU rounds the product where the card fuses
it). With no hot column, or every column hot, the order is the plain
version's (``ref.sparse_cross_ref``, which adds v·z for every z, zeros
included, in CSR order), and the two agree bit for bit; with a split they
agree with the XLA reference within 1e-10 (float64) or 1e-5 (float32,
tests/test_sparse.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_common import F64_TOL, close

from repro.kernels import sparse_block as jsb
from repro.kernels.rls_scores import rls_scores_fused as jrls_scores
from repro_torch.data import CsrMatrix
from repro_torch.kernels import ops, ref, sparse_block
from repro_torch.kernels.sparse_block import SLAB, prepare_landmarks

# two slabs of landmarks, the second ragged; D within the float64 table's
# 80 hot columns (max_hot), so that every column is hot unless MAX_HOT is
# lowered
N, D, P = 157, 30, 300
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "float64": F64_TOL}


def _csr_and_landmarks(dtype):
    """N CSR rows over D columns at 15 % density (every 10th row empty,
    9 NaN padding slots past indptr[-1]), and P landmarks that are rows of
    another such matrix, densified, as the sparse path's are; the columns'
    frequencies fall off, so a few columns hold most of Z's non-zeros."""
    rng = np.random.default_rng(0)
    freq = 0.6 / np.arange(1, D + 1) ** 0.7

    def rows(n):
        X = rng.normal(size=(n, D))
        X[rng.random(X.shape) > freq[rng.permutation(D)][None, :]] = 0.0
        return X

    X = rows(N)
    X[::10] = 0.0
    c = CsrMatrix.from_dense(X)
    data = np.concatenate([c.data, np.full(9, np.nan)]).astype(dtype)
    indices = np.concatenate([c.indices, np.zeros(9, np.int32)])
    return data, indices.astype(np.int32), c.indptr, rows(P).astype(dtype)


def k3_split_emulation(data, indices, indptr, L):
    """K3's cross product X·Zᵀ in plain torch, in the kernel's order: for
    each CSR position t, every row's t-th value in turn, into the hot or
    the other accumulator, summed at the end."""
    S = L.slabs
    n_rows = indptr.shape[0] - 1
    acc_hot = torch.zeros((n_rows, L.ld), dtype=L.acc)
    acc_other = torch.zeros((n_rows, L.ld), dtype=L.acc)
    # every list entry's landmark: its (column, slab) key gives the slab
    n_ent = L.ent_j.shape[0]
    key = torch.searchsorted(L.colptr, torch.arange(n_ent, dtype=torch.int32),
                             right=True) - 1
    landmark = (key % S) * SLAB + L.ent_j
    lengths = indptr[1:] - indptr[:-1]
    for t in range(int(lengths.max())):
        rows = torch.nonzero(lengths > t)[:, 0]
        k = indptr[rows] + t
        col = indices[k].long()
        v = data[k].to(L.acc)
        slot = L.hot_slot[col].long()
        hot = slot >= 0
        acc_hot[rows[hot]] += v[hot, None] * L.hot[slot[hot]]
        r, c, vo = rows[~hot], col[~hot], v[~hot]
        a, b = L.colptr[c * S].long(), L.colptr[(c + 1) * S].long()
        cnt = b - a
        first = torch.repeat_interleave(a - (torch.cumsum(cnt, 0) - cnt), cnt)
        e = first + torch.arange(int(cnt.sum()))
        acc_other.index_put_((torch.repeat_interleave(r, cnt), landmark[e]),
                             torch.repeat_interleave(vo, cnt) * L.ent_z[e],
                             accumulate=True)
    return (acc_hot + acc_other)[:, :L.Z.shape[0]]


@pytest.mark.parametrize("split", ["none_hot", "all_hot", "some_hot"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k3_split_arithmetic_matches_reference(dtype, split, monkeypatch):
    data, indices, indptr, Z = _csr_and_landmarks(dtype)
    d, i, ptr, z = (torch.as_tensor(a) for a in (data, indices, indptr, Z))
    cap = {"none_hot": 0, "some_hot": 8}.get(split)
    if cap is not None:
        monkeypatch.setattr(sparse_block, "MAX_HOT", cap)
    L = prepare_landmarks(z)
    nonzero_cols = int(((z != 0).sum(0) > 0).sum())
    assert L.hot.shape == ({"none_hot": 0, "all_hot": nonzero_cols,
                            "some_hot": 8}[split], 2 * SLAB)
    # the lists hold exactly the non-zeros of Z outside the hot columns
    hot_cols = torch.nonzero(L.hot_slot >= 0)[:, 0]
    other = z.clone()
    other[:, hot_cols] = 0
    assert L.ent_z.shape[0] == int((other != 0).sum())
    close(L.zz, torch.sum(z * z, dim=1), **TOL[dtype])
    got = k3_split_emulation(d, i, ptr, L)
    want = jsb.sparse_cross(jnp.asarray(data), jnp.asarray(indices),
                            jnp.asarray(indptr), jnp.asarray(Z))
    assert got.dtype == getattr(torch, dtype) and got.shape == (N, P)
    close(got, want, **TOL[dtype])
    if split != "some_hot":
        assert torch.equal(got, ref.sparse_cross_ref(d, i, ptr, z))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from a float32 register: its 13
    low mantissa bits cleared."""
    return (x.view(torch.int32) & -(1 << 13)).view(torch.float32)


def k2_bf16_emulation(B: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """K2's bf16 build before its bf16 rounding, in float64: B·M_hi +
    B·tf32(M − M_hi), folded with B row by row."""
    hi = tf32(M)
    lo = tf32(M - hi)
    Bw = B.double()
    T = Bw @ hi.double() + Bw @ lo.double()
    return torch.sum(T * Bw, dim=1)


def test_k2_bf16_two_tf32_products_match_reference():
    """Before rounding, the two products are within 2⁻²⁰ of the exact
    scores' scale Σ_jk |B_ij M_jk B_ik| (M_lo's truncation); rounded to
    bf16, they are the Pallas kernel's bf16 scores (interpret mode) and
    the port's plain version's, within K2's bf16 tolerance (rtol 2⁻⁷ +
    2e-4, atol 1e-6: one bf16 step beyond the float32 check)."""
    rng = np.random.default_rng(2)
    n_rows, p = 157, 300
    Bf = torch.as_tensor(rng.standard_normal((n_rows, p)) / np.sqrt(p),
                         dtype=torch.float32).to(torch.bfloat16)
    G = Bf.double().T @ Bf.double()
    M = torch.linalg.inv(G + n_rows * 1e-3 * torch.eye(p,
                                                       dtype=torch.float64))
    M = M.to(torch.float32)
    got = k2_bf16_emulation(Bf, M)
    Bw, Mw = Bf.double(), M.double()
    exact = torch.sum((Bw @ Mw) * Bw, dim=1)
    scale = torch.sum((Bw.abs() @ Mw.abs()) * Bw.abs(), dim=1)
    assert torch.all((got - exact).abs() <= 2.0 ** -20 * scale)
    bf = got.to(torch.float32).to(torch.bfloat16)
    want = jrls_scores(jnp.asarray(Bf.float().numpy()).astype(jnp.bfloat16),
                       jnp.asarray(M.numpy()), interpret=True)
    assert want.dtype == jnp.bfloat16
    tol = dict(rtol=2.0 ** -7 + 2e-4, atol=1e-6)
    close(bf.float(), np.asarray(want, np.float32), **tol)
    plain = ops.rls_scores(Bf, M)
    assert plain.dtype == torch.bfloat16
    close(bf.float(), plain.float(), **tol)
