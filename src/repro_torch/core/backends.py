"""KernelOps: pluggable executors for every kernel-matrix touch.

The paper's pipeline only ever needs p columns of K, so all kernel
evaluation flows through one seam, a ``KernelOps`` object. Samplers,
solvers and ``SketchedKRR.predict``/``predict_batched`` take their kernel
blocks from the backend configured on ``SketchConfig``.

The protocol (all shapes: X (n, d), Z (p, d), B (n, p)):

  ``columns(X, idx)``        C = K[:, idx] ∈ R^{n×p} — the §3.5 column block.
  ``cross(X_test, Z)``       k(X_test, Z) ∈ R^{m×p} — test/landmark block.
  ``matvec(X, Z, v)``        k(X, Z) @ v — the serving path.
  ``rmatvec(X, Z, v)``       k(X, Z)ᵀ @ v.
  ``gram_matvec(X, Z, v)``   k(X, Z)ᵀ (k(X, Z) @ v).
  ``leverage_scores(B,λ,n)`` l̃_i = B_i (BᵀB + nλI)^{-1} B_iᵀ — eq. (9).

Registered backends:

  ``torch``   the plain reference: one PyTorch expression per block, on
              whatever device the tensors live. Direct ``kernel.gram``
              calls live only here.
  ``hopper``  routes rbf/linear/poly blocks to the hand-written K1
              ``kernel_block`` and the eq.-(9) scores to K2 ``rls_scores``
              (``repro_torch.kernels``). On CUDA tensors the kernels launch
              or raise; on CPU tensors the same calls take the kernels'
              plain versions. Kernels without a kernel body (bernoulli)
              use the dense formula per block.
  ``streaming`` ``hopper``'s tiles over ``block_rows``-row blocks of X, so
              no compute intermediate is larger than O(block_rows·p):
              ``matvec``/``rmatvec``/``gram_matvec`` and the Theorem-4
              ``score_pass`` never form C or B. A CSR X is one direct
              block (K3 is nnz-tiled already).

``backend="auto"`` resolves per device: CUDA → ``hopper``, CPU → ``torch``.

Every executor carries a ``Precision`` policy: blocks are materialized in
the data dtype, reductions run in ``accum_dtype``, the p×p factorizations
in ``solve_dtype``.

A ``CsrMatrix`` row block is a valid X wherever Z is dense: ``torch`` takes
the plain sparse contraction through ``kernel.gram``, ``hopper`` launches
K3 ``sparse_cross`` for rbf/linear/poly. K3 works from landmarks prepared
once per Z: ``prepare_sparse(Z)`` makes the preparation (None where a
backend needs none) and ``cross``, ``score_pass_chunk_gram`` and
``score_pass_chunk_scores`` take it as ``prepared=``.

The chunked Theorem-4 seam (``score_pass_dtypes``,
``score_pass_chunk_gram``, ``score_pass_chunk_scores`` and the p×p
``score_pass_core`` between its two passes) is what the out-of-core driver
(``repro_torch.api.out_of_core``) runs per chunk. An executor with
``streams_score_pass`` runs the whole pass itself (``score_pass``), and
``fast_ridge_leverage`` then returns ‖B_i‖² in place of B.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from ..data.sparse import CsrMatrix
from ..registry import Registry
from .kernels import Kernel, LinearKernel, PolynomialKernel, RBFKernel
from .precision import (Precision, floored_jitter,
                        storage_floored_jitter)


# row tile of the streaming executor (SketchConfig.block_rows)
DEFAULT_BLOCK_ROWS = 4096


# ------------------------------------------------------- shared p×p algebra

def _eye(p: int, like: Tensor) -> Tensor:
    return torch.eye(p, dtype=like.dtype, device=like.device)


def _jittered(W: Tensor, jitter: float) -> Tensor:
    p = W.shape[0]
    jitter = floored_jitter(jitter, W.dtype)
    return 0.5 * (W + W.T) + jitter * (torch.trace(W) / p + 1.0) * _eye(p, W)


def jittered_cholesky_ex(W: Tensor, jitter: float) -> tuple[Tensor, Tensor]:
    """(L, info) for L Lᵀ = ½(W + Wᵀ) + jitter′·(tr(W)/p + 1)·I; ``info``
    is non-zero when the factorization failed (L is then unusable).

    jitter′ is the requested jitter floored at the dtype-aware minimum
    (``precision.dtype_jitter_floor``) — the reference's one jitter
    convention for every landmark-overlap factorization."""
    return torch.linalg.cholesky_ex(_jittered(W, jitter))


def landmark_cholesky(W: Tensor, jitter: float, *,
                      solve_dtype=None) -> Tensor:
    """L with L Lᵀ the jittered landmark overlap W, factored in
    ``solve_dtype`` (None: W's dtype) — the factor of the Theorem-4 score
    pass, in memory and chunked.

    The first factorization is the reference's (jitter floored at a
    sub-f32 storage dtype only). Only when it fails is W factored again
    with the jitter floored at W's storage dtype: a W built from float32
    columns carries float32 rounding, and with a duplicated landmark (draws
    are with replacement) its smallest eigenvalue is negative at that scale
    (−3.6e-8 at p = 64), which the float64 floor of ~2e-10 cannot absorb
    (ROADMAP fault R1 of the reference). Healthy cells never take the
    second factorization, so they stay identical to the reference."""
    Ws = W if solve_dtype is None else W.to(solve_dtype)
    jitter = storage_floored_jitter(jitter, W.dtype)
    Lchol, info = jittered_cholesky_ex(Ws, jitter)
    if int(info):
        Lchol, info = jittered_cholesky_ex(Ws, floored_jitter(jitter, W.dtype))
        if int(info):
            raise torch.linalg.LinAlgError(
                "landmark overlap W is not positive definite even with the "
                f"jitter floored at its storage dtype {W.dtype}")
    return Lchol


def jittered_cholesky(W: Tensor, jitter: float) -> Tensor:
    """L with L Lᵀ = ½(W + Wᵀ) + jitter′·(tr(W)/p + 1)·I; raises when the
    jittered matrix is not positive definite."""
    return torch.linalg.cholesky(_jittered(W, jitter))


def scores_against_gram(B: Tensor, G: Tensor, lam: float, n: int, *,
                        solve_dtype=None) -> Tensor:
    """Rows of B scored against a precomputed Gram G = BᵀB (eq. 9 split):
    A = ½(G + Gᵀ) + nλI = L Lᵀ and l̃_i = ‖L⁻¹B_iᵀ‖². ``solve_dtype``
    up-casts the factorization and the solve; scores come back in B's
    dtype."""
    p = B.shape[1]
    out_dtype = B.dtype
    if solve_dtype is not None:
        B, G = B.to(solve_dtype), G.to(solve_dtype)
    A = 0.5 * (G + G.T) + n * lam * _eye(p, B)
    Lchol = torch.linalg.cholesky(A)
    V = torch.linalg.solve_triangular(Lchol, B.T, upper=False)   # (p, n)
    return torch.sum(V * V, dim=0).to(out_dtype)


def reference_leverage_scores(B: Tensor, lam: float, n: int) -> Tensor:
    """l̃_i = B_i (BᵀB + nλI)^{-1} B_iᵀ — the plain eq.-(9) evaluation."""
    return scores_against_gram(B, B.T @ B, lam, n)


def score_pass_core(Lc: Tensor, CtC: Tensor, lam: float, n: int) -> Tensor:
    """The p×p algebra between the two chunked Theorem-4 passes.

    Given the jittered landmark Cholesky L_c (W ≈ L_c L_cᵀ) and the
    accumulated CᵀC, returns L_a with L_a L_aᵀ = A = L_c⁻¹ (CᵀC) L_c⁻ᵀ + nλI,
    the matrix every per-chunk score evaluation solves against: O(p²)
    state, independent of n.

    A is never formed: L_a = L_c⁻¹ chol(M) for the congruent
    M = CᵀC + nλ·L_c L_cᵀ, which does not amplify CᵀC's storage rounding
    by 1/jitter in W's near-null directions as factoring A would. When —
    and only when — that clean factorization fails (CᵀC's accumulation
    noise exceeds nλ·λ_min(W)), M is factored again with a ridge at that
    noise scale, eps(CᵀC's dtype)·(tr(CᵀC) + 1). The reference computes
    both factors and picks the rescue when the clean one holds a NaN; here
    the second factorization runs only when ``cholesky_ex`` reports the
    failure, with the same result."""
    p = Lc.shape[0]
    C2 = CtC.to(Lc.dtype)
    sym = 0.5 * (C2 + C2.T)
    M = sym + (n * lam) * (Lc @ Lc.T)
    Lm, info = torch.linalg.cholesky_ex(M)
    if int(info):
        ridge = torch.finfo(CtC.dtype).eps * (torch.trace(sym) + 1.0)
        Lm = torch.linalg.cholesky(M + ridge * _eye(p, M))
    return torch.linalg.solve_triangular(Lc, Lm, upper=False)


def _to(a, dtype: torch.dtype):
    """A tensor or ``CsrMatrix`` with its values in ``dtype``."""
    return a.astype(dtype) if isinstance(a, CsrMatrix) else a.to(dtype)


# ------------------------------------------------------------- the protocol

@dataclasses.dataclass(frozen=True)
class KernelOps:
    """Base executor: a kernel bound to a precision policy.

    Subclasses override ``cross`` (the one primitive every block derives
    from) and whichever derived ops they can do better than the generic
    compositions below.
    """

    kernel: Kernel
    precision: Precision = Precision()

    name = "base"
    streams_score_pass = False

    # ------------------------------------------------- precision plumbing

    def _cast_data(self, *arrays: Tensor) -> tuple[Tensor, ...]:
        """Arrays in the policy's data (block) dtype; no-op when unset."""
        dd = self.precision.data()
        if dd is None:
            return arrays
        return tuple(_to(a, dd) for a in arrays)

    def _accum(self, dtype):
        """Accumulation dtype for reductions over ``dtype`` (or None)."""
        return self.precision.accum_for(dtype)

    def _solve(self, dtype):
        """p×p factorization dtype for ``dtype`` data (or None)."""
        return self.precision.solve_for(dtype)

    def _gram(self, X: Tensor, Z: Tensor) -> Tensor:
        """One kernel block under the accumulation policy: arithmetic in
        ``accum_dtype``, result materialized in the inputs' dtype."""
        block = torch.promote_types(X.dtype, Z.dtype)
        acc = self._accum(block)
        if acc is None:
            return self.kernel.gram(X, Z)
        return self.kernel.gram(_to(X, acc), Z.to(acc)).to(block)

    # ------------------------------------------------------- the protocol

    def cross(self, X_test: Tensor, Z: Tensor, *, prepared=None) -> Tensor:
        """k(X_test, Z) ∈ R^{m×p}; concrete backends implement it.
        ``prepared`` is ``prepare_sparse(Z)``, used for CSR ``X_test``."""
        raise NotImplementedError

    def prepare_sparse(self, Z: Tensor):
        """Z prepared once for CSR blocks against it, handed back to
        ``cross(..., prepared=)``; None where the backend needs none."""
        return None

    def columns(self, X: Tensor, idx: Tensor) -> Tensor:
        """C = K[:, idx] — only the sampled columns, never forming K."""
        return self.cross(X, X[idx])

    def _contract(self, Kb: Tensor, v: Tensor) -> tuple[Tensor, Tensor]:
        """Kb and v in one dtype: ``accum_dtype`` when the policy sets it,
        else their promotion, as ``jnp`` promotes ``bf16 @ f32`` to f32 (a
        bf16 block meets a wider dual on the quantized serve path and under
        bf16 storage)."""
        dt = torch.promote_types(Kb.dtype, v.dtype)
        acc = self._accum(dt)
        dt = dt if acc is None else acc
        return Kb.to(dt), v.to(dt)

    def matvec(self, X: Tensor, Z: Tensor, v: Tensor) -> Tensor:
        """k(X, Z) @ v — contraction in ``accum_dtype`` when set."""
        Kb, v = self._contract(self.cross(X, Z), v)
        return Kb @ v

    def rmatvec(self, X: Tensor, Z: Tensor, v: Tensor) -> Tensor:
        """k(X, Z)ᵀ @ v."""
        Kb, v = self._contract(self.cross(X, Z), v)
        return Kb.T @ v

    def gram_matvec(self, X: Tensor, Z: Tensor, v: Tensor) -> Tensor:
        """k(X, Z)ᵀ (k(X, Z) @ v) — one CᵀC·v pass, CᵀC never formed."""
        Kb, v = self._contract(self.cross(X, Z), v)
        return Kb.T @ (Kb @ v)

    def leverage_scores(self, B: Tensor, lam: float, n: int) -> Tensor:
        """l̃_i = B_i (BᵀB + nλI)^{-1} B_iᵀ; the Gram accumulates in
        ``accum_dtype`` under the policy."""
        acc = self._accum(B.dtype)
        if acc is None:
            G = B.T @ B
        else:
            Bw = B.to(acc)          # one widened copy of B, not two
            G = Bw.T @ Bw
            del Bw
        return self.scores_given_gram(B, G, lam, n)

    def scores_given_gram(self, B: Tensor, G: Tensor, lam: float,
                          n: int) -> Tensor:
        """Rows of B scored against an externally supplied Gram G = BᵀB."""
        return scores_against_gram(B, G, lam, n,
                                   solve_dtype=self._solve(B.dtype))

    # ---------------------------------------- chunked Theorem-4 seam
    # The score pass splits into two passes over row chunks with only p×p
    # state between them (``score_pass_core``); these are the per-chunk
    # bodies the out-of-core driver runs, each holding O(chunk_rows·p).

    def score_pass_dtypes(self, dtype) -> tuple[torch.dtype, torch.dtype]:
        """(accum, solve) dtypes of the chunked pass for ``dtype`` blocks:
        the policy's resolutions, with ``dtype`` where they leave it."""
        acc, sd = self._accum(dtype), self._solve(dtype)
        return (dtype if acc is None else acc, dtype if sd is None else sd)

    def score_pass_chunk_gram(self, xb, mask: Tensor, Z: Tensor,
                              accum_dtype, *, prepared=None) -> Tensor:
        """One chunk's CᵀC, p×p in ``accum_dtype``. k(x, z) ≠ 0 for a
        zero-padded row, so the mask multiplies the block before the
        reduction: padded rows are exact zeros in every precision."""
        Cb = (self.cross(xb, Z, prepared=prepared)
              * mask[:, None]).to(accum_dtype)
        return Cb.T @ Cb

    def score_pass_chunk_scores(self, xb, Z: Tensor, Lc: Tensor, La: Tensor,
                                *, prepared=None) -> tuple[Tensor, Tensor]:
        """One chunk's (scores, ‖B_i‖²): the chunk's C block again, read
        through two triangular solves against the ``score_pass_core``
        factors, in xb's dtype."""
        Cb = self.cross(xb, Z, prepared=prepared)
        Bt = torch.linalg.solve_triangular(Lc, Cb.T.to(Lc.dtype), upper=False)
        V = torch.linalg.solve_triangular(La, Bt, upper=False)
        return (torch.sum(V * V, dim=0).to(Cb.dtype),
                torch.sum(Bt * Bt, dim=0).to(Cb.dtype))


BACKENDS: Registry[type] = Registry("backend")


@BACKENDS.register("torch")
@dataclasses.dataclass(frozen=True)
class TorchOps(KernelOps):
    """Plain reference: one PyTorch expression per block — the only place
    outside ``core/kernels.py`` where ``kernel.gram`` is called."""

    name = "torch"

    def cross(self, X_test: Tensor, Z: Tensor, *, prepared=None) -> Tensor:
        X_test, Z = self._cast_data(X_test, Z)
        return self._gram(X_test, Z)


@BACKENDS.register("hopper")
@dataclasses.dataclass(frozen=True)
class HopperOps(KernelOps):
    """Routes blocks to the hand-written Hopper kernels
    (``repro_torch.kernels``): K1 for dense rbf/linear/poly blocks, K3 for
    CSR ones, K2 for the eq.-(9) scores."""

    name = "hopper"

    def _tile_acc(self, *dtypes) -> torch.dtype | None:
        """Explicit accumulation dtype for the kernels, or None to keep
        their built-in rule (f64 in ⇒ f64, else f32)."""
        block = dtypes[0]
        for dt in dtypes[1:]:
            block = torch.promote_types(block, dt)
        return self._accum(block)

    def _sparse_kind(self) -> str | None:
        """K3's kind for the kernel; None for kernels without a sparse
        body (bernoulli), which go to _gram and its descriptive error."""
        return {RBFKernel: "rbf", LinearKernel: "linear",
                PolynomialKernel: "poly"}.get(type(self.kernel))

    def prepare_sparse(self, Z: Tensor):
        """K3's once-per-Z preparation (``kernels.ops.sparse_landmarks``)
        for CSR blocks cast to the policy's data dtype, on the card."""
        from ..kernels import ops as kops
        if self._sparse_kind() is None:
            return None
        (Z,) = self._cast_data(Z)
        return kops.sparse_landmarks(Z, Z.dtype,
                                     acc_dtype=self._tile_acc(Z.dtype))

    def cross(self, X_test, Z: Tensor, *, prepared=None) -> Tensor:
        from ..kernels import ops as kops
        X_test, Z = self._cast_data(X_test, Z)
        acc = self._tile_acc(X_test.dtype, Z.dtype)
        k = self.kernel
        if isinstance(X_test, CsrMatrix):
            kind = self._sparse_kind()
            if kind is None:
                return self._gram(X_test, Z)
            return kops.sparse_block(
                X_test.data, X_test.indices, X_test.indptr, Z, kind=kind,
                bandwidth=getattr(k, "bandwidth", 1.0),
                degree=getattr(k, "degree", 2),
                scale=getattr(k, "scale", 1.0),
                offset=getattr(k, "offset", 1.0), acc_dtype=acc,
                prepared=prepared)
        if isinstance(k, RBFKernel):
            return kops.rbf_block(X_test, Z, bandwidth=k.bandwidth,
                                  acc_dtype=acc)
        if isinstance(k, LinearKernel):
            return kops.linear_block(X_test, Z, acc_dtype=acc)
        if isinstance(k, PolynomialKernel):
            return kops.poly_block(X_test, Z, degree=k.degree, scale=k.scale,
                                   offset=k.offset, acc_dtype=acc)
        return self._gram(X_test, Z)

    def scores_given_gram(self, B: Tensor, G: Tensor, lam: float,
                          n: int) -> Tensor:
        # M = (G + nλI)^{-1} once (p×p, O(p³)), then K2's fused rowwise
        # B M Bᵀ — one pass over B, no n×p intermediate. The inverse runs
        # in solve_dtype when the policy widens it; K2 reads M in its
        # accumulation dtype.
        from ..kernels import ops as kops
        p = B.shape[1]
        sd = self._solve(B.dtype)
        wd = B.dtype if sd is None else sd
        A = 0.5 * (G + G.T).to(wd) + n * lam * torch.eye(
            p, dtype=wd, device=B.device)
        c = torch.linalg.cholesky(A)
        M = torch.cholesky_solve(torch.eye(p, dtype=wd, device=B.device), c)
        return kops.rls_scores(B, M, acc_dtype=self._tile_acc(B.dtype, wd))


# --------------------------------------------------------------- streaming

@BACKENDS.register("streaming")
@dataclasses.dataclass(frozen=True)
class StreamingOps(HopperOps):
    """Row-blocked execution: X in ``block_rows``-row tiles, so no compute
    intermediate larger than O(block_rows·p) is ever live. ``matvec``,
    ``rmatvec``, ``gram_matvec`` and the Theorem-4 ``score_pass`` never
    form C or B; ``columns``/``cross`` still return the block asked for,
    made tile by tile.

    Every tile is ``HopperOps.cross``: K1 for dense tiles and K3 for CSR
    ones on CUDA tensors, their plain versions on CPU tensors. (The
    reference's streaming tile is the plain ``kernel.gram``.) Tiles are
    row slices, so the last one is short rather than zero-padded and no
    row needs a mask. A CSR X is one direct block: K3 is nnz-tiled, which
    keeps the same working set without re-blocking the rows."""

    block_rows: int = DEFAULT_BLOCK_ROWS

    name = "streaming"
    streams_score_pass = True

    def _tile(self, X, Z: Tensor, *, prepared=None) -> Tensor:
        """One kernel block through the hopper route."""
        return HopperOps.cross(self, X, Z, prepared=prepared)

    def _row_tiles(self, X: Tensor):
        """``block_rows``-row slices of X, in order (one empty slice for an
        empty X)."""
        br = max(1, self.block_rows)
        return (X[s:s + br] for s in range(0, max(X.shape[0], 1), br))

    def _work(self, X: Tensor, v: Tensor) -> torch.dtype:
        """The dtype the contractions against ``v`` run in."""
        dt = torch.promote_types(X.dtype, v.dtype)
        acc = self._accum(dt)
        return dt if acc is None else acc

    def cross(self, X_test, Z: Tensor, *, prepared=None) -> Tensor:
        X_test, Z = self._cast_data(X_test, Z)
        if isinstance(X_test, CsrMatrix):
            return self._tile(X_test, Z, prepared=prepared)
        return torch.cat([self._tile(xb, Z)
                          for xb in self._row_tiles(X_test)])

    def matvec(self, X, Z: Tensor, v: Tensor) -> Tensor:
        if isinstance(X, CsrMatrix):
            return KernelOps.matvec(self, X, Z, v)
        X, Z = self._cast_data(X, Z)
        work = self._work(X, v)
        va = v.to(work)
        # v may be (p,) or (p, k) (multi-output duals)
        return torch.cat([self._tile(xb, Z).to(work) @ va
                          for xb in self._row_tiles(X)])

    def rmatvec(self, X, Z: Tensor, v: Tensor) -> Tensor:
        if isinstance(X, CsrMatrix):
            return KernelOps.rmatvec(self, X, Z, v)
        X, Z = self._cast_data(X, Z)
        work = self._work(X, v)
        va = v.to(work)
        out = torch.zeros((Z.shape[0],) + tuple(v.shape[1:]), dtype=work,
                          device=Z.device)
        br = max(1, self.block_rows)
        for s, xb in zip(range(0, X.shape[0], br), self._row_tiles(X)):
            out = out + self._tile(xb, Z).to(work).T @ va[s:s + br]
        return out

    def gram_matvec(self, X, Z: Tensor, v: Tensor) -> Tensor:
        # one pass: each tile adds Kbᵀ(Kb v) to a p-sized accumulator
        if isinstance(X, CsrMatrix):
            return KernelOps.gram_matvec(self, X, Z, v)
        X, Z = self._cast_data(X, Z)
        work = self._work(X, v)
        va = v.to(work)
        out = torch.zeros((Z.shape[0],) + tuple(v.shape[1:]), dtype=work,
                          device=Z.device)
        for xb in self._row_tiles(X):
            Kb = self._tile(xb, Z).to(work)
            out = out + Kb.T @ (Kb @ va)
        return out

    def leverage_scores(self, B: Tensor, lam: float, n: int) -> Tensor:
        acc = self._accum(B.dtype)
        ad = B.dtype if acc is None else acc
        p = B.shape[1]
        G = torch.zeros((p, p), dtype=ad, device=B.device)
        for bb in self._row_tiles(B):
            bb = bb.to(ad)
            G = G + bb.T @ bb
        return self.scores_given_gram(B, G, lam, n)

    def scores_given_gram(self, B: Tensor, G: Tensor, lam: float,
                          n: int) -> Tensor:
        # A = L Lᵀ once, then each row tile's scores through one triangular
        # solve: no (n, p) intermediate
        p = B.shape[1]
        sd = self._solve(B.dtype)
        wd = B.dtype if sd is None else sd
        A = 0.5 * (G + G.T).to(wd) + n * lam * torch.eye(
            p, dtype=wd, device=B.device)
        Lchol = torch.linalg.cholesky(A)
        outs = []
        for bb in self._row_tiles(B):
            V = torch.linalg.solve_triangular(Lchol, bb.T.to(wd), upper=False)
            outs.append(torch.sum(V * V, dim=0).to(B.dtype))
        return torch.cat(outs)

    # the chunk-seam bodies get rows that are blocked already (a chunk of
    # the out-of-core driver), so they take one tile each

    def score_pass_chunk_gram(self, xb, mask: Tensor, Z: Tensor,
                              accum_dtype, *, prepared=None) -> Tensor:
        Cb = (self._tile(xb, Z, prepared=prepared)
              * mask[:, None]).to(accum_dtype)
        return Cb.T @ Cb

    def score_pass_chunk_scores(self, xb, Z: Tensor, Lc: Tensor, La: Tensor,
                                *, prepared=None) -> tuple[Tensor, Tensor]:
        Cb = self._tile(xb, Z, prepared=prepared)
        Bt = torch.linalg.solve_triangular(Lc, Cb.T.to(Lc.dtype), upper=False)
        V = torch.linalg.solve_triangular(La, Bt, upper=False)
        return (torch.sum(V * V, dim=0).to(Cb.dtype),
                torch.sum(Bt * Bt, dim=0).to(Cb.dtype))

    def score_pass(self, X, idx: Tensor, lam: float,
                   jitter: float) -> tuple[Tensor, Tensor]:
        """Theorem-4 scores in two streamed passes; C and B never exist.

        Pass 1 accumulates CᵀC tile by tile (``score_pass_chunk_gram``),
        giving BᵀB = L⁻¹(CᵀC)L⁻ᵀ with L the jittered Cholesky of the
        landmark overlap W (``score_pass_core``). Pass 2 recomputes each
        tile of C and reads its scores and ‖B_i‖² through two triangular
        solves (``score_pass_chunk_scores``). Peak intermediate:
        O(block_rows·p + p²) for any n. The out-of-core driver runs the
        same seam over a chunk source.

        W is factored by ``landmark_cholesky``, as the chunked pass does:
        the reference's factorization, with the port's R1 rescue when it
        fails. CᵀC accumulates in ``accum_dtype`` and the p×p solves run in
        ``solve_dtype`` under a non-default policy.

        Returns (scores, row_sq) with row_sq_i = ‖B_i‖²."""
        (X,) = self._cast_data(X)
        n = X.shape[0]
        Z = X[idx]
        W = self._tile(Z, Z)                          # (p, p), small
        ad, wd = self.score_pass_dtypes(W.dtype)
        Lc = landmark_cholesky(W, jitter, solve_dtype=wd)
        if isinstance(X, CsrMatrix):
            # one whole block; an in-memory CsrMatrix has no padded rows
            prep = self.prepare_sparse(Z)
            mask = torch.ones((n,), dtype=W.dtype, device=W.device)
            CtC = self.score_pass_chunk_gram(X, mask, Z, ad, prepared=prep)
            La = score_pass_core(Lc, CtC, lam, n)
            return self.score_pass_chunk_scores(X, Z, Lc, La, prepared=prep)
        p = Z.shape[0]
        CtC = torch.zeros((p, p), dtype=ad, device=W.device)
        for xb in self._row_tiles(X):
            Cb = self._tile(xb, Z).to(ad)
            CtC = CtC + Cb.T @ Cb
        La = score_pass_core(Lc, CtC, lam, n)
        parts = [self.score_pass_chunk_scores(xb, Z, Lc, La)
                 for xb in self._row_tiles(X)]
        return (torch.cat([s for s, _ in parts]),
                torch.cat([r for _, r in parts]))


# -------------------------------------------------------------- resolution

def resolve_backend(name: str = "auto",
                    device: str | torch.device = "cuda") -> str:
    """Registry name for ``name``; ``"auto"`` → ``hopper`` on a CUDA
    device, ``torch`` on the CPU."""
    if name == "auto":
        return "hopper" if torch.device(device).type == "cuda" else "torch"
    BACKENDS.get(name)  # raises KeyError listing the available names
    return name


def ops_for(kernel: Kernel, backend: str = "auto", *,
            device: str | torch.device = "cuda",
            precision: Precision = Precision(),
            block_rows: int = DEFAULT_BLOCK_ROWS) -> KernelOps:
    """Construct the ``KernelOps`` executor for a kernel + backend name;
    ``block_rows`` reaches the executors that tile rows (``streaming``)."""
    cls = BACKENDS.get(resolve_backend(backend, device))
    kw = dict(kernel=kernel, precision=precision)
    if any(f.name == "block_rows" for f in dataclasses.fields(cls)):
        kw["block_rows"] = block_rows
    return cls(**kw)


def ops_for_config(config) -> KernelOps:
    """Executor for a ``SketchConfig`` (``kernel``/``backend``/``device``/
    ``precision``/``block_rows``)."""
    return ops_for(config.kernel, config.backend, device=config.device,
                   precision=config.precision, block_rows=config.block_rows)
