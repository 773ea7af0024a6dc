"""Frozen configuration for the ``SketchedKRR`` estimator.

One ``SketchConfig`` fully determines a fit: the kernel, the sketch size
``p`` (Theorem 3), the score-pass landmark count ``p_scores`` (Theorem 4),
the regularization λ, the leverage approximation level ε, the footnote-4
Nyström regularizer γ, the seed, the sampler/solver/backend registry names,
the device, and the knobs of the streaming executor and the iterative
solvers. Samplers, solvers and backends of the reference that are not
ported yet are refused here, with the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.backends import BACKENDS, DEFAULT_BLOCK_ROWS
from ..core.kernels import Kernel
from ..core.precision import Precision

# reference registry entries still to port → their ROADMAP item
NOT_PORTED = {
    "sampler": {},
    "solver": {"distributed": 9},
    "backend": {"sharded": 9, "xla": None, "pallas": None},
}


def refuse_unported(kind: str, name: str) -> None:
    """Raise for a reference entry the port does not have yet."""
    if name not in NOT_PORTED[kind]:
        return
    item = NOT_PORTED[kind][name]
    if item is None:
        raise ValueError(f"{kind} {name!r} is a JAX backend; the port's "
                         "backends are 'torch', 'hopper', 'streaming' and "
                         "'auto'")
    raise ValueError(f"{kind} {name!r} is not ported to repro_torch yet "
                     f"(ROADMAP item {item})")


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Everything a ``SketchedKRR`` fit depends on, in one immutable value.

    Attributes:
      kernel:    a ``repro_torch.core.kernels`` kernel (frozen dataclass).
      p:         final sketch size — number of Nyström columns (Theorem 3).
      lam:       ridge parameter λ of the KRR objective.
      eps:       leverage approximation level ε; the score pass runs at λε.
      gamma:     if set, the regularized sketch's γ (defaults to λ there).
      seed:      seed of the sampler's ``torch.Generator`` streams.
      precision: the per-stage dtype policy (``core.precision.Precision``);
                 inputs are cast to its ``data_dtype`` at fit/predict time.
      p_scores:  landmark count for the Theorem-4 score pass (``None`` → p);
                 for ``bless`` the cap of every stage's dictionary.
      bless_stages: ``bless``: annealing stages (``None`` → the halving
                 schedule, trimmed of the stages the dictionary floor
                 already certifies).
      bless_oversample: ``bless``: dictionary size over the predicted
                 effective dimension.
      sampler:   "uniform" | "diagonal" | "rls_exact" | "rls_fast" |
                 "bless" | "recursive_rls".
      solver:    "exact" | "nystrom" | "nystrom_regularized" | "dnc" |
                 "eigenpro" | "falkon_pcg" (the last two iterate on the
                 regularized sketch's landmark-space system,
                 ``core/eigenpro.py`` and ``core/distributed.py``).
      backend:   "hopper" | "torch" | "streaming" | "auto" (CUDA → hopper,
                 CPU → torch). "streaming" takes its tiles from hopper in
                 ``block_rows``-row blocks, so no compute intermediate is
                 larger than O(block_rows·p) and its score pass never forms
                 C or B.
      block_rows: row tile of the streaming executor.
      jitter:    relative jitter for the p×p Cholesky factorizations.
      partitions: ``dnc``: the number of blocks m.
      rls_levels: ``recursive_rls``: refinement levels.
      device:    "cuda" (the default; raises when no GPU is present) or
                 "cpu".
      chunk_rows: out-of-core chunk size. When set, ``fit(X, y)`` streams
                 the rows through the chunked driver in ``chunk_rows``-row
                 blocks (``repro_torch.api.out_of_core``) and the fit holds
                 O(chunk_rows·p) on the device; an in-memory fit at
                 ``chunk_rows=r`` is bit-identical to ``fit(source)`` with
                 any source at the same r. CSR input always takes the
                 driver, as one whole-matrix chunk when this is unset.
      epochs:    eigenpro: the most optimization epochs (SGD, then polish).
      batch_budget_mb: eigenpro: device-memory budget of one mini-batch,
                 which sets its rows (``core.eigenpro.auto_batch_rows``).
      solver_iters: falkon_pcg: the most PCG iterations.
      solver_tol: falkon_pcg: stop at this max-over-columns relative
                 residual; eigenpro: stop when a polish epoch moves β by
                 less than this, relatively.
      precond_k: eigenpro: eigendirections deflated (None → min(p − 1, 64)).
      precond_subsample: eigenpro: rows of the covariance estimate behind
                 the preconditioner (None → min(n, 4000)).
    """

    kernel: Kernel
    p: int
    lam: float = 1e-3
    eps: float = 0.5
    gamma: float | None = None
    seed: int = 0
    precision: Precision = Precision()
    p_scores: int | None = None
    bless_stages: int | None = None
    bless_oversample: float = 2.0
    sampler: str = "rls_fast"
    solver: str = "nystrom"
    backend: str = "auto"
    jitter: float = 1e-10
    partitions: int = 4
    rls_levels: int = 2
    device: str = "cuda"
    chunk_rows: int | None = None
    block_rows: int = DEFAULT_BLOCK_ROWS
    epochs: int = 20
    batch_budget_mb: float = 64.0
    solver_iters: int = 100
    solver_tol: float = 1e-6
    precond_k: int | None = None
    precond_subsample: int | None = None

    def __post_init__(self) -> None:
        if self.p <= 0:
            raise ValueError(f"p must be positive, got {self.p}")
        if self.lam <= 0:
            raise ValueError(f"lam must be positive, got {self.lam}")
        if self.eps <= 0:
            raise ValueError(f"eps must be positive, got {self.eps}")
        if self.p_scores is not None and self.p_scores <= 0:
            raise ValueError(f"p_scores must be positive, got {self.p_scores}")
        if self.bless_stages is not None and self.bless_stages <= 0:
            raise ValueError(
                f"bless_stages must be positive, got {self.bless_stages}")
        if self.bless_oversample <= 0:
            raise ValueError(f"bless_oversample must be positive, got "
                             f"{self.bless_oversample}")
        if self.block_rows <= 0:
            raise ValueError(
                f"block_rows must be positive, got {self.block_rows}")
        if self.chunk_rows is not None and self.chunk_rows <= 0:
            raise ValueError(
                f"chunk_rows must be positive, got {self.chunk_rows}")
        if self.epochs <= 0:
            raise ValueError(f"epochs must be positive, got {self.epochs}")
        if self.batch_budget_mb <= 0:
            raise ValueError(f"batch_budget_mb must be positive, got "
                             f"{self.batch_budget_mb}")
        if self.solver_iters <= 0:
            raise ValueError(
                f"solver_iters must be positive, got {self.solver_iters}")
        if self.solver_tol <= 0:
            raise ValueError(
                f"solver_tol must be positive, got {self.solver_tol}")
        if self.precond_k is not None and self.precond_k <= 0:
            raise ValueError(
                f"precond_k must be positive, got {self.precond_k}")
        if self.precond_subsample is not None and self.precond_subsample <= 0:
            raise ValueError(f"precond_subsample must be positive, got "
                             f"{self.precond_subsample}")
        refuse_unported("sampler", self.sampler)
        refuse_unported("solver", self.solver)
        refuse_unported("backend", self.backend)
        if self.backend != "auto" and self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; available: "
                f"{('auto',) + BACKENDS.available()}")
        if not isinstance(self.precision, Precision):
            raise ValueError(
                f"precision must be a repro_torch.core.precision.Precision, "
                f"got {self.precision!r}")
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{self.device!r}")

    @property
    def score_pass_p(self) -> int:
        """Landmarks for the Theorem-4 score pass (defaults to ``p``)."""
        return self.p if self.p_scores is None else self.p_scores

    def replace(self, **changes: Any) -> "SketchConfig":
        """A copy with the given fields replaced (frozen-dataclass style)."""
        return dataclasses.replace(self, **changes)
