"""Frozen configuration for the ``SketchedKRR`` estimator.

One ``SketchConfig`` fully determines a fit: the kernel, the sketch size
``p`` (Theorem 3), the score-pass landmark count ``p_scores`` (Theorem 4),
the regularization λ, the leverage approximation level ε, the footnote-4
Nyström regularizer γ, the seed, the sampler/solver/backend registry names
and the device. Samplers, solvers and backends of the reference that are
not ported yet are refused here, with the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.backends import BACKENDS
from ..core.kernels import Kernel
from ..core.precision import Precision

# reference registry entries still to port → their ROADMAP item
NOT_PORTED = {
    "sampler": {"bless": 7, "recursive_rls": 7},
    "solver": {"eigenpro": 6, "falkon_pcg": 6, "dnc": 7, "distributed": 9},
    "backend": {"streaming": 5, "sharded": 9, "xla": None, "pallas": None},
}


def refuse_unported(kind: str, name: str) -> None:
    """Raise for a reference entry the port does not have yet."""
    if name not in NOT_PORTED[kind]:
        return
    item = NOT_PORTED[kind][name]
    if item is None:
        raise ValueError(f"{kind} {name!r} is a JAX backend; the port's "
                         "backends are 'torch', 'hopper' and 'auto'")
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
      p_scores:  landmark count for the Theorem-4 score pass (``None`` → p).
      sampler:   "uniform" | "diagonal" | "rls_exact" | "rls_fast".
      solver:    "exact" | "nystrom" | "nystrom_regularized".
      backend:   "hopper" | "torch" | "auto" (CUDA → hopper, CPU → torch).
      jitter:    relative jitter for the p×p Cholesky factorizations.
      device:    "cuda" (the default; raises when no GPU is present) or
                 "cpu".
      chunk_rows: out-of-core chunk size. When set, ``fit(X, y)`` streams
                 the rows through the chunked driver in ``chunk_rows``-row
                 blocks (``repro_torch.api.out_of_core``) and the fit holds
                 O(chunk_rows·p) on the device; an in-memory fit at
                 ``chunk_rows=r`` is bit-identical to ``fit(source)`` with
                 any source at the same r. CSR input always takes the
                 driver, as one whole-matrix chunk when this is unset.
    """

    kernel: Kernel
    p: int
    lam: float = 1e-3
    eps: float = 0.5
    gamma: float | None = None
    seed: int = 0
    precision: Precision = Precision()
    p_scores: int | None = None
    sampler: str = "rls_fast"
    solver: str = "nystrom"
    backend: str = "auto"
    jitter: float = 1e-10
    device: str = "cuda"
    chunk_rows: int | None = None

    def __post_init__(self) -> None:
        if self.p <= 0:
            raise ValueError(f"p must be positive, got {self.p}")
        if self.lam <= 0:
            raise ValueError(f"lam must be positive, got {self.lam}")
        if self.eps <= 0:
            raise ValueError(f"eps must be positive, got {self.eps}")
        if self.p_scores is not None and self.p_scores <= 0:
            raise ValueError(f"p_scores must be positive, got {self.p_scores}")
        if self.chunk_rows is not None and self.chunk_rows <= 0:
            raise ValueError(
                f"chunk_rows must be positive, got {self.chunk_rows}")
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
