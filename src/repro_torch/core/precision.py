"""Precision policy: which dtype each stage of the pipeline runs in.

The PyTorch counterpart of the reference's policy, with the same four
independent knobs:

  ``data_dtype``   storage dtype of X / kernel blocks.
  ``accum_dtype``  dtype the block reductions run in (kernel-block products,
                   CᵀC/BᵀB Grams, matvec contractions); blocks are still
                   materialized in the data dtype.
  ``solve_dtype``  dtype of the p×p factorizations and solves.
  ``serve_dtype``  dtype of ``predict_batched``'s kernel blocks.

Every knob defaults to ``None`` = "resolve by the sane-core rules", which
only fire below the classic precision of a stage: f64 data leaves every
stage untouched; sub-f64 data solves its p×p systems in float64 (always
available in PyTorch — there is no x64 switch) and sub-f32 storage
accumulates in float32.
"""
from __future__ import annotations

import dataclasses

import torch

# ergonomic shorthands accepted anywhere a dtype name is
_DTYPE_ALIASES = {
    "f64": "float64", "fp64": "float64",
    "f32": "float32", "fp32": "float32",
    "f16": "float16", "fp16": "float16",
    "bf16": "bfloat16",
}


def to_dtype(name) -> torch.dtype:
    """A ``torch.dtype`` for a dtype name (aliases resolved) or dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, _DTYPE_ALIASES.get(name, name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def canonical_dtype_name(name: str | None) -> str | None:
    """Canonical dtype name (aliases resolved), or None.

    Raises ``ValueError`` for anything that is not a floating dtype — a
    precision policy naming ``int32`` is a config bug, not a cast request.
    """
    if name is None:
        return None
    dt = to_dtype(name)
    if not dt.is_floating_point:
        raise ValueError(f"precision dtype must be floating, got {name!r}")
    return str(dt).removeprefix("torch.")


def dtype_jitter_floor(dtype) -> float:
    """Smallest relative jitter that is representably PD at ``dtype``:
    sqrt(eps) below f64 (≈3.5e-4 in f32), eps^0.75 ≈ 1.8e-12 at f64 so the
    repo-wide 1e-10 default stays untouched."""
    eps = float(torch.finfo(to_dtype(dtype)).eps)
    return eps ** 0.75 if eps < 1e-12 else eps ** 0.5


def precision_independent_probs(probs: torch.Tensor) -> torch.Tensor:
    """``probs`` in float64 for drawing, so a seed selects the same set at
    every pipeline precision."""
    return probs.to(torch.float64)


def floored_jitter(jitter: float, dtype) -> float:
    """``max(jitter, dtype_jitter_floor(dtype))``."""
    return max(float(jitter), dtype_jitter_floor(dtype))


def storage_floored_jitter(jitter: float, block_dtype) -> float:
    """Jitter floored at the block storage dtype for sub-f32 blocks; f32
    and f64 blocks pass through untouched (see the reference's note: an
    up-cast bf16 block still carries O(eps_bf16) rounding)."""
    if to_dtype(block_dtype).itemsize < 4:
        return floored_jitter(jitter, block_dtype)
    return jitter


@dataclasses.dataclass(frozen=True)
class Precision:
    """Per-stage dtype policy (see module docstring for the four knobs).

    Names are canonicalized at construction (``"bf16"`` → ``"bfloat16"``),
    so two policies spelled differently compare equal.
    """

    data_dtype: str | None = None
    accum_dtype: str | None = None
    solve_dtype: str | None = None
    serve_dtype: str | None = None

    def __post_init__(self) -> None:
        for field in ("data_dtype", "accum_dtype", "solve_dtype",
                      "serve_dtype"):
            object.__setattr__(self, field,
                               canonical_dtype_name(getattr(self, field)))

    @property
    def is_default(self) -> bool:
        """True when the policy inserts no cast anywhere."""
        return (self.data_dtype is None and self.accum_dtype is None
                and self.solve_dtype is None and self.serve_dtype is None)

    # Each resolver returns a torch.dtype, or None meaning "leave the code
    # path exactly as it is" — callers gate their casts on that None.

    def data(self) -> torch.dtype | None:
        """Storage dtype for X / kernel blocks, or None = keep inputs."""
        return None if self.data_dtype is None else to_dtype(self.data_dtype)

    def accum_for(self, dtype) -> torch.dtype | None:
        """Accumulation dtype for reductions over ``dtype`` blocks."""
        if self.accum_dtype is not None:
            return to_dtype(self.accum_dtype)
        if to_dtype(dtype).itemsize < 4:        # bf16/f16 → f32
            return torch.float32
        return None

    def solve_for(self, dtype) -> torch.dtype | None:
        """Dtype the p×p factorizations run in for ``dtype`` data."""
        if self.solve_dtype is not None:
            return to_dtype(self.solve_dtype)
        dt = to_dtype(dtype)
        if float(torch.finfo(dt).eps) > 1e-12:   # below f64: widest core
            return torch.float64
        return None

    def serve(self) -> torch.dtype | None:
        """Serve-path block dtype, or None = full fit precision."""
        return (None if self.serve_dtype is None
                else to_dtype(self.serve_dtype))

    def for_serving(self) -> "Precision":
        """The policy the batched serve path runs under: blocks in
        ``serve_dtype``, accumulation and solves inherited."""
        return Precision(data_dtype=self.serve_dtype,
                         accum_dtype=self.accum_dtype,
                         solve_dtype=self.solve_dtype,
                         serve_dtype=None)
