"""Column samplers behind one call signature (paper §2, §3.4-3.5).

Every sampler is ``(gens, kernel, X, config, *, landmarks=None,
sample=None) -> SamplerOutput``. ``gens`` is a pair of CPU
``torch.Generator``s (score-pass landmarks, column draw) that the
estimator seeds from ``config.seed``. ``landmarks`` and ``sample`` inject
draws made elsewhere (the reference's, in the parity tests): PyTorch cannot
reproduce JAX's random streams. ``landmarks`` is the score pass's index
tensor for ``rls_fast``, and a list of them — one per stage or level —
for ``bless`` and ``recursive_rls``.

Every kernel block a sampler touches comes from the configured
``KernelOps`` backend.

Registry entries → paper results:
  uniform       p_i = 1/n               Bach's baseline; needs p = O(d_mof).
  diagonal      p_i = K_ii/Tr(K)        Theorem-4 seed distribution.
  rls_exact     p_i ∝ l_i(λε)           Definition 1 oracle (O(n³); small n).
  rls_fast      p_i ∝ l̃_i(λε)           Theorem 4 scores → Theorem 3 draw,
                                        O(n·p_scores²) — the paper pipeline.
  bless         p_i ∝ l̃_i(λε)           λ-annealed stages, each against a
                                        small dictionary (core/bless).
  recursive_rls p_i ∝ l̃_i(λε)           level-wise refined Theorem-4 passes
                                        (core/recursive_rls).
"""
from __future__ import annotations

from typing import NamedTuple, Protocol

import numpy as np
import torch
from torch import Tensor

from ..core.backends import ops_for_config
from ..core.bless import bless_leverage
from ..core.kernels import Kernel
from ..core.leverage import fast_ridge_leverage, ridge_leverage_scores
from ..core.nystrom import ColumnSample, draw_columns
from ..core.recursive_rls import recursive_ridge_leverage
from ..registry import Registry
from .config import SketchConfig


class SamplerOutput(NamedTuple):
    """The Theorem-3 column draw plus the unnormalized score vector that
    induced its distribution."""

    sample: ColumnSample
    scores: Tensor


class Sampler(Protocol):
    def __call__(self, gens: tuple[torch.Generator, torch.Generator],
                 kernel: Kernel, X: Tensor, config: SketchConfig, *,
                 landmarks: Tensor | None = None,
                 sample: ColumnSample | None = None) -> SamplerOutput: ...


SAMPLERS: Registry[Sampler] = Registry("sampler")


def streams(seed: int, k: int) -> list[torch.Generator]:
    """``k`` independent CPU generators spawned from ``seed``."""
    return [torch.Generator().manual_seed(int(s.generate_state(1, np.uint64)[0]))
            for s in np.random.SeedSequence(seed).spawn(k)]


def _finish(gen: torch.Generator, scores: Tensor, p: int,
            sample: ColumnSample | None) -> SamplerOutput:
    if sample is None:
        sample = draw_columns(gen, scores / torch.sum(scores), p)
    return SamplerOutput(sample, scores)


@SAMPLERS.register("uniform")
def uniform(gens, kernel, X, config, *, landmarks=None, sample=None):
    """Bach's vanilla Nyström baseline: p_i = 1/n (needs p = O(d_mof))."""
    return _finish(gens[1], torch.ones_like(kernel.diag(X)), config.p, sample)


@SAMPLERS.register("diagonal")
def diagonal(gens, kernel, X, config, *, landmarks=None, sample=None):
    """Squared-length sampling p_i = K_ii/Tr(K) — the Theorem-4 seed
    distribution."""
    return _finish(gens[1], kernel.diag(X), config.p, sample)


@SAMPLERS.register("rls_exact")
def rls_exact(gens, kernel, X, config, *, landmarks=None, sample=None):
    """Definition-1 oracle: p_i ∝ exact l_i(λε) via the full n×n Gram —
    O(n³), diagnostics/small n only."""
    K = ops_for_config(config).cross(X, X)
    scores = ridge_leverage_scores(K, config.lam * config.eps)
    return _finish(gens[1], scores, config.p, sample)


@SAMPLERS.register("rls_fast")
def rls_fast(gens, kernel, X, config, *, landmarks=None, sample=None):
    """The paper pipeline: Theorem-4 fast scores at λε from
    ``config.score_pass_p`` landmarks, then the Theorem-3 leverage draw of
    ``config.p`` columns — O(n·p_scores²)."""
    fast = fast_ridge_leverage(kernel, X, config.lam * config.eps,
                               min(config.score_pass_p, X.shape[0]), gens[0],
                               jitter=config.jitter,
                               ops=ops_for_config(config), idx=landmarks)
    return _finish(gens[1], fast.scores, config.p, sample)


@SAMPLERS.register("bless")
def bless(gens, kernel, X, config, *, landmarks=None, sample=None):
    """BLESS sequential leverage sampling (Rudi et al. 2018): λ annealed
    geometrically from Tr(K)/n down to λε, each stage scoring against a
    small overestimate-drawn dictionary (``bless_stages`` /
    ``bless_oversample``; dictionaries capped at ``p_scores``) —
    O(n·q²·log n) with q ≪ p_scores; ``landmarks`` injects the
    per-stage dictionaries."""
    res = bless_leverage(kernel, X, config.lam * config.eps, gens[0],
                         stages=config.bless_stages,
                         oversample=config.bless_oversample,
                         q_max=min(config.score_pass_p, X.shape[0]),
                         jitter=config.jitter, ops=ops_for_config(config),
                         dictionaries=landmarks)
    return _finish(gens[1], res.scores, config.p, sample)


@SAMPLERS.register("recursive_rls")
def recursive_rls(gens, kernel, X, config, *, landmarks=None, sample=None):
    """Level-wise refined leverage sampling (``rls_levels`` levels of
    ``p_scores`` landmarks, Musco & Musco 2017 style); ``landmarks``
    injects the per-level draws."""
    res = recursive_ridge_leverage(kernel, X, config.lam * config.eps,
                                   min(config.score_pass_p, X.shape[0]),
                                   gens[0], n_levels=config.rls_levels,
                                   ops=ops_for_config(config),
                                   levels_idx=landmarks)
    return _finish(gens[1], res.scores, config.p, sample)
