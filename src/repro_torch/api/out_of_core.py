"""Out-of-core fit driver: the paper pipeline over a ``ChunkSource``.

The Theorem-4 score pass and the Theorem-3 sketch solve are one-touch row
streams with small cross-row state: the diagonal is (n,), CᵀC and Csᵀy are
p×p / p-sized accumulators, and the p×p algebra between passes
(``core.backends.score_pass_core``, the ``*_beta_from_stats`` finalizers)
never sees a row. This module strings them into a fit that reads its data
one chunk at a time and never holds X, C or B whole:

  pass 1  kernel diagonal   → the Theorem-4 seed distribution, row count n
  pass 2  landmark gather   → Z₀ = X[idx] for the drawn score landmarks
  pass 3  chunked CᵀC       → ``score_pass_chunk_gram`` per chunk
  pass 4  chunked scores    → ``score_pass_chunk_scores`` per chunk →
                              Theorem-3 column draw, gather of the final Z
  pass 5  solver statistics → the solver's ``ChunkAccumulator``; an
                              accumulator with ``end_pass`` (``eigenpro``)
                              asks for further passes, one per epoch

Sources stay on the host; each chunk moves to the configured device in the
data dtype, and its kernel blocks come from the configured ``KernelOps``
executor — K1 for dense chunks, K3 for CSR chunks under ``hopper``. Device
state is O(chunk_rows·p) per chunk plus O(p²) across chunks; the (n,)
diagonal and scores are the only n-sized arrays. Draws come from the same
CPU ``torch.Generator`` streams as the in-memory sampler
(``samplers.streams(seed, 2)``: score-pass landmarks, then the column
draw), so a seed draws the same score landmarks in memory and chunked.

``SketchedKRR.fit`` routes here for any chunk source, for CSR input, and
for in-memory arrays when ``SketchConfig.chunk_rows`` is set; results are
bit-identical across source kinds at equal ``chunk_rows``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..core.backends import (KernelOps, landmark_cholesky, ops_for_config,
                             score_pass_core)
from ..core.bless import (bless_dict_size, bless_grid, bless_overestimate,
                          injected_dictionary, widen_bless_accum)
from ..core.leverage import draw_landmarks
from ..core.nystrom import ColumnSample, draw_columns
from ..data.chunks import ChunkSource, gather_rows
from ..data.sparse import CsrMatrix, SparseChunkSource
from .config import SketchConfig
from .samplers import streams

# samplers the driver evaluates one chunk at a time. rls_exact needs the
# full n×n Gram and recursive_rls re-scores the rows level by level in
# memory (both in-memory diagnostics); every bless stage is one more chunked
# score pass against a small dictionary (_bless_scores_from_source)
CHUNKABLE_SAMPLERS = ("uniform", "diagonal", "rls_fast", "bless")

# solvers whose accumulators touch X only through kernel blocks (O(p²)
# statistics) — the ones CSR chunks can feed; ``exact`` and ``eigenpro``
# buffer raw rows
SPARSE_CHUNK_SOLVERS = ("nystrom", "nystrom_regularized", "falkon_pcg")


def require_sparse_chunk_solver(config: SketchConfig, sparse: bool) -> None:
    """Refuse CSR chunks to a solver that would have to densify them."""
    if sparse and config.solver not in SPARSE_CHUNK_SOLVERS:
        raise ValueError(
            f"solver {config.solver!r} buffers raw rows host-side and "
            f"cannot consume CSR chunks without densifying them; sparse "
            f"chunks support: {', '.join(SPARSE_CHUNK_SOLVERS)}")


class ChunkedFitResult(NamedTuple):
    """What a chunked fit hands back to the estimator."""

    state: Any                    # fitted solver state (predict-ready)
    sample: ColumnSample | None   # Theorem-3 column draw (None: exact)
    scores: Tensor | None         # (n,) sampler scores behind the draw
    n_rows: int                   # total valid rows streamed


def _cast_chunk(config: SketchConfig, arr):
    """A host block (numpy array or ``CsrMatrix``) on the config's device in
    its data dtype (None keeps the block's dtype); ``None`` stays None."""
    if arr is None:
        return None
    dt, dev = config.precision.data(), torch.device(config.device)
    if isinstance(arr, CsrMatrix):
        return arr.cast(dt, dev)
    return torch.as_tensor(np.asarray(arr), dtype=dt, device=dev)


def diag_pass(config: SketchConfig, source: ChunkSource) -> tuple[Tensor, int]:
    """(kernel diagonal, row count) in one streamed pass — the Theorem-4
    seed distribution p_i = K_ii/Tr(K), (n,) like the sampler's output."""
    parts: list[Tensor] = []
    n = 0
    for chunk in source.chunks():
        d = config.kernel.diag(_cast_chunk(config, chunk.X))
        parts.append(d[:chunk.n_valid])
        n += chunk.n_valid
    if n == 0:
        raise ValueError("chunk source yielded no rows")
    return torch.cat(parts), n


def chunked_score_pass(config: SketchConfig, source: ChunkSource, Z: Tensor,
                       n: int, lam: float, *, ops: KernelOps | None = None
                       ) -> tuple[Tensor, Tensor]:
    """Theorem-4 scores over a chunk source, in two streamed passes: the
    chunked CᵀC (``score_pass_chunk_gram``, p×p cross-chunk state in the
    policy's accumulation dtype), the shared p×p factorization
    (``score_pass_core``), then the per-chunk score reads
    (``score_pass_chunk_scores``). Returns (scores, ‖B_i‖²) for the n rows.

    The landmark overlap is factored by ``landmark_cholesky``: the
    reference's factorization, with the port's R1 rescue when it fails."""
    ops = ops_for_config(config) if ops is None else ops
    W = ops.cross(Z, Z)
    ad, wd = ops.score_pass_dtypes(W.dtype)
    Lc = landmark_cholesky(W, config.jitter, solve_dtype=wd)
    p = Z.shape[0]
    # CSR chunks: the landmarks are prepared for K3 once, for both passes
    prep = (ops.prepare_sparse(Z) if isinstance(source, SparseChunkSource)
            else None)
    CtC = torch.zeros((p, p), dtype=ad, device=Z.device)
    for chunk in source.chunks():
        xb = _cast_chunk(config, chunk.X)
        mb = (torch.arange(xb.shape[0], device=Z.device)
              < chunk.n_valid).to(W.dtype)
        CtC = CtC + ops.score_pass_chunk_gram(xb, mb, Z, ad, prepared=prep)
    La = score_pass_core(Lc, CtC, lam, n)
    s_parts: list[Tensor] = []
    r_parts: list[Tensor] = []
    for chunk in source.chunks():
        s, r = ops.score_pass_chunk_scores(_cast_chunk(config, chunk.X), Z,
                                           Lc, La, prepared=prep)
        s_parts.append(s[:chunk.n_valid])
        r_parts.append(r[:chunk.n_valid])
    scores = torch.cat(s_parts)
    if scores.shape[0] != n:
        raise ValueError(
            f"chunk source is not re-iterable: the score pass saw "
            f"{scores.shape[0]} rows, expected {n}; each chunks() call "
            "must replay the same rows")
    return scores, torch.cat(r_parts)


def _bless_scores_from_source(config: SketchConfig, source: ChunkSource,
                              diag: Tensor, n: int, gen: torch.Generator, *,
                              dictionaries=None) -> Tensor:
    """The BLESS annealing loop over a chunk source, stage for stage the
    out-of-core twin of ``core.bless.bless_leverage``: the same schedule,
    dictionary sizes, overestimate, set draws (without replacement) from
    ``gen`` and widened reductions; each stage's scores come from a
    ``chunked_score_pass`` against the gathered dictionary rows (K3 on CSR
    chunks, its landmarks prepared once a stage), so no array larger than
    O(chunk_rows·q + q²) is live. ``dictionaries`` (one index tensor per
    stage) replaces the draws; each must hold the stage's q_h rows."""
    trace = float(torch.sum(diag))
    lam_max = trace / n
    grid = bless_grid(lam_max, config.lam * config.eps, n,
                      config.bless_stages, config.bless_oversample,
                      None if dictionaries is None else len(dictionaries))
    q_cap = min(config.score_pass_p, n)
    probs = diag / trace
    d_eff, prev_lam, q_prev = 1.0, lam_max, 0
    ops = widen_bless_accum(ops_for_config(config), diag.dtype)
    scores = None
    for h, lam_h in enumerate(grid):
        # max(·, q_prev): dictionaries never shrink, as in memory
        q_h = max(bless_dict_size(d_eff, max(prev_lam / lam_h, 1.0),
                                  config.bless_oversample, n, q_cap,
                                  d_eff_cap=lam_max / lam_h), q_prev)
        q_prev = q_h
        idx = injected_dictionary(dictionaries, h, lam_h, q_h)
        if idx is None:
            idx = draw_landmarks(gen, probs, q_h, False)
        Z = _cast_chunk(config, gather_rows(source, idx.cpu().numpy()))
        scores, row_sq = chunked_score_pass(config, source, Z, n, lam_h,
                                            ops=ops)
        over = bless_overestimate(scores, diag, row_sq, n, lam_h)
        probs = over / torch.sum(over)
        d_eff, prev_lam = float(torch.sum(over)), lam_h
    return scores


def sample_from_source(config: SketchConfig, source: ChunkSource,
                       gens: tuple[torch.Generator, torch.Generator], *,
                       landmarks: Tensor | None = None,
                       sample: ColumnSample | None = None
                       ) -> tuple[ColumnSample, Tensor, int]:
    """The configured sampler evaluated chunk by chunk, with the in-memory
    sampler's draws: the score landmarks from ``gens[0]`` (``min(p_scores,
    n)`` of them, with replacement, from K_ii/Tr(K)), the columns from
    ``gens[1]``. ``landmarks`` and ``sample`` replace those draws with
    given ones, as the in-memory ``fit`` allows (for ``bless``,
    ``landmarks`` is the list of per-stage dictionaries). Returns (column
    sample, unnormalized scores, row count)."""
    name = config.sampler
    if name not in CHUNKABLE_SAMPLERS:
        raise ValueError(
            f"sampler {name!r} cannot run out-of-core (it needs the full "
            f"training set in memory); chunkable samplers: "
            f"{CHUNKABLE_SAMPLERS}")
    diag, n = diag_pass(config, source)
    if name == "uniform":
        scores = torch.ones_like(diag)
    elif name == "diagonal":
        scores = diag
    elif name == "bless":  # λ-annealed chunked score passes
        scores = _bless_scores_from_source(config, source, diag, n, gens[0],
                                           dictionaries=landmarks)
    else:  # rls_fast: Theorem-4 landmarks → chunked score pass
        idx = landmarks
        if idx is None:
            idx = draw_landmarks(gens[0], diag / torch.sum(diag),
                                 min(config.score_pass_p, n), True)
        Z0 = _cast_chunk(config, gather_rows(source, idx.cpu().numpy()))
        scores, _ = chunked_score_pass(config, source, Z0, n,
                                       config.lam * config.eps)
    if sample is None:
        sample = draw_columns(gens[1], scores / torch.sum(scores), config.p)
    return sample, scores, n


def fit_from_source(config: SketchConfig, solver, source: ChunkSource, *,
                    sample: ColumnSample | None = None,
                    score_landmarks: Tensor | None = None
                    ) -> ChunkedFitResult:
    """One out-of-core fit: sample → gather landmarks → accumulate →
    finalize. ``solver`` is the resolved registry entry (it must expose
    ``begin_chunked``); ``sample``/``score_landmarks`` inject draws.

    An accumulator with ``end_pass(n) -> bool`` (the iterative solvers'
    multi-epoch protocol) is asked after every pass whether to stream the
    source again: each epoch calls ``source.chunks()`` anew, so a
    ``GeneratorChunkSource`` factory is called once per epoch and the data
    is never held whole. A pass that yields no rows, or another row count
    than the sampling passes saw, fails and names its epoch."""
    begin = getattr(solver, "begin_chunked", None)
    if begin is None:
        raise ValueError(
            f"solver {config.solver!r} does not support out-of-core "
            "fitting; use one of: exact, nystrom, nystrom_regularized, "
            "eigenpro, falkon_pcg")
    if not source.has_targets:
        raise ValueError("fitting needs a source with targets: give the "
                         "source a y array / path / block component")
    require_sparse_chunk_solver(config, isinstance(source, SparseChunkSource))
    scores = landmarks = n_expected = None
    if solver.needs_sample:
        sample, scores, n_expected = sample_from_source(
            config, source, tuple(streams(config.seed, 2)),
            landmarks=score_landmarks, sample=sample)
        landmarks = _cast_chunk(config, gather_rows(
            source, sample.idx.cpu().numpy()))
    else:
        sample = None
    acc = begin(config, landmarks, sample)
    end_pass = getattr(acc, "end_pass", None)
    epoch = 0
    while True:
        epoch += 1
        n_seen = 0
        for chunk in source.chunks():
            acc.add(_cast_chunk(config, chunk.X),
                    _cast_chunk(config, chunk.y), chunk.n_valid)
            n_seen += chunk.n_valid
        if n_seen == 0:
            if epoch == 1:
                raise ValueError("chunk source yielded no rows")
            raise ValueError(
                f"chunk source went dry on epoch {epoch}: multi-epoch "
                "streaming calls chunks() once per epoch, but this pass "
                "yielded no rows — a one-shot iterator was handed over "
                "instead of a factory (wrap the construction: "
                "GeneratorChunkSource(lambda: make_blocks(), ...))")
        if n_expected is not None and n_seen != n_expected:
            # a one-shot iterator wrapped as a factory, or a cursor that
            # does not replay, would corrupt a multi-pass fit silently
            prior = ("the sampling passes" if epoch == 1
                     else "earlier passes")
            raise ValueError(
                f"chunk source is not re-iterable: {prior} saw "
                f"{n_expected} rows but solver epoch {epoch} saw {n_seen}; "
                "each chunks() call must replay the same rows (wrap the "
                "construction of a generator, not the iterator)")
        n_expected = n_seen
        if end_pass is None or not end_pass(n_seen):
            break
    return ChunkedFitResult(acc.finalize(n_seen), sample, scores, n_seen)
