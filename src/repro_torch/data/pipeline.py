"""Synthetic data for the port, made from a seed: the LM token stream and
the KRR regression sets.

The LM stream (``lm_batch``, ``lm_stream``) is counter-based, as the
reference's: row r of step t is drawn from a ``torch.Generator`` seeded
from (seed, t, r) alone, so a host's slice of rows equals those rows of
the whole batch and the batch of step t is the same after a restart. torch
cannot reproduce the reference's threefry draws: tests that compare the
two inject the reference's batches.

``pumadyn_like`` is the reference's pumadyn-style nonlinear regression
surrogate, bit for bit, with the input width as an argument so the same
generator can stand in at other widths (d = 90 for the YearPredictionMSD
shape ``chip_smoke.py`` uses). ``rcv1_like`` makes CSR rows of the shape of
the RCV1 text benchmark (Lewis et al., JMLR 2004) for the sparse path.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch
from torch import Tensor


# ------------------------------------------------------------- LM pipeline

@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _row(cfg: LMDataConfig, step: int, row: int) -> Tensor:
    """seq_len + 1 tokens of one row, from its own generator."""
    key = np.random.SeedSequence([cfg.seed, step, row]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(key))
    return torch.randint(0, cfg.vocab_size, (cfg.seq_len + 1,), generator=g)


def lm_batch(cfg: LMDataConfig, step: int,
             host_slice: slice | None = None) -> dict[str, Tensor]:
    """Batch for ``step`` on the CPU: ``tokens`` and next-token ``labels``
    (b, seq_len) int64; rows [host_slice] only when data-sharded by
    host."""
    rows = range(cfg.global_batch)[host_slice] if host_slice \
        else range(cfg.global_batch)
    toks = torch.stack([_row(cfg, step, r) for r in rows])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_stream(cfg: LMDataConfig, start_step: int = 0,
              host_slice: slice | None = None) -> Iterator[dict[str, Tensor]]:
    step = start_step
    while True:
        yield lm_batch(cfg, step, host_slice)
        step += 1


# ------------------------------------------------------- KRR regression


def pumadyn_like(n: int, dim: int = 32, seed: int = 0, noise: float = 0.1,
                 nonlinear: bool = True) -> dict[str, np.ndarray]:
    """Pumadyn-style robot-dynamics regression surrogate (``dim`` inputs):
    f* = tanh(X W1) w2 normalized to unit variance, y = f* + noise·ξ."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, dim))
    w1 = rng.standard_normal((dim, 16)) / np.sqrt(dim)
    w2 = rng.standard_normal(16)
    if nonlinear:
        f_star = np.tanh(X @ w1) @ w2
    else:
        f_star = X @ w1[:, 0]
    f_star = f_star / np.std(f_star)
    y = f_star + noise * rng.standard_normal(n)
    return {"x": X, "f_star": f_star, "y": y, "noise": noise}


def _distinct_curve(freq: np.ndarray, m_max: int) -> np.ndarray:
    """U[m] = expected number of distinct columns in m draws from ``freq``
    with replacement: Σ_j 1 − (1 − f_j)^m, for m = 0 .. m_max."""
    log_miss = np.log1p(-freq)
    m = np.arange(m_max + 1, dtype=np.float64)
    out = np.empty(m_max + 1)
    for lo in range(0, m_max + 1, 256):
        hi = min(lo + 256, m_max + 1)
        out[lo:hi] = freq.shape[0] - np.exp(np.outer(m[lo:hi], log_miss)
                                            ).sum(axis=1)
    return out


def rcv1_like(n: int, dim: int = 47_236, nnz_per_row: int = 74,
              seed: int = 0, noise: float = 0.1) -> dict:
    """RCV1-shaped sparse regression data: CSR rows over ``dim`` columns.

    Column ids follow a Zipf law (word frequencies, exponent 1, the ranks
    shuffled over the columns); a row holds about ``nnz_per_row`` distinct
    ids on average (lengths log-normal, 1 to 8× the mean), sorted, with no
    duplicate. Values are TF-IDF: (1 + log count)·log(1/frequency), then
    each row is L2-normalized. The target is f* = tanh(2 x·w₁) + ½ x·w₂
    for Gaussian w₁, w₂, standardized to mean 0 and unit variance, and
    y = f* + noise·ξ.

    Returns ``data``, ``indices``, ``indptr`` (CSR arrays: float64, int32,
    int32), ``n_cols``, ``y``, ``f_star`` and ``noise``; vectorized numpy,
    seconds at 700 k rows.
    """
    rng = np.random.default_rng(seed)
    freq = 1.0 / np.arange(1, dim + 1)
    freq /= freq.sum()
    column_of_rank = rng.permutation(dim).astype(np.int64)
    # target distinct counts, then the with-replacement draw count that
    # gives that many distinct ids on average
    sigma = 0.6
    lengths = rng.lognormal(np.log(nnz_per_row) - sigma ** 2 / 2, sigma, n)
    lengths = np.clip(np.rint(lengths), 1, min(8 * nnz_per_row, dim))
    curve = _distinct_curve(freq, int(4 * lengths.max()) + 8)
    draws = np.maximum(np.searchsorted(curve, lengths), 1).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), draws)
    ranks = np.searchsorted(np.cumsum(freq), rng.random(rows.shape[0]),
                            side="right")
    ranks = np.minimum(ranks, dim - 1)
    keys, counts = np.unique(rows * dim + column_of_rank[ranks],
                             return_counts=True)
    row_of, indices = np.divmod(keys, dim)
    idf = np.empty(dim)
    idf[column_of_rank] = -np.log(freq)
    data = (1.0 + np.log(counts)) * idf[indices]
    norms = np.sqrt(np.bincount(row_of, weights=data * data, minlength=n))
    data /= norms[row_of]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row_of, minlength=n))])
    w = rng.standard_normal((2, dim))
    s = np.stack([np.bincount(row_of, weights=data * wk[indices],
                              minlength=n) for wk in w])
    f_star = np.tanh(2.0 * s[0]) + 0.5 * s[1]
    f_star = (f_star - f_star.mean()) / f_star.std()
    y = f_star + noise * rng.standard_normal(n)
    return {"data": data, "indices": indices.astype(np.int32),
            "indptr": indptr.astype(np.int32), "n_cols": dim, "y": y,
            "f_star": f_star, "noise": noise}
