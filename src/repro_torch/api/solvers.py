"""Solvers behind one protocol (paper §2; footnote 4).

A ``Solver`` turns (config, X, y, column sample) into a fitted state and
maps that state to predictions at arbitrary points — including the
out-of-sample Nyström extension f̂(x) = k(x, Z)·β (β lives in landmark
space, so predict is O(batch·p·dim)). Every kernel block comes from the
``KernelOps`` backend configured on the ``SketchConfig``.

Registry entries → paper results:
  exact               α = (K + nλI)^{-1}y          eq. (2); O(n³) reference.
  nystrom             L = C W† Cᵀ                   §2 classic sketch, solved
                                                    through Woodbury (Thm 3).
  nystrom_regularized L_γ = KS(SᵀKS + nγI)^{-1}SᵀK footnote 4 / App. C.
  eigenpro            preconditioned mini-batch SGD on the L_γ system
                                                    (core/eigenpro) —
                                                    multi-epoch streaming.
  falkon_pcg          Nyström-preconditioned CG on the L_γ system
                                                    (core/distributed) —
                                                    tens of iterations.
  dnc                 m-partition averaged KRR       §1 baseline (core/dnc).

The two iterative entries converge to the ``nystrom_regularized`` β (the
same landmark-space normal equations) and never factor more than a p×p
preconditioner.

Every solver also fits incrementally: ``begin_chunked(config, landmarks,
sample)`` returns a ``ChunkAccumulator`` that the out-of-core driver
(``repro_torch.api.out_of_core``) and ``SketchedKRR.partial_fit`` feed one
row chunk at a time — O(p²) sufficient statistics for the Nyström solvers
and ``falkon_pcg``, buffered rows for ``exact``. ``eigenpro``'s
accumulator asks the driver for more passes over the source
(``end_pass``), one per epoch, which ``partial_fit`` cannot give it.
EigenPro draws its preconditioner's subsample from the third generator of
``samplers.streams(config.seed, 3)`` (the first two are the sampler's, and
``SeedSequence.spawn`` gives the same first two children at 2 and 3).

``dnc`` draws its partitions from the third generator of
``samplers.streams(config.seed, 3)`` (or takes them injected). The
reference's distributed solver is ROADMAP item 9.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Protocol

import torch
from torch import Tensor

from ..core.backends import KernelOps, ops_for_config
from ..core.distributed import falkon_pcg_from_stats, falkon_pcg_krr
from ..core.dnc import DnCModel, dnc_fit, dnc_predict, dnc_predict_train
from ..core.eigenpro import (auto_batch_rows, build_preconditioner,
                             eigenpro_fit, landmark_solve_dtypes,
                             make_chunk_grad, make_chunk_step,
                             make_polish_step, penalty_block, rel_delta,
                             sgd_epoch_budget)
from ..core.krr import (RiskReport, krr_fit, nystrom_krr_fit, risk_exact,
                        risk_nystrom)
from ..core.nystrom import (ColumnSample, NystromApprox,
                            nystrom_beta_from_stats, nystrom_factors,
                            nystrom_regularized_beta_from_stats,
                            nystrom_regularized_factors)
from ..core.precision import storage_floored_jitter, to_dtype
from ..data.sparse import CsrMatrix
from ..registry import Registry
from .config import SketchConfig
from .samplers import streams


def _ops(config: SketchConfig) -> KernelOps:
    """The configured kernel-execution backend."""
    return ops_for_config(config)


def _solve_cast(config: SketchConfig, *arrays: Tensor):
    """Arrays up-cast to an explicitly requested ``solve_dtype``, else
    untouched (the reference's rule: the default sub-f64 widening is for
    the score pass's near-singular overlap, not for these nλ-shifted fits
    over the O(n·p) sketch)."""
    sd = config.precision.solve_dtype
    out = arrays if sd is None else tuple(a.to(to_dtype(sd)) for a in arrays)
    return out if len(out) > 1 else out[0]


class Solver(Protocol):
    """fit/predict/risk; ``needs_sample`` tells the estimator whether to
    run the configured sampler before fitting. Solvers that fit
    incrementally also expose ``begin_chunked(config, landmarks, sample)
    -> ChunkAccumulator``."""

    needs_sample: bool

    def fit(self, config: SketchConfig, X: Tensor, y: Tensor,
            sample: ColumnSample | None) -> Any: ...

    def predict(self, config: SketchConfig, state: Any,
                X_test: Tensor) -> Tensor: ...

    def predict_train(self, config: SketchConfig, state: Any,
                      X_train: Tensor) -> Tensor: ...

    def risk(self, config: SketchConfig, state: Any, f_star: Tensor,
             noise_std: float) -> RiskReport: ...


SOLVERS: Registry[Solver] = Registry("solver")


# ----------------------------------------------- chunked-fit accumulators

class ChunkAccumulator(Protocol):
    """Streaming half of a solver: per-chunk statistics in, state out.

    ``add`` folds one row chunk into the running statistics (``n_valid``
    masks a zero-padded tail); ``finalize`` turns the statistics seen so
    far into a fitted state and may be called again after more ``add``
    calls — the contract behind ``SketchedKRR.partial_fit``/``finalize``.
    """

    def add(self, Xb, yb: Tensor, n_valid: int | None = None) -> None: ...

    def finalize(self, n: int) -> Any: ...


class _NystromChunkAccumulator:
    """O(p²) sufficient statistics for the two Nyström solvers.

    Accumulates Gc = Σ_b C_bᵀC_b and bc = Σ_b C_bᵀy_b over (for the
    regularized sketch, weight-scaled) column chunks C_b = k(X_b, Z), each
    block from the configured ``KernelOps`` executor (K1 for dense chunks,
    K3 for CSR ones under ``hopper``). ``finalize`` maps them to β through
    the ``*_beta_from_stats`` algebra; nothing of size O(n) is held, so the
    state carries no training factor (``approx=None``).

    Chunk reductions run in the policy's accumulation dtype. The p×p
    finalization follows the in-memory ``_solve_cast`` rule — an explicit
    ``solve_dtype`` up-casts, otherwise the data dtype is kept, so
    ``chunk_rows`` stays a pure memory knob — except that sub-f32 storage
    widens to the policy's solve resolution (no sub-f32 factorizations).
    """

    def __init__(self, config: SketchConfig, landmarks: Tensor,
                 sample: ColumnSample | None, *, regularized: bool):
        self.config = config
        self.ops = _ops(config)
        self.Z = landmarks
        self.sample = sample
        self.weights = sample.weights if regularized else None
        self.accum_dtype, wide = self.ops.score_pass_dtypes(landmarks.dtype)
        if config.precision.solve_dtype is not None:
            self.solve_dtype = to_dtype(config.precision.solve_dtype)
        elif landmarks.dtype.itemsize < 4:
            self.solve_dtype = wide     # bf16/f16 cannot factor at all
        else:
            self.solve_dtype = landmarks.dtype
        p = landmarks.shape[0]
        self.Gc = torch.zeros((p, p), dtype=self.accum_dtype,
                              device=landmarks.device)
        self.bc: Tensor | None = None   # allocated on the first chunk's y
        self.prepared = None            # K3's landmarks, at the first CSR chunk

    def add(self, Xb, yb: Tensor, n_valid: int | None = None) -> None:
        """Fold one (possibly tail-padded) chunk into the statistics."""
        rows = Xb.shape[0]
        n_valid = rows if n_valid is None else int(n_valid)
        if self.bc is None:
            self.bc = torch.zeros((self.Z.shape[0],) + tuple(yb.shape[1:]),
                                  dtype=self.accum_dtype, device=self.Z.device)
        mb = (torch.arange(rows, device=self.Z.device) < n_valid).to(
            self.Z.dtype)
        if isinstance(Xb, CsrMatrix) and self.prepared is None:
            self.prepared = self.ops.prepare_sparse(self.Z)
        Cs = self.ops.cross(Xb, self.Z, prepared=self.prepared)
        if self.weights is not None:
            Cs = Cs * self.weights[None, :]
        # mask BEFORE the reductions: padded rows are exact zeros
        Cs = (Cs * mb[:, None]).to(self.accum_dtype)
        yb = (yb * mb.reshape((-1,) + (1,) * (yb.ndim - 1))).to(
            self.accum_dtype)
        self.Gc = self.Gc + Cs.T @ Cs
        self.bc = self.bc + Cs.T @ yb

    def finalize(self, n: int) -> "NystromState":
        """β from the statistics seen so far (p×p algebra, O(p³))."""
        if self.bc is None:
            raise ValueError("no chunks accumulated")
        cfg, sd = self.config, self.solve_dtype
        W = self.ops.cross(self.Z, self.Z).to(sd)
        Gc, bc = self.Gc.to(sd), self.bc.to(sd)
        if self.weights is not None:
            gamma = cfg.lam if cfg.gamma is None else cfg.gamma
            beta = nystrom_regularized_beta_from_stats(
                W, self.weights.to(sd), Gc, bc, n, gamma, cfg.lam)
        else:
            beta = nystrom_beta_from_stats(W, Gc, bc, n, cfg.lam,
                                           jitter=cfg.jitter)
        return NystromState(None, None, beta.to(self.Z.dtype), self.Z,
                            self.weights)


class _BufferChunkAccumulator:
    """The exact solver's accumulator: its sufficient statistic is the data
    itself, so valid rows are buffered on the host and ``finalize`` runs
    the in-memory fit on them. O(n·d) — for API uniformity and small n."""

    def __init__(self, config: SketchConfig, solver: "Solver"):
        self.config, self.solver = config, solver
        self._xs: list[Tensor] = []
        self._ys: list[Tensor] = []

    def add(self, Xb: Tensor, yb: Tensor, n_valid: int | None = None) -> None:
        """Buffer one chunk's valid rows."""
        v = Xb.shape[0] if n_valid is None else int(n_valid)
        self._xs.append(Xb[:v].cpu())
        self._ys.append(yb[:v].cpu())

    def finalize(self, n: int) -> Any:
        """Concatenate the buffered rows and run the in-memory fit."""
        if not self._xs:
            raise ValueError("no chunks accumulated")
        dev = torch.device(self.config.device)
        return self.solver.fit(self.config, torch.cat(self._xs).to(dev),
                               torch.cat(self._ys).to(dev), None)


def _require_factor(state, what: str) -> NystromApprox:
    """Loud failure for diagnostics that need the O(n·p) training factor,
    which neither an out-of-core fit nor an imported O(p) serving state
    keeps."""
    if state.approx is None:
        raise RuntimeError(
            f"{what} needs the O(n·p) training factor, which an out-of-core "
            "/ partial_fit model or one imported from an O(p) serving state "
            "does not carry (its state is the O(p) landmark dual); for "
            "closed-form diagnostics fit in memory with chunk_rows=None")
    return state.approx


# ----------------------------------------------------------------- exact

class ExactState(NamedTuple):
    alpha: Tensor     # (n,) dual coefficients
    X_train: Tensor
    K: Tensor         # kept for closed-form risk


class ExactSolver:
    """Full-K KRR (eq. 2) — the O(n³) reference everything sketches."""

    needs_sample = False

    def fit(self, config, X, y, sample):
        K = _ops(config).cross(X, X)
        K, y = _solve_cast(config, K, y)
        return ExactState(krr_fit(K, y, config.lam), X, K)

    def begin_chunked(self, config, landmarks, sample):
        """Chunked fitting by buffering rows (``_BufferChunkAccumulator``):
        the exact solver has no sufficient statistic below the data."""
        return _BufferChunkAccumulator(config, self)

    def predict(self, config, state, X_test):
        return _ops(config).matvec(X_test, state.X_train, state.alpha)

    def predict_train(self, config, state, X_train):
        return state.K @ state.alpha

    def risk(self, config, state, f_star, noise_std):
        return risk_exact(state.K, f_star, config.lam, noise_std)


SOLVERS.register("exact")(ExactSolver())


# --------------------------------------------------- Nyström (plain / L_γ)

class NystromState(NamedTuple):
    approx: NystromApprox | None
    alpha: Tensor | None       # (n,) dual through the Woodbury solve
    beta: Tensor               # (p,) landmark-space dual for prediction
    landmarks: Tensor          # (p, dim) sampled points Z
    col_weights: Tensor | None  # S weights scaling k(·, Z) (regularized only)


def _nystrom_predict(config, state, X_test):
    # (k(x, Z)·w) @ β == k(x, Z) @ (w·β): fold S's weights into the dual so
    # the whole predict is one implicit-C matvec
    beta = state.beta
    if state.col_weights is not None:
        beta = beta * state.col_weights.reshape(
            (-1,) + (1,) * (beta.ndim - 1))
    return _ops(config).matvec(X_test, state.landmarks, beta)


def _nystrom_predict_train(config, state, X_train):
    # L α through the cached factor — zero kernel evaluations
    return _require_factor(state, "predict_train()").matvec(state.alpha)


class NystromSolver:
    """Classic sketch L = C W† Cᵀ, fitted through Woodbury (Theorem 3)."""

    needs_sample = True

    def fit(self, config, X, y, sample):
        C = _ops(config).columns(X, sample.idx)
        C, y = _solve_cast(config, C, y)
        F, G = nystrom_factors(C, sample.idx, jitter=config.jitter)
        del C
        approx = NystromApprox(F, sample)
        alpha = nystrom_krr_fit(approx, y, config.lam)
        # Nyström extension: f̂(x) = k(x, Z) W† Cᵀ α = k(x, Z) G (Fᵀ α)
        beta = G @ (F.T @ alpha)
        return NystromState(approx, alpha, beta, X[sample.idx], None)

    def begin_chunked(self, config, landmarks, sample):
        """O(p²) sufficient statistics (``_NystromChunkAccumulator``)."""
        return _NystromChunkAccumulator(config, landmarks, sample,
                                        regularized=False)

    predict = staticmethod(_nystrom_predict)
    predict_train = staticmethod(_nystrom_predict_train)

    def risk(self, config, state, f_star, noise_std):
        return risk_nystrom(_require_factor(state, "risk()"), f_star,
                            config.lam, noise_std)


class NystromRegularizedSolver:
    """Footnote-4 sketch L_γ = KS(SᵀKS + nγI)^{-1}SᵀK — no λ lower-bound
    condition; γ defaults to λ when unset."""

    needs_sample = True

    def fit(self, config, X, y, sample):
        gamma = config.lam if config.gamma is None else config.gamma
        n = X.shape[0]
        C = _ops(config).columns(X, sample.idx)
        C, y = _solve_cast(config, C, y)
        F, Lchol = nystrom_regularized_factors(C, sample.idx, sample.weights,
                                               n, gamma)
        del C
        approx = NystromApprox(F, sample)
        alpha = nystrom_krr_fit(approx, y, config.lam)
        # f̂(x) = (k(x, Z)·w) A^{-1} Csᵀ α = (k(x, Z)·w) L^{-T} (Fᵀ α)
        FTa = F.T @ alpha
        beta = torch.linalg.solve_triangular(
            Lchol.T, FTa[:, None] if FTa.ndim == 1 else FTa, upper=True)
        beta = beta[:, 0] if FTa.ndim == 1 else beta
        return NystromState(approx, alpha, beta, X[sample.idx],
                            sample.weights)

    def begin_chunked(self, config, landmarks, sample):
        """O(p²) sufficient statistics of the L_γ sketch
        (``_NystromChunkAccumulator``)."""
        return _NystromChunkAccumulator(config, landmarks, sample,
                                        regularized=True)

    predict = staticmethod(_nystrom_predict)
    predict_train = staticmethod(_nystrom_predict_train)

    def risk(self, config, state, f_star, noise_std):
        return risk_nystrom(_require_factor(state, "risk()"), f_star,
                            config.lam, noise_std)


SOLVERS.register("nystrom")(NystromSolver())
SOLVERS.register("nystrom_regularized")(NystromRegularizedSolver())


# ----------------------------------------------------- divide and conquer

class DnCState(NamedTuple):
    model: DnCModel
    X_train: Tensor


class DnCSolver:
    """Zhang-Duchi-Wainwright m-partition averaging (§1 baseline): one K1
    Gram and one Cholesky per partition, ``config.partitions`` of them."""

    needs_sample = False

    def fit(self, config, X, y, sample, *, partitions=None):
        model = dnc_fit(config.kernel, X, y, config.lam, config.partitions,
                        streams(config.seed, 3)[2], partitions=partitions,
                        ops=_ops(config))
        return DnCState(model, X)

    def predict(self, config, state, X_test):
        return dnc_predict(config.kernel, state.X_train, state.model,
                           X_test, ops=_ops(config))

    def predict_train(self, config, state, X_train):
        return dnc_predict_train(config.kernel, state.X_train, state.model,
                                 ops=_ops(config))

    def risk(self, config, state, f_star, noise_std):
        return None  # no closed form: the estimator takes the empirical risk


SOLVERS.register("dnc")(DnCSolver())


# ------------------------------------------- iterative landmark-space fits

class IterativeState(NamedTuple):
    """Fitted state of the iterative solvers: the serving triple (β, Z, w)
    plus convergence telemetry. Field names match ``NystromState`` where
    they overlap, so ``_nystrom_predict``, ``export_serving_state`` and
    ``_require_factor`` apply unchanged; ``approx``/``alpha`` are always
    None, because an iterative fit never forms the O(n·p) factor."""

    approx: None
    alpha: None
    beta: Tensor               # (p,) / (p, k) landmark dual
    landmarks: Tensor          # (p, dim) sampled points Z
    col_weights: Tensor        # S weights scaling k(·, Z)
    iters: int                 # PCG iterations / EigenPro epochs run
    residuals: Tensor          # per-iteration ‖r‖/‖b‖ or per-epoch ‖Δβ‖/‖β‖


def _resolved_gamma(config: SketchConfig) -> float:
    """γ defaults to λ when unset (footnote 4)."""
    return config.lam if config.gamma is None else config.gamma


def _iter_predict_train(config, state, X_train):
    # no cached factor: the training block again through the backend, the
    # cost of any predict
    if X_train is None:
        raise RuntimeError(
            "predict_train() of an iterative solver recomputes the training "
            "block and needs the in-memory training set, which an "
            "out-of-core / partial_fit model does not keep")
    return _nystrom_predict(config, state, X_train)


class _FalkonChunkAccumulator(_NystromChunkAccumulator):
    """Chunked FALKON: the regularized sketch's one-pass O(p²) statistics
    (inherited), finalized by Nyström-preconditioned CG in place of the
    O(p³) factorization. The data streams once whatever the iteration
    count, so this is the ``partial_fit``-ready iterative route;
    multi-output y and repeated ``finalize`` calls work as for the
    parent."""

    def __init__(self, config: SketchConfig, landmarks: Tensor,
                 sample: ColumnSample | None):
        super().__init__(config, landmarks, sample, regularized=True)

    def finalize(self, n: int) -> IterativeState:
        """β by PCG on the accumulated normal equations (p×p a step)."""
        if self.bc is None:
            raise ValueError("no chunks accumulated")
        cfg, sd = self.config, self.solve_dtype
        W = self.ops.cross(self.Z, self.Z).to(sd)
        w = self.sample.weights
        res = falkon_pcg_from_stats(
            W, w.to(sd), self.Gc.to(sd), self.bc.to(sd), n,
            _resolved_gamma(cfg), cfg.lam, tol=cfg.solver_tol,
            max_iters=cfg.solver_iters,
            jitter=storage_floored_jitter(cfg.jitter, self.Z.dtype))
        return IterativeState(None, None, res.beta.to(self.Z.dtype), self.Z,
                              w, res.iters, res.residuals)


class _EigenProChunkAccumulator:
    """Multi-epoch streaming EigenPro, driven by the out-of-core epoch loop
    through ``end_pass``.

    Pass 1 ("collect") keeps the first ``precond_subsample`` valid rows on
    the host (the streamed twin of the in-memory fit's random subsample,
    fixed by the source's order) and the largest chunk; its ``end_pass``
    builds the penalty block, the deflation preconditioner and the batch
    plan. Later passes are optimization epochs: SGD passes update β once
    per mini-batch inside each chunk (``make_chunk_step``), polish passes
    sum the exact gradient over the chunks (``make_chunk_grad``) and step
    once in ``end_pass`` (``make_polish_step``), stopping early at
    ``solver_tol``. Between chunks it holds O(p²) and the subsample; a
    chunk's compute holds O(batch_rows·p).
    """

    def __init__(self, config: SketchConfig, landmarks: Tensor,
                 sample: ColumnSample | None):
        self.config = config
        self.ops = _ops(config)
        self.Z = landmarks
        self.sample = sample
        self._phase = "collect"
        self._s_target = (config.precond_subsample
                          if config.precond_subsample is not None else 4000)
        self._sub_x: list[Tensor] = []
        self._sub_rows = 0
        self._max_chunk = 0
        self._ytrail: tuple | None = None
        self._steps: dict = {}
        self._grads: dict = {}
        self._deltas: list[float] = []
        self._epochs_ran = 0

    # ------------------------------------------------------- per-chunk add

    def add(self, Xb: Tensor, yb: Tensor, n_valid: int | None = None) -> None:
        """Fold one chunk into the current pass (by phase)."""
        v = Xb.shape[0] if n_valid is None else int(n_valid)
        if self._phase == "collect":
            if self._ytrail is None:
                self._ytrail = tuple(yb.shape[1:])
            self._max_chunk = max(self._max_chunk, v)
            take = min(self._s_target - self._sub_rows, v)
            if take > 0:
                self._sub_x.append(Xb[:take].cpu())
                self._sub_rows += take
        elif self._phase == "sgd":
            self._beta = self._step_for(Xb.shape[0])(self._beta, Xb, yb, v)
        else:
            self._gsum = self._gsum + self._grad_for(Xb.shape[0])(
                self._beta, Xb, yb, v)

    def _step_for(self, rows: int):
        fn = self._steps.get(rows)
        if fn is None:
            fn = make_chunk_step(self.ops, self.Z, self.sample.weights,
                                 self._A, self.config.lam, self._precond,
                                 chunk_rows=rows, batch_rows=self._m,
                                 solve_dtype=self._sd)
            self._steps[rows] = fn
        return fn

    def _grad_for(self, rows: int):
        fn = self._grads.get(rows)
        if fn is None:
            fn = make_chunk_grad(self.ops, self.Z, self.sample.weights,
                                 chunk_rows=rows, batch_rows=self._m,
                                 solve_dtype=self._sd)
            self._grads[rows] = fn
        return fn

    # -------------------------------------------------- the epoch protocol

    def _setup(self, n: int) -> None:
        """End of the collect pass: what the iteration needs, from the
        streamed subsample and the landmark block."""
        cfg, ops, Z = self.config, self.ops, self.Z
        p = Z.shape[0]
        _, sd = landmark_solve_dtypes(ops, Z.dtype)
        self._sd = sd
        wgt = self.sample.weights
        self._A = penalty_block(ops, Z, wgt, n, _resolved_gamma(cfg),
                                cfg.jitter, sd)
        k = cfg.precond_k if cfg.precond_k is not None else min(p - 1, 64)
        X_sub = torch.cat(self._sub_x).to(Z.device)
        self._sub_x = []     # free the host buffer before the epochs
        self._precond = build_preconditioner(ops, X_sub, Z, wgt, self._A,
                                             cfg.lam, k, sd)
        self._m = auto_batch_rows(n, p, Z.dtype.itemsize,
                                  cfg.batch_budget_mb)
        # a step's rows never exceed the chunk, so a multi-chunk source is
        # stochastic even under a generous memory budget
        self._sgd_left = sgd_epoch_budget(
            cfg.epochs, min(self._m, self._max_chunk), n)
        self._phase = "sgd" if self._sgd_left > 0 else "polish"
        self._polish = make_polish_step(self._A, cfg.lam, self._precond, n)
        self._beta = torch.zeros((p,) + self._ytrail, dtype=sd,
                                 device=Z.device)
        self._beta_prev = self._beta
        self._gsum = torch.zeros_like(self._beta)

    def end_pass(self, n: int) -> bool:
        """One streamed pass is over; True asks the driver to stream the
        source again (``out_of_core.fit_from_source``)."""
        cfg = self.config
        if self._phase == "collect":
            self._setup(n)
            return True
        if self._phase == "sgd":
            self._deltas.append(rel_delta(self._beta_prev, self._beta))
            self._epochs_ran += 1
            self._sgd_left -= 1
            if self._sgd_left <= 0:
                self._phase = "polish"
            self._beta_prev = self._beta
            return self._epochs_ran < cfg.epochs
        new = self._polish(self._beta, self._gsum)
        rel = rel_delta(self._beta, new)
        self._beta = self._beta_prev = new
        self._gsum = torch.zeros_like(self._gsum)
        self._deltas.append(rel)
        self._epochs_ran += 1
        return self._epochs_ran < cfg.epochs and rel > cfg.solver_tol

    def finalize(self, n: int) -> IterativeState:
        """The fitted state; it exists only after optimization epochs."""
        if self._phase == "collect":
            raise RuntimeError(
                "solver 'eigenpro' fits by re-streaming the source once "
                "per epoch (the end_pass protocol), which partial_fit's "
                "single-pass chunk feed never drives; fit(source) runs "
                "the epochs, or use solver='falkon_pcg' for an iterative "
                "solver with one-pass statistics that partial_fit "
                "supports")
        return IterativeState(None, None, self._beta.to(self.Z.dtype),
                              self.Z, self.sample.weights, self._epochs_ran,
                              torch.tensor(self._deltas,
                                           dtype=torch.float32))


class EigenProSolver:
    """Preconditioned mini-batch SGD in landmark coordinates
    (``core.eigenpro``): the ``nystrom_regularized`` fixed point, never
    factoring more than the p×p subsample covariance. In-memory fits run
    ``eigenpro_fit``; ``fit(ChunkSource)`` streams the data once per epoch
    through the accumulator above."""

    needs_sample = True

    def fit(self, config, X, y, sample):
        Z = X[sample.idx]
        res = eigenpro_fit(_ops(config), X, y, Z, sample.weights,
                           config.lam, _resolved_gamma(config),
                           streams(config.seed, 3)[2],
                           epochs=config.epochs, tol=config.solver_tol,
                           precond_k=config.precond_k,
                           subsample=config.precond_subsample,
                           budget_mb=config.batch_budget_mb,
                           jitter=config.jitter)
        return IterativeState(None, None, res.beta.to(Z.dtype), Z,
                              sample.weights, res.epochs, res.deltas)

    def begin_chunked(self, config, landmarks, sample):
        """Multi-epoch streaming accumulator (``end_pass``); ``partial_fit``
        cannot drive it, and its ``finalize`` says so."""
        return _EigenProChunkAccumulator(config, landmarks, sample)

    predict = staticmethod(_nystrom_predict)
    predict_train = staticmethod(_iter_predict_train)

    def risk(self, config, state, f_star, noise_std):
        return None  # no closed form: the estimator takes the empirical risk


class FalkonPCGSolver:
    """FALKON-style Nyström-preconditioned CG on the regularized sketch's
    normal equations (``core.distributed.falkon_pcg_krr``): the
    ``nystrom_regularized`` β in tens of iterations, each one
    ``gram_matvec`` through the backend and two p×p triangular solves.
    Chunked fits (and ``partial_fit``) run PCG on one-pass O(p²)
    statistics."""

    needs_sample = True

    def fit(self, config, X, y, sample):
        Z = X[sample.idx]
        res = falkon_pcg_krr(_ops(config), X, y, Z, sample.weights,
                             config.lam, _resolved_gamma(config),
                             tol=config.solver_tol,
                             max_iters=config.solver_iters,
                             jitter=config.jitter)
        return IterativeState(None, None, res.beta.to(Z.dtype), Z,
                              sample.weights, res.iters, res.residuals)

    def begin_chunked(self, config, landmarks, sample):
        """One-pass O(p²) statistics finalized by PCG
        (``_FalkonChunkAccumulator``)."""
        return _FalkonChunkAccumulator(config, landmarks, sample)

    predict = staticmethod(_nystrom_predict)
    predict_train = staticmethod(_iter_predict_train)

    def risk(self, config, state, f_star, noise_std):
        return None  # no closed form: the estimator takes the empirical risk


SOLVERS.register("eigenpro")(EigenProSolver())
SOLVERS.register("falkon_pcg")(FalkonPCGSolver())
