"""Ridge-leverage Nyström attention — the paper's technique as an LM feature.

The port of ``core/attention_nystrom.py``. The attention matrix
A = exp(Q Kᵀ/√d) factors through the SPSD key Gram
G = exp(-‖k_i − k_j‖²/(2√d)) up to diagonal scalings that the softmax
normaliser absorbs, so the paper's machinery applies to it:

  * ``key_rls_scores`` — λ-ridge leverage scores of G (Definition 1) by the
    Theorem-4 estimator from p strided sketch columns, O(s·p²) a head, plus
    the novelty term for keys outside the sketch's span;
  * ``select_landmarks`` — the top-p positions by score, sorted;
  * ``nystrom_attention`` — causal: exact softmax over the p selected key
    columns (RLS-sparse attention); non-causal: the regularised Nyström
    reconstruction in RBF factors;
  * ``rls_kv_compression`` — a KV cache cut to its p highest-scoring
    entries, with a pinned trailing window.

The arithmetic is the reference's, dtype for dtype: the scores in float32,
the prefill's logits, softmax and ``w·v`` in the activation dtype with the
scale rounded to it (√128 is 11.3125 in bfloat16). Two behaviours of the
reference are kept on purpose: a Cholesky factorisation that fails gives
NaN for its batch entry (``jnp.linalg.cholesky`` does; ``torch.linalg.
cholesky`` would raise), and top-p selection ranks NaN above +inf and
breaks ties by the lower index (``lax.top_k``'s order; ``torch.topk``'s
differs, so selection is a stable descending sort). ROADMAP R9 is the case
where the first happens on a partly filled cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor


def _cholesky(a: Tensor) -> Tensor:
    """Lower Cholesky factor; a batch entry whose factorisation fails is
    NaN throughout, as ``jnp.linalg.cholesky`` returns it."""
    L, info = torch.linalg.cholesky_ex(a)
    bad = (info > 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def _gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """x[..., idx, :] per batch entry: (..., s, d), (..., p) → (..., p, d)."""
    return torch.take_along_dim(x, idx[..., :, None].long(), dim=-2)


def _sym(a: Tensor) -> Tensor:
    return 0.5 * (a + a.transpose(-1, -2))


def _rbf_gram_cols(K_feats: Tensor, idx: Tensor, scale: Tensor) -> Tensor:
    """G[:, idx] for G_ij = exp(-‖k_i−k_j‖²/(2·scale)). Shapes (..., s, d)."""
    Z = _gather_rows(K_feats, idx)
    d2 = ((K_feats ** 2).sum(-1)[..., :, None]
          + (Z ** 2).sum(-1)[..., None, :]
          - 2.0 * torch.matmul(K_feats, Z.transpose(-1, -2)))
    return torch.exp(-d2.clamp_min(0.0) / (2.0 * scale))


def key_rls_scores(K_feats: Tensor, p_sketch: int,
                   lam: float = 1e-3) -> Tensor:
    """Fast λ-ridge leverage scores of the key RBF Gram (paper §3.5),
    (..., s, d) → (..., s) float32, in [0, 1] (NaN where a factorisation
    failed).

    The sketch columns are the strided positions (arange(p)·max(s//p, 1))
    mod s: diag(G) = 1, so the squared-length distribution is uniform and a
    stride is an exact β = 1 draw made deterministic. The novelty term
    d_i/(d_i + s·λ), d_i = 1 − ‖B_i‖² the Nyström residual, keeps a key
    outside the sketch's span from scoring about 0."""
    s, d = K_feats.shape[-2], K_feats.shape[-1]
    K_feats = K_feats.float()   # the Cholesky path needs ≥ float32
    dev = K_feats.device
    scale = torch.sqrt(torch.tensor(float(d), device=dev))
    stride = max(s // p_sketch, 1)
    idx = (torch.arange(p_sketch, device=dev) * stride) % s
    idx = idx.expand(K_feats.shape[:-2] + (p_sketch,))
    C = _rbf_gram_cols(K_feats, idx, scale)                    # (..., s, p)
    W = _gather_rows(C, idx)                                   # (..., p, p)
    eye = torch.eye(p_sketch, device=dev)
    Lc = _cholesky(_sym(W) + 1e-6 * eye)
    B = torch.linalg.solve_triangular(
        Lc, C.transpose(-1, -2), upper=False).transpose(-1, -2)
    G = torch.matmul(B.transpose(-1, -2), B) + s * lam * eye
    La = _cholesky(_sym(G))
    V = torch.linalg.solve_triangular(La, B.transpose(-1, -2), upper=False)
    in_span = (V * V).sum(-2)                                  # (..., s)
    # novelty: unexplained diagonal mass (G_ii = 1 for the RBF Gram)
    deficit = (1.0 - (B * B).sum(-1)).clamp_min(0.0)
    novelty = deficit / (deficit + s * lam)
    return (in_span + novelty).clamp(0.0, 1.0)


def select_landmarks(scores: Tensor, p: int) -> Tensor:
    """The top-p positions by score, sorted (int64): ``lax.top_k``'s
    selection, NaN above +inf and, among equal scores, the lower index
    first."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return torch.sort(order[..., :p], dim=-1).values


def _softmax(x: Tensor) -> Tensor:
    """``jax.nn.softmax``'s arithmetic in x's dtype: exp(x − max), each step
    rounded to the dtype, over its sum (taken in float32 for bfloat16). A
    row that is −inf throughout gives NaN, as the reference's does."""
    un = torch.exp(x - x.amax(dim=-1, keepdim=True).detach())
    return un / un.sum(dim=-1, keepdim=True)


class NystromAttnOut(NamedTuple):
    out: Tensor          # (..., s_q, d_v)
    landmarks: Tensor    # (..., p) selected key positions


def nystrom_attention(q: Tensor, k: Tensor, v: Tensor, *,
                      num_landmarks: int, lam: float = 1e-3,
                      gamma: float = 1e-4, causal: bool = True,
                      landmarks: Tensor | None = None) -> NystromAttnOut:
    """Sub-quadratic landmark attention with RLS-selected landmarks.

    q: (..., s_q, d), k: (..., s_k, d), v: (..., s_k, d_v). Landmarks are
    the top ``num_landmarks`` positions of ``key_rls_scores(k, min(2·p,
    s_k), lam)`` unless given. No gradient flows through the selection (its
    indices are integers), so the scores are computed without recording.

    causal: RLS-sparse attention — the exact softmax over the p selected key
    columns under the causal mask; a query that sees no landmark gives
    zeros. It equals exact attention at p = s.

    non-causal: out = Cq (W + γ·p·I)⁻¹ Ck (dk ⊙ V) / (the same with 1 for
    V), all factors RBF (entries in [0, 1]) and dk the per-key softmax
    weight, stabilised by the largest ‖k‖².
    """
    d = q.shape[-1]
    s_q, s_k = q.shape[-2], k.shape[-2]
    dt = q.dtype
    scale = torch.sqrt(torch.tensor(float(d), device=q.device)).to(dt)
    if landmarks is None:
        with torch.no_grad():
            scores = key_rls_scores(k, min(2 * num_landmarks, s_k), lam)
            landmarks = select_landmarks(scores, num_landmarks)
    p = landmarks.shape[-1]
    k_lm = _gather_rows(k, landmarks)                         # (..., p, d)

    if causal:
        v_lm = _gather_rows(v, landmarks)
        logits = torch.matmul(q, k_lm.transpose(-1, -2)) / scale
        q_pos = torch.arange(s_q, device=q.device)
        mask = q_pos[:, None] >= landmarks[..., None, :]       # (..., s_q, p)
        w = _softmax(logits.masked_fill(~mask, float("-inf")))
        w = torch.where(mask.any(-1, keepdim=True), w, torch.zeros_like(w))
        return NystromAttnOut(torch.matmul(w, v_lm), landmarks)

    def rbf(a: Tensor, b: Tensor) -> Tensor:   # entries in [0, 1]
        d2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
              - 2.0 * torch.matmul(a, b.transpose(-1, -2)))
        return torch.exp(-d2.clamp_min(0.0) / (2.0 * scale))

    Cq = rbf(q, k_lm)                                          # (..., s_q, p)
    Ck = rbf(k_lm, k)                                          # (..., p, s_k)
    W = rbf(k_lm, k_lm)                                        # (..., p, p)
    # per-key softmax-kernel weight, globally stabilised, in (0, 1]
    kk = (k * k).sum(-1) / (2.0 * scale)                       # (..., s_k)
    dk = torch.exp(kk - kk.amax(-1, keepdim=True).detach())
    eye = torch.eye(p, dtype=dt, device=q.device)
    Lc = _cholesky(_sym(W) + gamma * p * eye)
    CkV = torch.matmul(Ck, v * dk[..., :, None])
    Ck1 = torch.matmul(Ck, dk[..., :, None])
    sol = torch.cholesky_solve(torch.cat([CkV, Ck1], dim=-1), Lc,
                               upper=False)
    mid = torch.matmul(Cq, sol)
    out = mid[..., :-1] / mid[..., -1:].clamp_min(1e-9)
    return NystromAttnOut(out, landmarks)


class CompressedKV(NamedTuple):
    k: Tensor            # (..., p, d)
    v: Tensor            # (..., p, d_v)
    positions: Tensor    # (..., p) original positions
    scores: Tensor       # (..., s) the RLS scores used


def rls_kv_compression(k: Tensor, v: Tensor, p: int, *, lam: float = 1e-3,
                       p_sketch: int | None = None,
                       keep_recent: int = 0) -> CompressedKV:
    """A KV cache cut to its p highest-ridge-leverage entries (sketch
    min(max(2p, 64), s) unless given). ``keep_recent`` pins the last
    ``keep_recent`` slots of the buffer with a +inf score — the buffer's
    last slots, not the last tokens written (ROADMAP R8, as the
    reference)."""
    s = k.shape[-2]
    sketch = p_sketch if p_sketch is not None else min(max(2 * p, 64), s)
    scores = key_rls_scores(k, sketch, lam)
    if keep_recent > 0:
        recent = torch.arange(s, device=k.device) >= (s - keep_recent)
        scores = scores.masked_fill(recent, float("inf"))
    idx = select_landmarks(scores, p)
    return CompressedKV(_gather_rows(k, idx), _gather_rows(v, idx), idx,
                        scores)
