"""Attention blocks: GQA (full / sliding-window / Nyström-RLS) + KV cache.

The port of ``models/attention.py``:

  * prefill/training — ``attention_block``, the reference's branches in its
    order: with ``cfg.attn_approx="nystrom_rls"`` the paper's RLS-sparse
    landmark attention (``core.attention_nystrom``, causal, the keys
    repeated to every query head); else K4 through ``kernels.ops.attention``
    when ``cfg.use_pallas`` and no softcap; else, past 1,024 tokens, the
    chunked online softmax (``flash_attention_chunked``, the forward of the
    reference's ``flash_attention_jnp``); else the softcapped or the plain
    reference.
  * decode — one token against the KV cache (``decode_attention_block``):
    exact; with ``nystrom_rls`` against the landmark positions frozen in
    the state plus a recency window (``_decode_rls_frozen``), or, with no
    frozen landmarks, against the cache cut to its p highest-scoring
    entries at every step (``_decode_rls_compressed``). They keep the
    reference's faults (ROADMAP): R7 in the first, R8 and R9 in the second;
    and ``refresh_landmarks``, which nothing calls, as the reference does.

Layouts as the reference's: activations (b, s, d), attention operands
(b, h, s, dh), caches (b, hkv, S_max, dh) per layer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..configs.base import ModelConfig
from ..core.attention_nystrom import (key_rls_scores, nystrom_attention,
                                      rls_kv_compression, select_landmarks)
from ..kernels import ops, ref
from .layers import apply_rope, rope_frequencies, softcap_logits, \
    truncated_normal_init


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dt: torch.dtype) -> dict:
    d, h, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    return {
        "wq": truncated_normal_init(generator, (d, h, dh), d ** -0.5, dt),
        "wk": truncated_normal_init(generator, (d, hk, dh), d ** -0.5, dt),
        "wv": truncated_normal_init(generator, (d, hk, dh), d ** -0.5, dt),
        "wo": truncated_normal_init(generator, (h, dh, d), (h * dh) ** -0.5,
                                    dt),
    }


class KVCache(NamedTuple):
    k: Tensor    # (..., b, hkv, S_max, dh)
    v: Tensor    # (..., b, hkv, S_max, dh)


def init_kv_cache(cfg: ModelConfig, layers: int, batch: int, max_len: int,
                  *, device="cuda") -> KVCache:
    """Zeroed stacked caches (layers, b, hkv, max_len, dh) in the
    activation dtype; layer i's cache is ``KVCache(k[i], v[i])``."""
    shape = (layers, batch, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.act_dtype, device=device),
                   torch.zeros(shape, dtype=cfg.act_dtype, device=device))


def _project(x: Tensor, w: Tensor) -> Tensor:
    """einsum("bsd,dhe->bshe", x, w) as one matrix product, w cast to x's
    dtype."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e).to(x.dtype)).reshape(*x.shape[:-1], h, e)


def _qkv(params: dict, cfg: ModelConfig, x: Tensor,
         positions: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """q (b, s, h, dh), k and v (b, s, hkv, dh), RoPE applied to q and k."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    cos, sin = rope_frequencies(cfg.resolved_head_dim, cfg.rotary_frac,
                                cfg.rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _out_proj(params: dict, out: Tensor) -> Tensor:
    """einsum("bshe,hed->bsd", out, wo) as one matrix product, wo cast to
    out's dtype."""
    h, e, d = params["wo"].shape
    w = params["wo"].reshape(h * e, d).to(out.dtype)
    return out.reshape(*out.shape[:2], h * e) @ w


def attention_block(params: dict, cfg: ModelConfig, x: Tensor,
                    positions: Tensor, *, window: int = 0) -> Tensor:
    """Training / prefill self-attention. x: (b, s, d) → (b, s, d)."""
    s = x.shape[1]
    q, k, v = _qkv(params, cfg, x, positions)
    qt = q.transpose(1, 2)       # (b, h, s, dh)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if cfg.attn_approx == "nystrom_rls":
        # the paper's technique: RLS landmark attention (causal → RLS-sparse)
        rep = cfg.n_heads // cfg.n_kv_heads
        kq = kt.repeat_interleave(rep, dim=1) if rep > 1 else kt
        vq = vt.repeat_interleave(rep, dim=1) if rep > 1 else vt
        out = nystrom_attention(qt, kq, vq,
                                num_landmarks=min(cfg.nystrom_landmarks, s),
                                causal=True).out
    elif cfg.use_pallas and cfg.attn_softcap == 0:
        out = ops.attention(qt, kt, vt, causal=True, window=window)
    elif s > 1024:
        # chunked online softmax: the memory-safe path
        out = flash_attention_chunked(qt, kt, vt, causal=True, window=window,
                                      softcap=cfg.attn_softcap)
    elif cfg.attn_softcap > 0:
        out = _softcap_attention(qt, kt, vt, cfg.attn_softcap, window)
    else:
        out = ref.attention_ref(qt, kt, vt, causal=True, window=window)
    return _out_proj(params, out.transpose(1, 2))


def _chunk_live(qi: int, kj: int, cq: int, ck: int, causal: bool,
                window: int) -> bool:
    live = True
    if causal:
        live &= kj * ck <= qi * cq + cq - 1
    if window > 0:
        live &= (qi * cq - (kj * ck + ck - 1)) < window
    return live


def flash_attention_chunked(q: Tensor, k: Tensor, v: Tensor, *,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0, chunk_q: int = 512,
                            chunk_k: int = 1024) -> Tensor:
    """Doubly-chunked online-softmax attention (exact), the forward of the
    reference's ``flash_attention_jnp``: float32 logits scaled after the
    product, the softcap, masked logits at −1e30, chunk pairs that the mask
    hides entirely skipped, O(b·h·cq·ck) transients.
    q: (b, hq, s, d); k/v: (b, hkv, s, d) — GQA-aware."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    cq = min(chunk_q, s)
    ck = min(chunk_k, s)
    if s % cq or s % ck:
        cq = ck = s  # one chunk on odd sizes
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, g, s, d)
    out = torch.empty((b, hkv, g, s, d), dtype=q.dtype, device=q.device)
    pos = torch.arange(s, device=q.device)
    for qi in range(s // cq):
        q_blk = qg[:, :, :, qi * cq:(qi + 1) * cq].float()
        m = torch.full((b, hkv, g, cq, 1), -1e30, device=q.device)
        l = torch.zeros((b, hkv, g, cq, 1), device=q.device)
        acc = torch.zeros((b, hkv, g, cq, d), device=q.device)
        for kj in range(s // ck):
            if not _chunk_live(qi, kj, cq, ck, causal, window):
                continue
            k_blk = k[:, :, None, kj * ck:(kj + 1) * ck].float()
            v_blk = v[:, :, None, kj * ck:(kj + 1) * ck].float()
            logits = torch.matmul(q_blk, k_blk.transpose(-1, -2)) * scale
            if softcap > 0:
                logits = softcap * torch.tanh(logits / softcap)
            mask = ref.attention_mask(pos[qi * cq:(qi + 1) * cq],
                                      pos[kj * ck:(kj + 1) * ck], causal,
                                      window)
            logits = logits.masked_fill(~mask, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_new).masked_fill(~mask, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.matmul(p, v_blk)
            m = m_new
        out[:, :, :, qi * cq:(qi + 1) * cq] = (
            acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(b, hq, s, d)


def _softcap_attention(q: Tensor, k: Tensor, v: Tensor, cap: float,
                       window: int) -> Tensor:
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    logits = torch.matmul(q, k.transpose(-1, -2)).float() / (D ** 0.5)
    logits = softcap_logits(logits, cap)
    pos = torch.arange(S, device=q.device)
    logits = logits.masked_fill(~ref.attention_mask(pos, pos, True, window),
                                -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)


# ------------------------------------------------------------------ decode

class DecodeState(NamedTuple):
    cache: KVCache   # one layer's (b, hkv, S_max, dh) caches
    length: int      # global write pointer (tokens in the cache)
    start: Tensor    # (b,) int32 — per-slot visibility start (continuous
                     # batching: a re-used slot must not see its predecessor)
    lm: Tensor | None = None   # (b, hkv, p) int32 — frozen RLS landmark
                               # positions, or None


def decode_attention_block(params: dict, cfg: ModelConfig, x: Tensor,
                           state: DecodeState, *, window: int = 0,
                           ) -> tuple[Tensor, DecodeState]:
    """One decode step. x: (b, 1, d); the cache holds ``state.length``
    tokens. Every slot takes the global write pointer as its RoPE position,
    as the reference does (RoPE is relative, so a slot's own offset is not
    needed). The new key and value are written into the cache in place;
    the returned state shares its tensors. With ``cfg.attn_approx=
    "nystrom_rls"`` the query reads the frozen landmarks ``state.lm`` and a
    recency window, or, when ``state.lm`` is None, the cache cut to its RLS
    landmarks at this step."""
    b = x.shape[0]
    positions = torch.full((b, 1), state.length, device=x.device)
    q, k_new, v_new = _qkv(params, cfg, x, positions)
    cache = state.cache
    cache.k[:, :, state.length] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, :, state.length] = v_new[:, 0].to(cache.v.dtype)
    qt = q.transpose(1, 2)                              # (b, h, 1, dh)
    if cfg.attn_approx == "nystrom_rls" and state.lm is not None:
        out = _decode_rls_frozen(qt, cache.k, cache.v, state.length,
                                 state.start, state.lm, cfg)
    elif cfg.attn_approx == "nystrom_rls":
        out = _decode_rls_compressed(qt, cache.k, cache.v, state.length,
                                     state.start, cfg)
    else:
        out = _decode_exact(qt, cache.k, cache.v, state.length, state.start,
                            cfg, window)
    o = _out_proj(params, out.transpose(1, 2).to(x.dtype))
    return o, DecodeState(cache, state.length + 1, state.start, state.lm)


def _length_mask(S: int, length: int, window: int, start: Tensor) -> Tensor:
    """(b, S) visibility mask: [start_b, length] ∩ window."""
    pos = torch.arange(S, device=start.device)[None, :]
    mask = (pos <= length) & (pos >= start[:, None])
    if window > 0:
        mask &= pos > (length - window)
    return mask


def _decode_exact(q: Tensor, k: Tensor, v: Tensor, length: int, start: Tensor,
                  cfg: ModelConfig, window: int) -> Tensor:
    """q: (b, h, 1, dh) against the cache (b, hkv, S, dh), float32 — O(S)
    masked attention."""
    B, Hq, _, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    logits = torch.matmul(qg, k.float().transpose(-1, -2)) / (D ** 0.5)
    if cfg.attn_softcap > 0:
        logits = softcap_logits(logits, cfg.attn_softcap)
    mask = _length_mask(k.shape[2], length, window, start)
    logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w, v.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def _attend(q: Tensor, k: Tensor, v: Tensor, valid: Tensor) -> Tensor:
    """q: (b, h, 1, dh) against gathered entries k, v (b, hkv, n, dh) whose
    mask ``valid`` is (b, hkv, n), in float32; masked logits −1e30."""
    B, Hq, _, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    logits = torch.matmul(qg, k.float().transpose(-1, -2)) / (D ** 0.5)
    logits = logits.masked_fill(~valid[:, :, None, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w, v.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def _decode_rls_frozen(q: Tensor, k: Tensor, v: Tensor, length: int,
                       start: Tensor, lm: Tensor, cfg: ModelConfig) -> Tensor:
    """Amortised RLS-compressed decode: attend to the p landmark positions
    frozen in the state and a recency window of r = max(rls_keep_recent, 1)
    positions, max(length − r + 1 + arange(r), 0), reading p + r cache
    entries a step instead of S. As the reference: a recent position that is
    also a landmark is read twice, and while length < r position 0 fills
    the window's clamped slots (ROADMAP R7)."""
    r = max(cfg.rls_keep_recent, 1)
    rec = (length - r + 1 + torch.arange(r, device=lm.device)).clamp_min(0)
    pos = torch.cat([lm.long(), rec.expand(lm.shape[:-1] + (r,))], dim=-1)
    idx = pos[..., None]
    k_c = torch.take_along_dim(k, idx, dim=-2)
    v_c = torch.take_along_dim(v, idx, dim=-2)
    valid = (pos <= length) & (pos >= start[:, None, None])
    return _attend(q, k_c, v_c, valid)


def refresh_landmarks(k_cache: Tensor, length: int, start: Tensor, p: int,
                      lam: float = 1e-3, p_sketch: int = 256) -> Tensor:
    """RLS landmark positions (b, hkv, p) int32 of the live cache: keys
    outside [start_b, length] zeroed before scoring and ranked −inf. The
    reference defines it for a refresh every R decode steps but nothing
    calls it (ROADMAP R7); neither does the port. k_cache: (b, hkv, S, dh)."""
    S = k_cache.shape[2]
    mask = _length_mask(S, length, 0, start)                   # (b, S)
    k_m = torch.where(mask[:, None, :, None], k_cache,
                      torch.zeros((), dtype=k_cache.dtype,
                                  device=k_cache.device))
    scores = key_rls_scores(k_m, min(p_sketch, S), lam)
    scores = scores.masked_fill(~mask[:, None, :], float("-inf"))
    return select_landmarks(scores, p).to(torch.int32)


def _decode_rls_compressed(q: Tensor, k: Tensor, v: Tensor, length: int,
                           start: Tensor, cfg: ModelConfig) -> Tensor:
    """The paper's technique at decode: read only the p = O(d_eff) highest-
    ridge-leverage cache entries (and the pinned window) instead of all S,
    scoring the whole buffer at every step with unwritten and foreign slots
    zeroed. As the reference: the pins are the buffer's last slots (ROADMAP
    R8), and on a partly filled cache the float32 factorisation can fail,
    giving NaN scores (R9)."""
    S = k.shape[2]
    mask = _length_mask(S, length, 0, start)
    k_m = torch.where(mask[:, None, :, None], k,
                      torch.zeros((), dtype=k.dtype, device=k.device))
    comp = rls_kv_compression(k_m, v, min(cfg.nystrom_landmarks, S),
                              keep_recent=cfg.rls_keep_recent)
    valid = (comp.positions <= length) \
        & (comp.positions >= start[:, None, None])           # (b, hkv, p)
    return _attend(q, comp.k, comp.v, valid)
