"""Decoder-only LM, the dense family: the port of ``models/transformer.py``.

  [attention + gated MLP] × L, with optional post-norms and gemma2's
  alternating local windows (even layers local).

Entry points:
  init_model(cfg, generator, device=, dtype=)  → params
  forward(params, cfg, tokens)                 → ForwardOut(logits, aux)
  loss_fn(params, cfg, tokens, labels)         → scalar CE (training)
  init_decode_state(cfg, batch, max_len)       → DecodeCaches
  decode_step(params, cfg, tokens, state)      → logits, new state

Parameters are plain dicts of tensors, with a Python list of per-layer
dicts under "layers" (the reference stacks them on a leading axis for
``lax.scan``; ``convert.params_from_reference`` unstacks). Every weight is
cast to the activation dtype ``cfg.dtype`` where it is used, as the
reference does. Serving holds its weights in that dtype (``init_model``'s
default), so the casts are no-ops and phi4-mini-3.8b holds 7.7 GB of bf16
weights; training holds float32 masters (``dtype=cfg.param_dtype``), and
a bf16 cast of a master equals the serving weight, so both compute the
same forward. Norm scales stay float32.

``forward`` and ``decode_step`` run under ``torch.no_grad``; ``loss_fn``
takes gradients through ``forward_hidden``, each layer rematerialised as
``cfg.remat`` says (``_remat``), the LM head chunked (``head_chunk``).

The moe, ssm and hybrid families and the vision/audio front ends are
ROADMAP item 12.3 and raise; so does Nyström-RLS attention (item 12.4).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch import Tensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..core.precision import to_dtype
from ..device import resolve_device
from .attention import (DecodeState, KVCache, attention_block, check_exact,
                        decode_attention_block, init_attention,
                        init_kv_cache)
from .layers import (embed, init_embedding, init_mlp, init_rmsnorm, mlp,
                     rmsnorm, unembed)


def check_supported(cfg: ModelConfig) -> None:
    """Refuse what the port does not run yet, naming its ROADMAP item."""
    if cfg.family != "dense" or cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / modality {cfg.modality!r} "
            "is not ported; the port runs the dense text family (the moe, "
            "ssm and hybrid families and the vision/audio front ends are "
            "ROADMAP item 12.3)")
    check_exact(cfg)


# --------------------------------------------------------------------- init

def _init_dense_layer(generator: torch.Generator, cfg: ModelConfig,
                      dt: torch.dtype) -> dict:
    dev = generator.device
    p = {
        "attn": init_attention(generator, cfg, dt),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dt),
        "ln1": init_rmsnorm(cfg.d_model, dev),
        "ln2": init_rmsnorm(cfg.d_model, dev),
    }
    if cfg.post_norms:
        p["ln1_post"] = init_rmsnorm(cfg.d_model, dev)
        p["ln2_post"] = init_rmsnorm(cfg.d_model, dev)
    return p


def init_model(cfg: ModelConfig, generator: torch.Generator | None = None, *,
               device="cuda", dtype=None) -> dict:
    """Random weights with the reference's initialisers (truncated normal
    at ±3σ, the same standard deviations), drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; default: seed 0) in float32 one
    tensor at a time and cast to ``dtype``: ``cfg.dtype`` by default (for
    serving), ``cfg.param_dtype`` for training's masters. torch's streams
    are not JAX's: for the reference's own weights use
    ``params_from_reference``."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    dt = cfg.act_dtype if dtype is None else to_dtype(dtype)
    params: dict = {
        "embed": init_embedding(generator, cfg.padded_vocab, cfg.d_model, dt),
        "ln_f": init_rmsnorm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(generator, cfg.padded_vocab,
                                           cfg.d_model, dt)
    params["layers"] = [_init_dense_layer(generator, cfg, dt)
                        for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------- forward

def _dense_block(cfg: ModelConfig, p: dict, h: Tensor, positions: Tensor,
                 window: int) -> Tensor:
    a = attention_block(p["attn"], cfg, rmsnorm(p["ln1"], h, cfg.norm_eps),
                        positions, window=window)
    if cfg.post_norms:
        a = rmsnorm(p["ln1_post"], a, cfg.norm_eps)
    h = h + a
    f = mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps),
            activation=cfg.activation)
    if cfg.post_norms:
        f = rmsnorm(p["ln2_post"], f, cfg.norm_eps)
    return h + f


def _layer_windows(cfg: ModelConfig, n: int) -> list[int]:
    """Per-layer sliding window (0 = global). gemma2: even layers local."""
    if cfg.alt_local and cfg.local_window > 0:
        return [cfg.local_window if i % 2 == 0 else 0 for i in range(n)]
    return [cfg.local_window] * n


def _embed_tokens(params: dict, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    h = embed(params["embed"], tokens, cfg.act_dtype)
    # the scale is cast to the activation dtype first, as the reference
    # does: √3072 = 55.43 becomes 55.5 in bfloat16
    return h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)


def _head(params: dict, cfg: ModelConfig, h: Tensor) -> Tensor:
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed(table, h, softcap=cfg.final_softcap)


class ForwardOut(NamedTuple):
    logits: Tensor       # (b, s, vocab_padded) float32
    aux_loss: Tensor


class HiddenOut(NamedTuple):
    h: Tensor            # (b, s, d) — post-final-norm hidden states
    aux_loss: Tensor


def _save_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``dots`` remat: keep the outputs of the unbatched matrix products
    (the projections and the MLP, ``aten.mm``), as the reference's
    ``dots_with_no_batch_dims_saveable`` keeps its unbatched dot_generals;
    recompute the rest (the norms, RoPE, attention, the activations)."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat`` (none | dots | full) when gradients are
    being recorded: ``full`` keeps only its inputs and runs it again in the
    backward, ``dots`` keeps the matrix products' outputs too
    (``_save_matmuls``). The reference wraps its scan body the same way."""
    if cfg.remat not in ("none", "dots", "full"):
        raise ValueError(f"remat must be none, dots or full, not "
                         f"{cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def forward_hidden(params: dict, cfg: ModelConfig, tokens: Tensor,
                   positions: Tensor | None = None) -> HiddenOut:
    """Backbone only (no LM head). tokens: (b, s) integers on the
    parameters' device. Records gradients when grad mode is on (the loss
    path), each layer under ``cfg.remat``."""
    check_supported(cfg)
    h = _embed_tokens(params, cfg, tokens)
    b, s, _ = h.shape
    if positions is None:
        positions = torch.arange(s, device=h.device).expand(b, s)
    windows = _layer_windows(cfg, len(params["layers"]))
    block = _remat(cfg, _dense_block)
    for p, win in zip(params["layers"], windows):
        h = block(cfg, p, h, positions, win)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return HiddenOut(rmsnorm(params["ln_f"], h, cfg.norm_eps), aux)


@torch.no_grad()
def forward(params: dict, cfg: ModelConfig, tokens: Tensor,
            positions: Tensor | None = None) -> ForwardOut:
    """Prefill forward: tokens (b, s) → float32 logits (b, s, padded_vocab).
    With ``cfg.use_pallas`` every layer's attention is one K4 launch on
    CUDA tensors."""
    h, aux = forward_hidden(params, cfg, tokens, positions)
    return ForwardOut(_head(params, cfg, h), aux)


# ------------------------------------------------------------------- loss

def _ce_chunk(cfg: ModelConfig, params: dict, h_c: Tensor,
              labels_c: Tensor) -> Tensor:
    """Summed cross-entropy over one token chunk; its logits never leave
    the chunk. The target logit is taken with ``gather``, which equals the
    reference's masked sum over the vocabulary exactly (that sum adds only
    zeros besides the target)."""
    logits = _head(params, cfg, h_c)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels_c.long()[:, None])[:, 0]
    return torch.sum(lse - tgt)


def loss_fn(params: dict, cfg: ModelConfig, tokens: Tensor, labels: Tensor,
            aux_weight: float = 0.01, head_chunk: int = 16_384) -> Tensor:
    """Next-token cross-entropy (mean over tokens) with a sequence-chunked
    LM head: the (tokens × vocab) float32 logits are the largest training
    buffer at a 200k vocabulary, so the head runs ``head_chunk`` tokens at
    a time (one chunk when the token count is not a multiple), each chunk
    rematerialised in the backward. tokens, labels: (b, s) integers."""
    hid = forward_hidden(params, cfg, tokens)
    h = hid.h
    b, s, d = h.shape
    t = b * s
    h2 = h.reshape(t, d)
    lab = labels.reshape(t)
    c = min(head_chunk, t)
    if t % c:
        c = t  # odd sizes: single chunk
    if c == t:
        total = _ce_chunk(cfg, params, h2, lab)
    else:
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for lo in range(0, t, c):
            total = total + checkpoint(_ce_chunk, cfg, params, h2[lo:lo + c],
                                       lab[lo:lo + c], use_reentrant=False)
    return total / t + aux_weight * hid.aux_loss


# ------------------------------------------------------------------ decode

class DecodeCaches(NamedTuple):
    kv: KVCache      # stacked (L, b, hkv, S_max, dh) caches
    length: int      # global write pointer
    start: Tensor    # (b,) int32 — per-slot visibility start


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      prefill_len: int = 0, *, device="cuda") -> DecodeCaches:
    check_supported(cfg)
    dev = resolve_device(device)
    kv = init_kv_cache(cfg, cfg.n_layers, batch, max_len, device=dev)
    return DecodeCaches(kv, int(prefill_len),
                        torch.zeros((batch,), dtype=torch.int32, device=dev))


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, tokens: Tensor,
                state: DecodeCaches) -> tuple[Tensor, DecodeCaches]:
    """One serving step: tokens (b, 1) → float32 logits (b, 1, vocab) and
    the next state. The caches are updated in place: the returned state
    shares ``state``'s tensors, with the write pointer one further."""
    check_supported(cfg)
    if state.length >= state.kv.k.shape[3]:
        raise ValueError(f"the KV cache is full ({state.length} tokens)")
    h = _embed_tokens(params, cfg, tokens)
    windows = _layer_windows(cfg, len(params["layers"]))
    for i, (p, win) in enumerate(zip(params["layers"], windows)):
        st = DecodeState(KVCache(state.kv.k[i], state.kv.v[i]), state.length,
                         state.start)
        h = _decode_dense_block(cfg, p, h, st, win)
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    return _head(params, cfg, h), state._replace(length=state.length + 1)


def _decode_dense_block(cfg: ModelConfig, p: dict, h: Tensor,
                        st: DecodeState, window: int) -> Tensor:
    a, _ = decode_attention_block(
        p["attn"], cfg, rmsnorm(p["ln1"], h, cfg.norm_eps), st,
        window=window)
    if cfg.post_norms:
        a = rmsnorm(p["ln1_post"], a, cfg.norm_eps)
    h = h + a
    f = mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps),
            activation=cfg.activation)
    if cfg.post_norms:
        f = rmsnorm(p["ln2_post"], f, cfg.norm_eps)
    return h + f
