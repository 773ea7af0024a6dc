"""Config-driven decoder-only LM: the port of ``models/transformer.py``.

Families:
  dense / vlm / audio — [attention + gated MLP] × L, with optional post-norms
                        and gemma2's alternating local windows (even layers
                        local)
  moe                 — [attention + (shared + routed) MoE] × L, layer 0
                        optionally dense (deepseek's ``first_dense_ff``)
  ssm                 — [Mamba2 SSD] × L
  hybrid (zamba2)     — groups of ``shared_attn_every`` Mamba2 layers, each
                        followed by one shared attention + MLP block (the
                        same weights at every use, a KV cache for each
                        use), then the tail layers

Entry points:
  init_model(cfg, generator, device=, dtype=)    → params
  forward(params, cfg, tokens | embeds)          → ForwardOut(logits, aux)
  loss_fn(params, cfg, tokens, labels[, embeds]) → scalar CE (training)
  init_decode_state(cfg, batch, max_len)         → DecodeCaches
  decode_step(params, cfg, tokens, state[, embeds]) → logits, new state

Parameters are plain dicts of tensors, with a Python list of per-layer
dicts under "layers" (the reference stacks them on a leading axis for
``lax.scan``; ``convert.params_from_reference`` unstacks); deepseek's dense
first layer is "layer0", zamba2's shared block "shared_attn", musicgen's
codebook head "cb_head" (d, codebooks, vocab). Every weight is cast to the
activation dtype ``cfg.dtype`` where it is used, as the reference does.
Serving holds its weights in that dtype (``init_model``'s default), so the
casts are no-ops and phi4-mini-3.8b holds 7.7 GB of bf16 weights; training
holds float32 masters (``dtype=cfg.param_dtype``), and a bf16 cast of a
master equals the serving weight, so both compute the same forward. Norm
scales and the SSM's float32 parameters (``ssm.init_ssm``) stay float32.

The vision and audio configs take embeddings (b, s, d) in place of tokens:
their front ends are stubs in the reference too. Token embeddings are
scaled by √d_model in the dense, vlm and audio families only, as the
reference does.

``forward`` and ``decode_step`` run under ``torch.no_grad``; ``loss_fn``
takes gradients through ``forward_hidden`` in every family, rematerialised
as ``cfg.remat`` says (``_remat``) where the reference's scans are: each
dense and MoE layer (not deepseek's ``layer0``), each SSM layer, each
hybrid group of ``shared_attn_every`` SSM layers with its shared block
(not the tail); the LM head (or the codebook head) chunked
(``head_chunk``).

``cfg.attn_approx="nystrom_rls"`` runs the paper's landmark attention in
every attention layer (``attention.attention_block``) and its RLS decode:
``init_decode_state`` freezes strided landmark positions over the cache
for the dense, vlm, audio and moe families (``DecodeCaches.lm``), so their
steps read p + ``rls_keep_recent`` entries; the hybrid's shared block has
none and scores its whole cache at every step, as the reference does.
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
from .attention import (DecodeState, KVCache, attention_block,
                        decode_attention_block, init_attention,
                        init_kv_cache)
from .layers import (embed, init_embedding, init_mlp, init_rmsnorm, mlp,
                     rmsnorm, softcap_logits, unembed)
from .moe import init_moe, moe_block
from .ssm import (SSMState, init_ssm, init_ssm_state, ssm_block,
                  ssm_decode_step)

FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a family that the model does not know."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


# --------------------------------------------------------------------- init

def _init_dense_layer(generator: torch.Generator, cfg: ModelConfig,
                      dt: torch.dtype, d_ff: int | None = None) -> dict:
    dev = generator.device
    p = {
        "attn": init_attention(generator, cfg, dt),
        "mlp": init_mlp(generator, cfg.d_model,
                        cfg.d_ff if d_ff is None else d_ff, dt),
        "ln1": init_rmsnorm(cfg.d_model, dev),
        "ln2": init_rmsnorm(cfg.d_model, dev),
    }
    if cfg.post_norms:
        p["ln1_post"] = init_rmsnorm(cfg.d_model, dev)
        p["ln2_post"] = init_rmsnorm(cfg.d_model, dev)
    return p


def _init_moe_layer(generator: torch.Generator, cfg: ModelConfig,
                    dt: torch.dtype) -> dict:
    dev = generator.device
    return {"attn": init_attention(generator, cfg, dt),
            "moe": init_moe(generator, cfg, dt),
            "ln1": init_rmsnorm(cfg.d_model, dev),
            "ln2": init_rmsnorm(cfg.d_model, dev)}


def _init_ssm_layer(generator: torch.Generator, cfg: ModelConfig,
                    dt: torch.dtype) -> dict:
    return {"ssm": init_ssm(generator, cfg, dt),
            "ln": init_rmsnorm(cfg.d_model, generator.device)}


def init_model(cfg: ModelConfig, generator: torch.Generator | None = None, *,
               device="cuda", dtype=None) -> dict:
    """Random weights with the reference's initialisers (truncated normal
    at ±3σ, the same standard deviations; the codebook head a plain
    normal), drawn from ``generator`` (a ``torch.Generator`` on ``device``;
    default: seed 0) in float32 one tensor at a time and cast to
    ``dtype``: ``cfg.dtype`` by default (for serving), ``cfg.param_dtype``
    for training's masters. torch's streams are not JAX's: for the
    reference's own weights use ``params_from_reference``."""
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
    if _codebooks(cfg):
        head = torch.randn((cfg.d_model, cfg.num_codebooks, cfg.padded_vocab),
                           generator=generator, device=dev)
        params["cb_head"] = head.mul_(cfg.d_model ** -0.5).to(dt)

    fam = cfg.family
    if fam in ("dense", "vlm", "audio"):
        params["layers"] = [_init_dense_layer(generator, cfg, dt)
                            for _ in range(cfg.n_layers)]
    elif fam == "moe":
        first = cfg.moe.first_dense_ff
        params["layers"] = [_init_moe_layer(generator, cfg, dt)
                            for _ in range(cfg.n_layers - (1 if first else 0))]
        if first:
            params["layer0"] = _init_dense_layer(generator, cfg, dt, first)
    else:   # ssm, hybrid
        params["layers"] = [_init_ssm_layer(generator, cfg, dt)
                            for _ in range(cfg.n_layers)]
        if fam == "hybrid":
            params["shared_attn"] = {
                "attn": init_attention(generator, cfg, dt),
                "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dt),
                "ln1": init_rmsnorm(cfg.d_model, dev),
                "ln2": init_rmsnorm(cfg.d_model, dev),
            }
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
    if cfg.family not in ("dense", "vlm", "audio"):
        return h
    # the scale is cast to the activation dtype first, as the reference
    # does: √3072 = 55.43 becomes 55.5 in bfloat16
    return h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)


def _inputs(params: dict, cfg: ModelConfig, tokens: Tensor | None,
            embeds: Tensor | None) -> Tensor:
    """The first hidden states: token embeddings, or ``embeds`` (the
    vision / audio front ends' output) in the activation dtype."""
    if embeds is None:
        return _embed_tokens(params, cfg, tokens)
    return embeds.to(cfg.act_dtype)


def _codebooks(cfg: ModelConfig) -> bool:
    return cfg.modality == "audio" and cfg.num_codebooks > 1


def _head(params: dict, cfg: ModelConfig, h: Tensor) -> Tensor:
    """float32 logits (..., vocab), or (..., codebooks, vocab) through the
    codebook head."""
    if _codebooks(cfg):
        w = params["cb_head"].to(h.dtype)
        d, cb, v = w.shape
        logits = (h @ w.reshape(d, cb * v)).reshape(*h.shape[:-1], cb, v)
        return softcap_logits(logits.float(), cfg.final_softcap)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed(table, h, softcap=cfg.final_softcap)


class ForwardOut(NamedTuple):
    logits: Tensor       # (b, s, vocab_padded) or (b, s, cb, vocab_padded)
    aux_loss: Tensor     # float32; the MoE families' summed Switch loss


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


def _hybrid_groups(cfg: ModelConfig) -> tuple[int, int, int]:
    """n_layers = n_groups·every + tail; the shared block after each
    group."""
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    return n_groups, every, cfg.n_layers - n_groups * every


def _ssm_layer(cfg: ModelConfig, p: dict, h: Tensor) -> Tensor:
    return h + ssm_block(p["ssm"], cfg, rmsnorm(p["ln"], h, cfg.norm_eps))


def _moe_layer(cfg: ModelConfig, p: dict, h: Tensor,
               positions: Tensor) -> tuple[Tensor, Tensor]:
    """One MoE layer: (h, its Switch aux loss)."""
    h = h + attention_block(p["attn"], cfg,
                            rmsnorm(p["ln1"], h, cfg.norm_eps), positions)
    out = moe_block(p["moe"], cfg, rmsnorm(p["ln2"], h, cfg.norm_eps))
    return h + out.y, out.aux_loss


def _hybrid_group(cfg: ModelConfig, layers: list[dict], shared: dict,
                  h: Tensor, positions: Tensor) -> Tensor:
    """A hybrid group: its SSM layers, then the shared block."""
    for p in layers:
        h = _ssm_layer(cfg, p, h)
    return _dense_block(cfg, shared, h, positions, 0)


def forward_hidden(params: dict, cfg: ModelConfig, tokens: Tensor | None = None,
                   embeds: Tensor | None = None,
                   positions: Tensor | None = None) -> HiddenOut:
    """Backbone only (no LM head). tokens: (b, s) integers, or embeds
    (b, s, d), on the parameters' device. Records gradients when grad mode
    is on (the loss path), each layer under ``cfg.remat``."""
    check_supported(cfg)
    h = _inputs(params, cfg, tokens, embeds)
    b, s, _ = h.shape
    if positions is None:
        positions = torch.arange(s, device=h.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    fam = cfg.family
    if fam in ("dense", "vlm", "audio"):
        windows = _layer_windows(cfg, len(params["layers"]))
        block = _remat(cfg, _dense_block)
        for p, win in zip(params["layers"], windows):
            h = block(cfg, p, h, positions, win)
    elif fam == "moe":
        if "layer0" in params:
            h = _dense_block(cfg, params["layer0"], h, positions, 0)
        block = _remat(cfg, _moe_layer)
        for p in params["layers"]:
            h, aux_l = block(cfg, p, h, positions)
            aux = aux + aux_l
    elif fam == "ssm":
        block = _remat(cfg, _ssm_layer)
        for p in params["layers"]:
            h = block(cfg, p, h)
    else:   # hybrid
        n_groups, every, _ = _hybrid_groups(cfg)
        layers = params["layers"]
        block = _remat(cfg, _hybrid_group)
        for g in range(n_groups):
            h = block(cfg, layers[g * every:(g + 1) * every],
                      params["shared_attn"], h, positions)
        for p in layers[n_groups * every:]:
            h = _ssm_layer(cfg, p, h)
    return HiddenOut(rmsnorm(params["ln_f"], h, cfg.norm_eps), aux)


@torch.no_grad()
def forward(params: dict, cfg: ModelConfig, tokens: Tensor | None = None,
            embeds: Tensor | None = None,
            positions: Tensor | None = None) -> ForwardOut:
    """Prefill forward: tokens (b, s) or embeds (b, s, d) → float32 logits
    (b, s, padded_vocab), or (b, s, codebooks, padded_vocab) through the
    codebook head. With ``cfg.use_pallas`` every attention block is one K4
    launch on CUDA tensors."""
    h, aux = forward_hidden(params, cfg, tokens, embeds, positions)
    return ForwardOut(_head(params, cfg, h), aux)


# ------------------------------------------------------------------- loss

def _ce_chunk(cfg: ModelConfig, params: dict, h_c: Tensor,
              labels_c: Tensor) -> Tensor:
    """Summed cross-entropy over one token chunk; its logits never leave
    the chunk. h_c (c, d); labels_c (c,), or (c, codebooks) through the
    codebook head (softcapped as the LM head is). The target logit is
    taken with ``gather``, which equals the reference's masked sum over
    the vocabulary exactly (that sum adds only zeros besides the
    target)."""
    logits = _head(params, cfg, h_c)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels_c.long()[..., None])[..., 0]
    return torch.sum(lse - tgt)


def loss_fn(params: dict, cfg: ModelConfig, tokens: Tensor | None,
            labels: Tensor, embeds: Tensor | None = None,
            aux_weight: float = 0.01, head_chunk: int = 16_384) -> Tensor:
    """Next-token cross-entropy (mean over tokens, and over codebooks when
    the labels carry them) plus ``aux_weight`` times the MoE families'
    Switch loss, with a sequence-chunked LM head: the (tokens × vocab)
    float32 logits are the largest training buffer at a 200k vocabulary,
    so the head runs ``head_chunk`` tokens at a time (one chunk when the
    token count is not a multiple), each chunk rematerialised in the
    backward. tokens (b, s) integers, or ``embeds`` (b, s, d) for the
    vision / audio configs; labels (b, s), or (b, s, codebooks) for the
    codebook head."""
    hid = forward_hidden(params, cfg, tokens, embeds)
    h = hid.h
    b, s, d = h.shape
    t = b * s
    h2 = h.reshape(t, d)
    lab = labels.reshape((t,) + tuple(labels.shape[2:]))
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
    denom = t * (cfg.num_codebooks if lab.ndim > 1 else 1)
    return total / denom + aux_weight * hid.aux_loss


# ------------------------------------------------------------------ decode

class DecodeCaches(NamedTuple):
    kv: KVCache | None       # stacked (L, b, hkv, S_max, dh) caches
    ssm: SSMState | None     # stacked (L, b, ...) SSM states
    length: int              # global write pointer
    start: Tensor            # (b,) int32 — per-slot visibility start
    lm: Tensor | None = None  # (L, b, hkv, p) int32 frozen RLS landmarks


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      prefill_len: int = 0, *, device="cuda") -> DecodeCaches:
    """Zeroed caches: a KV cache per attention layer (the moe family's
    ``layer0`` at index 0; one per use of the hybrid's shared block) and an
    SSM state per Mamba2 layer. With ``nystrom_rls`` the dense, vlm, audio
    and moe families also get frozen landmarks: p = min(nystrom_landmarks,
    max_len) positions strided by max(max_len // p, 1), the same in every
    layer, slot and head (the reference never refreshes them, ROADMAP R7);
    the hybrid's are None."""
    check_supported(cfg)
    dev = resolve_device(device)
    fam = cfg.family
    kv = ssm = lm = None
    if fam in ("dense", "vlm", "audio", "moe"):
        kv = init_kv_cache(cfg, cfg.n_layers, batch, max_len, device=dev)
        if cfg.attn_approx == "nystrom_rls":
            p = min(cfg.nystrom_landmarks, max_len)
            base = (torch.arange(p, dtype=torch.int32, device=dev)
                    * max(max_len // p, 1)) % max_len
            lm = base.expand(cfg.n_layers, batch, cfg.n_kv_heads,
                             p).contiguous()
    elif fam == "hybrid":
        kv = init_kv_cache(cfg, _hybrid_groups(cfg)[0], batch, max_len,
                           device=dev)
    if fam in ("ssm", "hybrid"):
        ssm = init_ssm_state(cfg, batch, cfg.n_layers, device=dev)
    return DecodeCaches(kv, ssm, int(prefill_len),
                        torch.zeros((batch,), dtype=torch.int32, device=dev),
                        lm)


def _layer_state(state: DecodeCaches, i: int) -> DecodeState:
    return DecodeState(KVCache(state.kv.k[i], state.kv.v[i]), state.length,
                       state.start, None if state.lm is None else state.lm[i])


def _ssm_state(state: DecodeCaches, i: int) -> SSMState:
    return SSMState(state.ssm.conv[i], state.ssm.ssm[i])


def _decode_ssm_layer(cfg: ModelConfig, p: dict, h: Tensor,
                      st: SSMState) -> Tensor:
    out, _ = ssm_decode_step(p["ssm"], cfg, rmsnorm(p["ln"], h, cfg.norm_eps),
                             st)
    return h + out


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, tokens: Tensor | None,
                state: DecodeCaches, embeds: Tensor | None = None,
                ) -> tuple[Tensor, DecodeCaches]:
    """One serving step: tokens (b, 1), or embeds (b, 1, d), → float32
    logits (b, 1, vocab) or (b, 1, codebooks, vocab), and the next state.
    The caches are updated in place: the returned state shares ``state``'s
    tensors, with the write pointer one further."""
    check_supported(cfg)
    if state.kv is not None and state.length >= state.kv.k.shape[3]:
        raise ValueError(f"the KV cache is full ({state.length} tokens)")
    h = _inputs(params, cfg, tokens, embeds)
    fam = cfg.family
    if fam in ("dense", "vlm", "audio"):
        windows = _layer_windows(cfg, len(params["layers"]))
        for i, (p, win) in enumerate(zip(params["layers"], windows)):
            h = _decode_dense_block(cfg, p, h, _layer_state(state, i), win)
    elif fam == "moe":
        off = 0
        if "layer0" in params:
            h = _decode_dense_block(cfg, params["layer0"], h,
                                    _layer_state(state, 0), 0)
            off = 1
        for i, p in enumerate(params["layers"]):
            h = _decode_moe_block(cfg, p, h, _layer_state(state, i + off))
    elif fam == "ssm":
        for i, p in enumerate(params["layers"]):
            h = _decode_ssm_layer(cfg, p, h, _ssm_state(state, i))
    else:   # hybrid
        n_groups, every, _ = _hybrid_groups(cfg)
        for i, p in enumerate(params["layers"]):
            h = _decode_ssm_layer(cfg, p, h, _ssm_state(state, i))
            if i < n_groups * every and (i + 1) % every == 0:
                h = _decode_dense_block(cfg, params["shared_attn"], h,
                                        _layer_state(state, i // every), 0)
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


def _decode_moe_block(cfg: ModelConfig, p: dict, h: Tensor,
                      st: DecodeState) -> Tensor:
    a, _ = decode_attention_block(
        p["attn"], cfg, rmsnorm(p["ln1"], h, cfg.norm_eps), st)
    h = h + a
    out = moe_block(p["moe"], cfg, rmsnorm(p["ln2"], h, cfg.norm_eps))
    return h + out.y
