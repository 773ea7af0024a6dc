"""Shared transformer building blocks, the port of ``models/layers.py``.

Parameters are plain dicts of tensors, as the reference keeps them; every
block is an ``init_*`` plus a pure function. Each weight is cast to the
activation dtype where it is used, as the reference does: serving holds
its weights in that dtype already (the cast is then a no-op), training
holds float32 masters (see ``transformer``). Norm scales stay float32, as
the reference adds them in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor


def truncated_normal_init(generator: torch.Generator, shape: tuple[int, ...],
                          std: float, dtype: torch.dtype = torch.float32,
                          ) -> Tensor:
    """std · N(0, 1) truncated to ±3σ, drawn in float32 on the generator's
    device and cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return t.mul_(std).to(dtype)


# ----------------------------------------------------------------- RMSNorm

def init_rmsnorm(d: int, device) -> dict:
    """Scale stored as an offset: the norm multiplies by (1 + scale)."""
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + params["scale"])).to(dt)


# ------------------------------------------------------------------- RoPE

def rope_frequencies(head_dim: int, rotary_frac: float, theta: float,
                     positions: Tensor) -> tuple[Tensor, Tensor]:
    """cos/sin tables for (possibly partial) rotary embedding.

    positions: (..., s) integers → cos, sin: (..., s, rot_dim/2) float32.
    """
    rot_dim = int(head_dim * rotary_frac) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    inv_freq = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (b, s, h, dh); cos/sin: (b, s, r/2) or (s, r/2). Only the first r
    dims rotate, as interleaved pairs (x[..., 0::2], x[..., 1::2]); the
    products promote to float32 before the cast back."""
    r = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :r], x[..., r:]
    x1 = x_rot[..., 0::2]
    x2 = x_rot[..., 1::2]
    if cos.ndim == 2:  # (s, r/2) -> broadcast over batch
        c = cos[None, :, None, :]
        s = sin[None, :, None, :]
    else:              # (b, s, r/2)
        c = cos[:, :, None, :]
        s = sin[:, :, None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------- MLP/GLU

def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> dict:
    """The gated MLP, the only kind the assigned architectures use."""
    return {
        "w_up": truncated_normal_init(generator, (d_model, d_ff),
                                      d_model ** -0.5, dtype),
        "w_down": truncated_normal_init(generator, (d_ff, d_model),
                                        d_ff ** -0.5, dtype),
        "w_gate": truncated_normal_init(generator, (d_model, d_ff),
                                        d_model ** -0.5, dtype),
    }


# the reference's jax.nn.gelu defaults to the tanh approximation, so its
# "gelu" and "gelu_tanh" are one function
ACTIVATIONS = {"silu": F.silu,
               "gelu": lambda a: F.gelu(a, approximate="tanh"),
               "gelu_tanh": lambda a: F.gelu(a, approximate="tanh")}


def mlp(params: dict, x: Tensor, *, activation: str = "silu") -> Tensor:
    act = ACTIVATIONS[activation]
    w = {k: params[k].to(x.dtype) for k in ("w_gate", "w_up", "w_down")}
    up = act(x @ w["w_gate"]) * (x @ w["w_up"])
    return up @ w["w_down"]


# -------------------------------------------------------------- embeddings

def init_embedding(generator: torch.Generator, vocab_padded: int,
                   d_model: int, dtype: torch.dtype) -> dict:
    return {"table": truncated_normal_init(generator, (vocab_padded, d_model),
                                           d_model ** -0.5, dtype)}


def embed(params: dict, tokens: Tensor, dtype: torch.dtype) -> Tensor:
    """The rows of ``tokens`` in ``dtype``. The reference casts the whole
    table and then gathers; gathering first gives the same values without
    a cast copy of the table, and its gradient sums repeated tokens in the
    table's dtype rather than in ``dtype``."""
    return params["table"][tokens.long()].to(dtype)


def unembed(params: dict, x: Tensor, *, softcap: float = 0.0) -> Tensor:
    """Logits x·tableᵀ in x's dtype, then float32 (and the softcap)."""
    return softcap_logits((x @ params["table"].to(x.dtype).T).float(),
                          softcap)


def softcap_logits(logits: Tensor, cap: float) -> Tensor:
    return cap * torch.tanh(logits / cap) if cap > 0 else logits
