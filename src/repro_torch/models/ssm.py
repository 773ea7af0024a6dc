"""Mamba2 SSD (state-space duality) block [arXiv:2405.21060], the port of
``models/ssm.py``.

Prefill: the chunked SSD algorithm, a within-chunk quadratic term (like
masked attention) plus a linear recurrence across chunk states (a Python
loop over the chunks, the reference's ``lax.scan``). Decode: the O(1)
recurrent update of the (b, nh, hd, ds) state and a rolling causal-conv
window. Layout (b, s, ...), nh = expand·d_model / head_dim heads, B and C
shared by the nh/g heads of a group.

The dtypes are the reference's, cast for cast: the c × c Gram of C and B,
the decay L and the diagonal term in the activation dtype; the chunk
states, the recurrence and the off-diagonal term in float32; ``D·x``
promoted to float32. ``A_log``, ``D``, ``dt_bias``, ``norm_scale`` and
``conv_b`` are float32 parameters whatever dtype the weights are held in,
as the reference uses them without a cast. The causal convolution adds
its k shifted products in order in the activation dtype, as the
reference's; ``F.conv1d`` would sum in float32 and round otherwise.
Products that the reference writes per head over B and C repeated for
each head of a group run here per group, the heads of a group batched
beside it, which gives the same sums.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ..configs.base import ModelConfig
from .layers import truncated_normal_init


def ssm_dims(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return dict(d_inner=d_inner, nh=nh, conv_dim=conv_dim,
                d_state=s.d_state, head_dim=s.head_dim, groups=s.n_groups,
                conv_kernel=s.conv_kernel, chunk=s.chunk)


def init_ssm(generator: torch.Generator, cfg: ModelConfig,
             dt: torch.dtype) -> dict:
    """The reference's initialisers; the projections and the conv kernel
    in ``dt``, the rest float32."""
    dm = ssm_dims(cfg)
    d = cfg.d_model
    dev = generator.device
    d_in_proj = 2 * dm["d_inner"] + 2 * dm["groups"] * dm["d_state"] + dm["nh"]
    s = cfg.ssm
    in_proj = truncated_normal_init(generator, (d, d_in_proj), d ** -0.5, dt)
    conv_w = truncated_normal_init(generator, (dm["conv_kernel"],
                                               dm["conv_dim"]),
                                   dm["conv_kernel"] ** -0.5, dt)
    u = torch.rand((dm["nh"],), generator=generator, device=dev)
    step = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                     + math.log(s.dt_min))
    dt_bias = step + torch.log(-torch.expm1(-step))     # inverse softplus
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((dm["conv_dim"],), **f32),
        "A_log": torch.log(torch.arange(1, dm["nh"] + 1, **f32)),
        "D": torch.ones((dm["nh"],), **f32),
        "dt_bias": dt_bias,
        "norm_scale": torch.zeros((dm["d_inner"],), **f32),
        "out_proj": truncated_normal_init(generator, (dm["d_inner"], d),
                                          dm["d_inner"] ** -0.5, dt),
    }


def _gated_rmsnorm(x: Tensor, z: Tensor, scale: Tensor, eps: float) -> Tensor:
    dt = x.dtype
    xf = x.float() * F.silu(z.float())
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(dt)


def _split_proj(cfg: ModelConfig, proj: Tensor) -> tuple[Tensor, ...]:
    dm = ssm_dims(cfg)
    gs = dm["groups"] * dm["d_state"]
    z, xbc, dt = torch.split(proj, [dm["d_inner"], dm["conv_dim"], dm["nh"]],
                             dim=-1)
    x, B, C = torch.split(xbc, [dm["d_inner"], gs, gs], dim=-1)
    return z, x, B, C, dt, xbc


def _conv1d(xbc: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Causal depthwise conv over (b, s, c) with kernel (k, c)."""
    k = w.shape[0]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b.to(out.dtype))


def _segsum(dA: Tensor) -> Tensor:
    """exp-decay matrix within a chunk: L[.., t, s] = exp(Σ_{s<r≤t} dA_r),
    lower-triangular. dA: (..., c) → (..., c, c). The upper triangle is
    set to −inf before the ``exp`` (which gives exact zeros there), not
    multiplied by a 0/1 mask: its differences overflow ``exp`` to inf, and
    inf · 0 is NaN."""
    c = dA.shape[-1]
    cum = torch.cumsum(dA, dim=-1)
    L = cum[..., :, None] - cum[..., None, :]
    upper = torch.ones((c, c), dtype=torch.bool, device=dA.device).triu_(1)
    return L.masked_fill_(upper, float("-inf")).exp_()


class SSMState(NamedTuple):
    conv: Tensor   # (..., b, k-1, conv_dim) rolling conv inputs
    ssm: Tensor    # (..., b, nh, head_dim, d_state) float32


def init_ssm_state(cfg: ModelConfig, batch: int, layers: int, *,
                   device="cuda", dtype=None) -> SSMState:
    """Zeroed stacked states (layers, b, ...); layer i's is
    ``SSMState(conv[i], ssm[i])``. The conv window in the activation
    dtype, the recurrent state in float32."""
    dm = ssm_dims(cfg)
    dt = cfg.act_dtype if dtype is None else dtype
    return SSMState(
        torch.zeros((layers, batch, dm["conv_kernel"] - 1, dm["conv_dim"]),
                    dtype=dt, device=device),
        torch.zeros((layers, batch, dm["nh"], dm["head_dim"], dm["d_state"]),
                    dtype=torch.float32, device=device),
    )


def ssm_block(params: dict, cfg: ModelConfig, u: Tensor) -> Tensor:
    """Prefill forward, chunked SSD. u: (b, s, d) → (b, s, d)."""
    dm = ssm_dims(cfg)
    b, s, _ = u.shape
    c = min(dm["chunk"], s)
    if s % c:
        raise ValueError(f"seq {s} must divide chunk {c}")
    nc = s // c
    nh, hd, ds, g = dm["nh"], dm["head_dim"], dm["d_state"], dm["groups"]
    hpg = nh // g                                  # heads per group
    act = u.dtype

    proj = u @ params["in_proj"].to(act)
    z, _, _, _, dt, xbc = _split_proj(cfg, proj)
    xbc = _conv1d(xbc, params["conv_w"].to(act), params["conv_b"])
    x, B, C = torch.split(xbc, [dm["d_inner"], g * ds, g * ds], dim=-1)

    x = x.reshape(b, nc, c, nh, hd)
    B = B.reshape(b, nc, c, g, ds)
    C = C.reshape(b, nc, c, g, ds)

    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())                    # (nh,)
    dA = (dt * A).reshape(b, nc, c, nh)                         # ≤ 0
    x_dt = x * dt.reshape(b, nc, c, nh)[..., None].to(act)

    # ---- intra-chunk: the Gram of C and B and the decay L in the
    # activation dtype, as the reference
    L = _segsum(dA.permute(0, 1, 3, 2))                         # (b,nc,nh,c,c)
    Gm = torch.einsum("bzcgn,bzsgn->bzgcs", C, B)               # (b,nc,g,c,c)
    M = Gm[:, :, :, None] * L.to(act).reshape(b, nc, g, hpg, c, c)
    del L
    Y_diag = torch.matmul(M.reshape(b, nc, nh, c, c),
                          x_dt.permute(0, 1, 3, 2, 4))          # (b,nc,nh,c,hd)
    del M
    Y_diag = Y_diag.permute(0, 1, 3, 2, 4)                      # (b,nc,c,nh,hd)

    # ---- chunk states and the inter-chunk recurrence, float32
    cum = torch.cumsum(dA, dim=2)                               # (b,nc,c,nh)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)
    w = (decay_states[..., None] * x_dt.float()).reshape(b, nc, c, g, hpg, hd)
    states = torch.einsum("bzcgip,bzcgn->bzgipn", w, B.float()).reshape(
        b, nc, nh, hd, ds)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (b, nc, nh)
    prev = torch.empty_like(states)
    carry = torch.zeros_like(states[:, 0])
    for zi in range(nc):
        prev[:, zi] = carry                                     # the state before
        carry = carry * chunk_decay[:, zi, :, None, None] + states[:, zi]

    state_decay = torch.exp(cum).reshape(b, nc, c, g, hpg, 1)
    Y_off = torch.einsum("bzcgn,bzgipn->bzcgip", C.float(),
                         prev.reshape(b, nc, g, hpg, hd, ds)) * state_decay

    y = (Y_diag.float() + Y_off.reshape(b, nc, c, nh, hd)).reshape(
        b, s, nh, hd)
    y = y + params["D"][None, None, :, None] * x.reshape(b, s, nh, hd)
    y = y.reshape(b, s, dm["d_inner"]).to(act)
    y = _gated_rmsnorm(y, z, params["norm_scale"], cfg.norm_eps)
    return y @ params["out_proj"].to(act)


def ssm_decode_step(params: dict, cfg: ModelConfig, u: Tensor,
                    state: SSMState) -> tuple[Tensor, SSMState]:
    """One-token recurrent step. u: (b, 1, d). The conv window and the
    recurrent state are updated in place: the returned state shares
    ``state``'s tensors."""
    dm = ssm_dims(cfg)
    b = u.shape[0]
    nh, hd, ds, g = dm["nh"], dm["head_dim"], dm["d_state"], dm["groups"]
    act = u.dtype

    proj = u[:, 0] @ params["in_proj"].to(act)                  # (b, dproj)
    z, _, _, _, dt, xbc = _split_proj(cfg, proj[:, None, :])
    # the rolling conv window: the stored inputs, then this one
    win = torch.cat([state.conv.to(act), xbc], dim=1)           # (b, k, cdim)
    w = params["conv_w"].to(act)
    conv_out = F.silu((torch.einsum("bkc,kc->bc", win.float(), w.float())
                       .to(act)) + params["conv_b"].to(act))
    x, B, C = torch.split(conv_out, [dm["d_inner"], g * ds, g * ds], dim=-1)
    x = x.reshape(b, nh, hd)
    B = B.reshape(b, g, ds).repeat_interleave(nh // g, dim=1)   # (b, nh, ds)
    C = C.reshape(b, g, ds).repeat_interleave(nh // g, dim=1)

    step = F.softplus(dt[:, 0].float() + params["dt_bias"])     # (b, nh)
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(step * A)                                 # (b, nh)
    xf = x.float()
    new_ssm = (state.ssm * decay[:, :, None, None]
               + (step[:, :, None] * xf)[..., None] * B.float()[:, :, None])
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, C.float())
    y = y + params["D"][None, :, None] * xf
    y = y.reshape(b, 1, dm["d_inner"]).to(act)
    y = _gated_rmsnorm(y, z, params["norm_scale"], cfg.norm_eps)
    out = y @ params["out_proj"].to(act)
    state.conv.copy_(win[:, 1:])
    state.ssm.copy_(new_ssm)
    return out, state
