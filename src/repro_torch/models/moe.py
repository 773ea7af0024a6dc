"""Mixture-of-Experts FFN with capacity-based dispatch, the port of
``models/moe.py``.

GShard-style, as the reference:

  1. router logits in the activation dtype → float32 softmax → top-k
     experts a token and their gate weights, normalised in float32;
  2. each assignment's slot in its expert: the exclusive cumsum over the
     flat (token, rank) one-hot, in the reference's order; assignments
     past ``capacity`` are dropped (the GShard drop rule);
  3. the kept tokens written into an (experts, groups·capacity, d) buffer;
  4. one grouped GEMM per expert stack (``torch.bmm``: the reference leaves
     these products to XLA, not to a Pallas kernel);
  5. each token's k expert outputs, times their gates, summed in rank
     order; the shared experts run dense.

Dispatch groups: the reference cuts the tokens into G groups, G the data
axes of the active mesh, and 16 when no mesh is active, which is every
single-device run. The port has no mesh (ROADMAP item 9), so G is that
constant: 16 when the token count divides by it, else 1. The capacity of
an expert in a group is ``int(t_g·k/e·capacity_factor + 1)``, so a decode
step of 4 slots (G = 1) has a capacity of 1 at deepseek-moe-16b's 64
experts top-6: of two slots that pick one expert, the later is dropped.

Ties: bf16 router logits often tie, and ``jax.lax.top_k`` puts the lower
expert index first; a stable descending sort does the same (``torch.topk``
promises no order for ties). No step sums with atomics, forward or
backward, so training on the card is bit-reproducible: the kept
assignments have distinct (expert, slot) pairs, so a plain ``index_copy_``
writes them (the dropped ones into one spare row that nothing reads; its
backward is a gather), and the combine adds a token's k outputs in rank
order. Each token's k copies come from an ``expand`` (whose backward is a
sum over the k ranks), not from an ``index_select`` of the token rows,
whose backward would scatter-add with atomics on the card; the combine's
``index_select`` scatters back only onto distinct kept slots, besides the
dropped assignments' exact zeros (their gate is 0).

The Switch auxiliary load-balance loss e·Σ_e frac_e·mean(prob_e) comes
back beside the output (frac from the first arg-max of each token).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ..configs.base import ModelConfig
from .layers import truncated_normal_init

# the reference's dispatch-group count without a mesh (every single-device
# run); the port has no mesh until ROADMAP item 9
DISPATCH_GROUPS = 16


class MoEOut(NamedTuple):
    y: Tensor
    aux_loss: Tensor


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dt: torch.dtype) -> dict:
    m = cfg.moe
    d = cfg.d_model
    e, f = m.n_experts, m.d_ff_expert
    std = d ** -0.5
    p = {
        "router": truncated_normal_init(generator, (d, e), std, dt),
        "w_gate": truncated_normal_init(generator, (e, d, f), std, dt),
        "w_up": truncated_normal_init(generator, (e, d, f), std, dt),
        "w_down": truncated_normal_init(generator, (e, f, d), f ** -0.5, dt),
    }
    if m.d_ff_shared:
        p["shared"] = {
            "w_gate": truncated_normal_init(generator, (d, m.d_ff_shared),
                                            std, dt),
            "w_up": truncated_normal_init(generator, (d, m.d_ff_shared),
                                          std, dt),
            "w_down": truncated_normal_init(generator, (m.d_ff_shared, d),
                                            m.d_ff_shared ** -0.5, dt),
        }
    return p


class Dispatch(NamedTuple):
    """Where each (token, rank) assignment of every group went: its expert,
    its slot (cap − 1 when dropped, as in the reference), whether it was
    kept, and its gate weight (float32, 0 when dropped). (G, t_g·k) each."""
    expert: Tensor
    slot: Tensor
    keep: Tensor
    gate: Tensor


def dispatch(probs: Tensor, k: int, cap: int) -> Dispatch:
    """Group-local top-k dispatch of probs (G, t_g, e), float32."""
    G, t_g, e = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[..., :k], idx[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat = expert.reshape(G, t_g * k)
    # the exclusive cumsum over the (token, rank) one-hot, read at each
    # assignment's expert: its inclusive count less one; summed along the
    # last axis of an (expert, assignment) copy, which the card scans
    # faster than the middle one
    onehot = F.one_hot(flat, e).transpose(1, 2).contiguous()
    count = torch.cumsum(onehot, dim=2, dtype=torch.int32)
    position = count.gather(1, flat[:, None, :])[:, 0] - 1
    keep = position < cap
    return Dispatch(flat, torch.where(keep, position, cap - 1), keep,
                    torch.where(keep, gate.reshape(G, t_g * k), 0.0))


def moe_block(params: dict, cfg: ModelConfig, x: Tensor) -> MoEOut:
    """x: (b, s, d) → (b, s, d). Routed top-k + shared experts."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    G = DISPATCH_GROUPS
    if t % G:
        G = 1
    t_g = t // G
    cap = int(t_g * k / e * m.capacity_factor + 1)
    dt = x.dtype

    xt = x.reshape(t, d)
    logits = (xt @ params["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                       # (t, e)

    # Switch aux loss: e · Σ_e (fraction of tokens to e) · (mean prob of e)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.bincount(top1, minlength=e).float() / t
    aux = e * torch.sum(frac * probs.mean(dim=0))

    disp = dispatch(probs.reshape(G, t_g, e), k, cap)
    # slot r of group g is row g·cap + r of its expert; one more row takes
    # the dropped assignments' writes and is never read
    row = torch.arange(G, device=x.device)[:, None] * cap + disp.slot
    row = torch.where(disp.keep, row, G * cap).reshape(-1)
    buf = torch.zeros((e * (G * cap + 1), d), dtype=dt, device=x.device)
    buf.index_copy_(0, disp.expert.reshape(-1) * (G * cap + 1) + row,
                    xt[:, None].expand(t, k, d).reshape(t * k, d))
    a = buf.view(e, G * cap + 1, d)[:, :G * cap]

    h = F.silu(torch.bmm(a, params["w_gate"].to(dt))) \
        * torch.bmm(a, params["w_up"].to(dt))
    out = torch.bmm(h, params["w_down"].to(dt))                 # (e, G·cap, d)

    # a dropped assignment reads slot cap − 1 of its expert and weighs it 0
    read = (disp.expert * (G * cap)
            + torch.arange(G, device=x.device)[:, None] * cap + disp.slot)
    slot_out = out.reshape(e * G * cap, d).index_select(0, read.reshape(-1)) \
        * disp.gate.reshape(-1, 1).to(dt)                       # (t·k, d)
    slot_out = slot_out.reshape(t, k, d)
    y = slot_out[:, 0]
    for r in range(1, k):
        y = y + slot_out[:, r]

    if "shared" in params:
        sp = params["shared"]
        hs = F.silu(xt @ sp["w_gate"].to(dt)) * (xt @ sp["w_up"].to(dt))
        y = y + hs @ sp["w_down"].to(dt)
    return MoEOut(y.reshape(b, s, d), aux)
