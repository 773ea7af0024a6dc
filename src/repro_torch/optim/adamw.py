"""AdamW + cosine schedule + global-norm clipping, the port of
``optim/adamw.py``.

The state mirrors the parameters (m and v, trees of the same structure)
plus a step counter, a 0-d int32 tensor on the CPU, so the schedule's
float32 arithmetic runs on the host and the device never waits for it.
Where the reference builds new trees, the port updates in place: clipping
scales the gradients it is given, and ``adamw_update`` writes the
parameters, m and v over themselves with ``torch._foreach_*`` over flat
lists, a group of at most ``GROUP_BYTES`` at a time (a larger tensor is a
group of its own). At phi4-mini-3.8b a new tree would be a second 15.4 GB
copy; the update's transients are two tensors the size of its group. The
arithmetic is the reference's, term for term, but that a·x + y may round
once where the reference rounds a·x first (``alpha=``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch import Tensor
from torch.utils._pytree import tree_leaves, tree_map

# the bytes of parameters one group of the foreach update covers
GROUP_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: Tensor     # 0-d int32 on the CPU
    m: Any
    v: Any


def init_adamw(params: Any) -> AdamWState:
    return AdamWState(torch.zeros((), dtype=torch.int32),
                      tree_map(torch.zeros_like, params),
                      tree_map(torch.zeros_like, params))


def schedule(cfg: AdamWConfig, step) -> Tensor:
    """Linear warmup to ``lr``, then a cosine decay to ``min_lr_frac·lr``
    at ``total_steps``; float32 arithmetic on the step, as the reference's,
    on the CPU."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) \
        * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> Tensor:
    """‖all leaves‖₂ in float32, on the leaves' device."""
    norms = torch._foreach_norm(tree_leaves(tree), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, Tensor]:
    """Scales ``grads`` in place by min(1, max_norm / ‖grads‖) and returns
    them with the norm before scaling."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    leaves = tree_leaves(grads)
    for dt in {g.dtype for g in leaves}:
        torch._foreach_mul_([g for g in leaves if g.dtype == dt],
                            scale.to(dt))
    return grads, norm


def _groups(*lists: list[Tensor]):
    """Aligned slices of ``lists`` covering at most ``GROUP_BYTES`` of the
    first list each (a larger tensor alone)."""
    lo, size = 0, 0
    first = lists[0]
    for i, t in enumerate(first):
        nbytes = t.numel() * t.element_size()
        if i > lo and size + nbytes > GROUP_BYTES:
            yield tuple(x[lo:i] for x in lists)
            lo, size = i, 0
        size += nbytes
    if lo < len(first):
        yield tuple(x[lo:] for x in lists)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, state: AdamWState,
                 params: Any) -> tuple[Any, AdamWState, dict]:
    """One AdamW step, in place: ``grads`` are clipped, and ``params``,
    ``state.m`` and ``state.v`` are overwritten; returns them with the new
    step and the metrics (``lr`` on the CPU, ``grad_norm`` on the
    device)."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    # float32 scalars as the reference's; exact as Python floats
    bc1 = float(1.0 - b1 ** sf)
    bc2 = float(1.0 - b2 ** sf)
    lr_f = float(lr)
    for p, g, m, v in _groups(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
        g = [x.float() for x in g]
        torch._foreach_mul_(m, b1)                    # m2 = b1·m + (1−b1)·g
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)                    # v2 = b2·v + (1−b2)·g·g
        torch._foreach_addcmul_(v, g, g, 1 - b2)
        del g
        denom = torch._foreach_div(v, bc2)            # √(v2/bc2) + eps
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        delta = torch._foreach_div(m, bc1)            # (m2/bc1)/denom + wd·p
        torch._foreach_div_(delta, denom)
        del denom
        torch._foreach_add_(delta, [x.float() for x in p],
                            alpha=cfg.weight_decay)
        torch._foreach_mul_(delta, lr_f)              # p − lr·delta
        torch._foreach_sub_(p, [d.to(x.dtype) for d, x in zip(delta, p)])
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, AdamWState(step, state.m, state.v), metrics
