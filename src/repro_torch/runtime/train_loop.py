"""Train-step factory: loss, gradients and AdamW (+ gradient accumulation
over microbatches, error-feedback int8 gradient compression), the port of
``runtime/train_loop.py``.

The returned step is
    (params, opt_state, comp_state, batch) → TrainStepOut
as the reference's, but it takes ownership of ``params``, ``opt_state`` and
``comp_state``: it updates the parameters, the moments and the compression
residuals in place (``optim.adamw``) and returns the same trees, so a
caller that needs the old values keeps a copy. It leaves the parameters'
``requires_grad`` as it found them. The gradients are local to the step (``torch.autograd.grad``, no
``.grad`` is kept) and are dropped when it returns; a leaf that the loss
does not reach (the token table of a config trained from embeddings) gets
a zero gradient, as ``jax.value_and_grad`` gives it. The batch holds
``tokens`` and ``labels`` (b, s), or, for the vision / audio configs,
``embeds`` (b, s, d) and ``labels`` ((b, s, codebooks) through the
codebook head), as the reference's; every entry moves to the parameters'
device, and microbatching splits each along its first axis.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch import Tensor
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..configs.base import ModelConfig
from ..models import loss_fn
from ..models.transformer import check_supported
from ..optim import (AdamWConfig, AdamWState, adamw_update, compressed_grads,
                     init_adamw, init_compression)


class TrainStepOut(NamedTuple):
    params: Any
    opt_state: AdamWState
    comp_state: Any
    metrics: dict[str, Tensor]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    num_microbatches: int = 1,
                    compress_grads: bool = False) -> Callable:
    """Build the train step. ``num_microbatches > 1`` folds the global batch
    into sequential microbatches (gradient accumulation in float32) —
    memory for throughput."""
    check_supported(cfg)
    embeds = cfg.modality in ("vision", "audio")

    def compute_grads(leaves: list[Tensor], spec, batch: dict
                      ) -> tuple[Tensor, list[Tensor]]:
        # aliases of the caller's tensors that record gradients
        leaves = [p.detach().requires_grad_() for p in leaves]
        params = tree_unflatten(leaves, spec)
        if embeds:
            loss = loss_fn(params, cfg, None, batch["labels"],
                           embeds=batch["embeds"])
        else:
            loss = loss_fn(params, cfg, batch["tokens"], batch["labels"])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def train_step(params: Any, opt_state: AdamWState, comp_state: Any,
                   batch: dict) -> TrainStepOut:
        leaves, spec = tree_flatten(params)
        dev = leaves[0].device
        batch = {k: torch.as_tensor(x).to(dev) for k, x in batch.items()}
        if num_microbatches > 1:
            micro = {k: x.reshape((num_microbatches,
                                   x.shape[0] // num_microbatches)
                                  + x.shape[1:]) for k, x in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in leaves]
            for i in range(num_microbatches):
                loss_i, grads_i = compute_grads(
                    leaves, spec, {k: x[i] for k, x in micro.items()})
                loss = loss + loss_i
                torch._foreach_add_(grads, grads_i)
                del grads_i
            inv = 1.0 / num_microbatches
            loss = loss * inv
            torch._foreach_mul_(grads, inv)
        else:
            loss, grads = compute_grads(leaves, spec, batch)

        grads = tree_unflatten(grads, spec)
        if compress_grads:
            grads, comp_state = compressed_grads(grads, comp_state)

        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params)
        del grads
        metrics = dict(metrics, loss=loss)
        return TrainStepOut(params, opt_state, comp_state, metrics)

    return train_step


def init_train_state(cfg: ModelConfig, params: Any, *,
                     compress_grads: bool = False) -> tuple[AdamWState, Any]:
    opt_state = init_adamw(params)
    comp_state = init_compression(params) if compress_grads else ()
    return opt_state, comp_state
