"""Gradient compression with error feedback (int8 quantization), the port
of ``optim/compression.py``.

Per tensor: scale = max|g + e| / 127, q = round((g + e) / scale) clipped
to ±127 as int8 (``torch.round`` rounds half to even, as ``jnp.round``
does), and the quantization error g + e − q·scale carries into the next
step. Without a data-parallel all-reduce (item 9) the int8 round trip is
what the step sees.

The reference stacks each layer weight over the layers, so its "tensor"
under ``layers`` is one name across every layer; the port keeps a list of
layer dicts, so the leaves at ``["layers"][i]<path>`` share one scale over
i, and the port computes the reference's function. The tensors are worked
one such group at a time.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils._pytree import (MappingKey, SequenceKey, keystr,
                                 tree_flatten_with_path, tree_leaves,
                                 tree_map, tree_unflatten)


class CompressionState(NamedTuple):
    error: Any   # residual tree (float32)


def init_compression(params: Any) -> CompressionState:
    return CompressionState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _scale_groups(paths) -> dict[str, list[int]]:
    """Leaf indices by the tensor whose scale they share: a leaf's own
    path, less the layer index under "layers"."""
    groups: dict[str, list[int]] = {}
    for i, path in enumerate(paths):
        if len(path) > 1 and path[0] == MappingKey("layers") \
                and isinstance(path[1], SequenceKey):
            path = path[:1] + path[2:]
        groups.setdefault(keystr(path), []).append(i)
    return groups


@torch.no_grad()
def compress(grads: Any, state: CompressionState
             ) -> tuple[Any, Any, CompressionState]:
    """Returns (q_int8, scales, new_state). q ≈ (g + error)/scale."""
    flat, spec = tree_flatten_with_path(grads)
    errors = tree_leaves(state.error)
    qs, scales, new_e = [None] * len(flat), [None] * len(flat), \
        [None] * len(flat)
    for members in _scale_groups([p for p, _ in flat]).values():
        corrected = {i: flat[i][1].float() + errors[i] for i in members}
        amax = torch.stack([c.abs().max() for c in corrected.values()]).max()
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        for i, c in corrected.items():
            q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
            qs[i], scales[i], new_e[i] = q, scale, c.sub_(q.float() * scale)
    return (tree_unflatten(qs, spec), tree_unflatten(scales, spec),
            CompressionState(tree_unflatten(new_e, spec)))


def decompress(qs: Any, scales: Any) -> Any:
    return tree_map(lambda q, s: q.float() * s, qs, scales)


def compressed_grads(grads: Any, state: CompressionState
                     ) -> tuple[Any, CompressionState]:
    """grads → int8-round-tripped grads + updated error feedback."""
    q, s, new_state = compress(grads, state)
    return decompress(q, s), new_state
