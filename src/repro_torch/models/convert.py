"""Carry the reference's parameters into the port.

``params_from_reference`` takes the JAX package's parameter tree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``), whose
"layers" leaves are stacked on a leading (L, …) axis, and returns the
port's parameters: the same names, one dict per layer, weights in
``dtype`` (``cfg.dtype`` by default, for serving; ``cfg.param_dtype`` for
training) and norm scales in float32 (see ``transformer``). The tests use
it so that both packages compute with the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.precision import to_dtype
from ..device import resolve_device
from .transformer import check_supported


def params_from_reference(params_np: dict, cfg: ModelConfig,
                          device="cuda", dtype=None) -> dict:
    check_supported(cfg)
    dev = resolve_device(device)
    weights = cfg.act_dtype if dtype is None else to_dtype(dtype)

    def leaf(name: str, a) -> torch.Tensor:
        dt = torch.float32 if name == "scale" else weights
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dt)

    def tree(d: dict, i: int | None = None) -> dict:
        return {k: tree(v, i) if isinstance(v, dict)
                else leaf(k, v if i is None else v[i]) for k, v in d.items()}

    stacked = params_np["layers"]
    depth = {np.shape(a)[0] for a in _leaves(stacked)}
    if depth != {cfg.n_layers}:
        raise ValueError(f"layer leaves stacked {sorted(depth)} deep, "
                         f"{cfg.name} has {cfg.n_layers} layers")
    out = {k: tree(v) for k, v in params_np.items() if k != "layers"}
    out["layers"] = [tree(stacked, i) for i in range(cfg.n_layers)]
    return out


def _leaves(d: dict):
    for v in d.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
