"""Carry the reference's parameters into the port.

``params_from_reference`` takes the JAX package's parameter tree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``), whose
"layers" leaves are stacked on a leading (L, …) axis, and returns the
port's parameters: the same names, one dict per layer, weights in
``dtype`` (``cfg.dtype`` by default, for serving; ``cfg.param_dtype`` for
training), and norm scales and the SSM's float32 parameters in float32
(see ``transformer``). "layer0" (deepseek's dense first layer, outside the
reference's stack), "shared_attn" and "cb_head" come across as they are.
The tests use it so that both packages compute with the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.precision import to_dtype
from ..device import resolve_device
from .transformer import check_supported

# leaves that stay float32 whatever dtype the weights take: the norms'
# scales and the parameters the reference's SSM uses in float32 uncast
FLOAT32_LEAVES = frozenset({"scale", "A_log", "D", "dt_bias", "norm_scale",
                            "conv_b"})


def params_from_reference(params_np: dict, cfg: ModelConfig,
                          device="cuda", dtype=None) -> dict:
    check_supported(cfg)
    dev = resolve_device(device)
    weights = cfg.act_dtype if dtype is None else to_dtype(dtype)

    def leaf(name: str, a) -> torch.Tensor:
        dt = torch.float32 if name in FLOAT32_LEAVES else weights
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dt)

    def tree(d: dict, i: int | None = None) -> dict:
        return {k: tree(v, i) if isinstance(v, dict)
                else leaf(k, v if i is None else v[i]) for k, v in d.items()}

    stacked = params_np["layers"]
    n = cfg.n_layers - (1 if "layer0" in params_np else 0)
    depth = {np.shape(a)[0] for a in _leaves(stacked)}
    if depth != {n}:
        raise ValueError(f"layer leaves stacked {sorted(depth)} deep, "
                         f"{cfg.name} stacks {n} layers")
    out = {k: tree(v) if isinstance(v, dict) else leaf(k, v)
           for k, v in params_np.items() if k != "layers"}
    out["layers"] = [tree(stacked, i) for i in range(n)]
    return out


def _leaves(d: dict):
    for v in d.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
