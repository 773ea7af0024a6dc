"""The small family configs that tests/test_torch_families*.py share: the
JAX smoke tests' reduction (tests/test_models_smoke.py ``small_cfg``) in
both packages, and one set of weights for both.

Weights: the port's ``init_model`` (the reference's initialisers, seed 0)
stacked into the reference's tree, which the JAX functions take as they
are, and carried back through ``params_from_reference``. The JAX
``init_model`` itself takes 3–9 s an architecture on this CPU (eagerly;
2–4 s under ``jit``), more than these files' budget; tests/
test_torch_families.py holds its tree against the port's through
``jax.eval_shape``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from test_models_smoke import small_cfg

from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig, SSMConfig
from repro_torch.models import init_model, params_from_reference


def port_config(jcfg):
    """The port's copy of a JAX ``ModelConfig``."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["moe"] = MoEConfig(**dataclasses.asdict(jcfg.moe))
    fields["ssm"] = SSMConfig(**dataclasses.asdict(jcfg.ssm))
    return dataclasses.replace(get_config(jcfg.name), **fields)


def reference_tree(params: dict) -> dict:
    """The port's parameters as the reference's numpy tree: the list of
    layers stacked on a leading axis, float32."""
    def np_tree(p):
        if isinstance(p, dict):
            return {k: np_tree(v) for k, v in p.items()}
        return p.float().numpy()

    out = {k: np_tree(v) for k, v in params.items() if k != "layers"}
    layers = [np_tree(p) for p in params["layers"]]
    out["layers"] = jax.tree.map(lambda *a: np.stack(a), *layers)
    return out


@functools.cache
def model(name: str, dtype: str = "float32"):
    """(JAX cfg, port cfg, JAX params, port params) of a small config."""
    jcfg = dataclasses.replace(small_cfg(name), dtype=dtype)
    tcfg = port_config(jcfg)
    ref = reference_tree(init_model(dataclasses.replace(tcfg,
                                                        dtype="float32"),
                                    device="cpu"))
    jparams = jax.tree.map(jnp.asarray, ref)
    return jcfg, tcfg, jparams, params_from_reference(ref, tcfg,
                                                      device="cpu")


def inputs(cfg, b: int, s: int, seed: int) -> dict:
    """numpy tokens, or embeddings for the vision / audio configs."""
    g = np.random.default_rng(seed)
    if cfg.modality in ("vision", "audio"):
        return {"embeds": g.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)}
    return {"tokens": g.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
