#!/usr/bin/env python3
"""How far a bf16 SSM's decode steps move from its prefill, on the CPU, in
the JAX package and in the port, at a model's published widths.

    PYTHONPATH=src python tools/ssm_decode_parity_probe.py \
        [--arch zamba2-7b | mamba2-780m] [--layers 6 12 24]

The arch's config (zamba2-7b: d_model 3,584, 112 SSD heads of 64, d_state
64, 2 groups, chunk 256, the shared attention + MLP block of 32 heads of
112 after every 6 layers, vocabulary 32,000; mamba2-780m: d_model 1,536,
48 heads of 64, d_state 128, vocabulary 50,280), cut to each ``--layers``
depth, bf16, weights from the JAX package's ``init_model`` (seed 0),
carried into the port with ``params_from_reference``. For each depth and
each package:
the forward of 64 tokens from numpy (seed 0), then 64 decode steps, and
the largest difference between the last decode logits and the forward's
last logits beside the forward's largest logit. The forward runs the
chunked SSD (the c × c Gram, decay and diagonal term in bf16); the decode
steps the float32 recurrence, so the two round at different places and
the difference grows with depth. ``chip_smoke.py`` phase ``families``
holds zamba2-7b's 81 layers and mamba2-780m's 48 on the card to the
bounds this sets. A statement about arithmetic, not a timing: nothing
here runs on a GPU.
"""
import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_decode_state as jax_decode_state
from repro.models import init_model as jax_init_model
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, init_decode_state,
                                params_from_reference)

S = 64


def _jax(cfg, params, toks) -> tuple[float, float]:
    full = jax.jit(jax_forward, static_argnums=1)(
        params, cfg, tokens=jnp.asarray(toks)).logits[:, -1]
    step = jax.jit(jax_decode_step, static_argnums=1)
    st = jax_decode_state(cfg, 1, S)
    for i in range(S):
        lg, st = step(params, cfg, jnp.asarray(toks[:, i:i + 1]), st)
    full = np.asarray(full, np.float32)
    return (float(np.abs(np.asarray(lg[:, 0], np.float32) - full).max()),
            float(np.abs(full).max()))


def _port(cfg, params, toks) -> tuple[float, float]:
    t = torch.as_tensor(toks)
    full = forward(params, cfg, t).logits[:, -1]
    st = init_decode_state(cfg, 1, S, device="cpu")
    for i in range(S):
        lg, st = decode_step(params, cfg, t[:, i:i + 1], st)
    return float((lg[:, 0] - full).abs().max()), float(full.abs().max())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="zamba2-7b",
                        choices=("zamba2-7b", "mamba2-780m"))
    parser.add_argument("--layers", type=int, nargs="+", default=[6, 12, 24])
    args = parser.parse_args()
    torch.set_num_threads(4)
    toks = np.random.default_rng(0).integers(0, 32_000, (1, S)).astype(
        np.int32)
    for n in args.layers:
        jcfg = dataclasses.replace(jax_config(args.arch), n_layers=n,
                                   dtype="bfloat16")
        tcfg = dataclasses.replace(get_config(args.arch), n_layers=n,
                                   dtype="bfloat16", use_pallas=True)
        t0 = time.perf_counter()
        jparams = jax.jit(jax_init_model, static_argnums=0)(
            jcfg, jax.random.key(0))
        tparams = params_from_reference(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
        for name, fn, cfg, params in (("jax", _jax, jcfg, jparams),
                                      ("port", _port, tcfg, tparams)):
            diff, largest = fn(cfg, params, toks)
            print(f"{args.arch} {n:3d} layers, {name:4s}: decode x{S} vs "
                  f"prefill, last position: max|Δ| {diff:.4g} against a "
                  f"largest |logit| "
                  f"{largest:.4g} = {diff / largest:.4f} of it "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
        del jparams, tparams


if __name__ == "__main__":
    main()
