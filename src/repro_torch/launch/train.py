"""Training launcher: ``python -m repro_torch.launch.train --arch phi4-mini-3.8b``

Trains the reduced (~100M) variant of the arch (``build_small_cfg``; the
published config with ``--full-config``) on the one device (the card by
default, ``--device cpu`` through the plain versions): float32 master
weights from seed 0, the synthetic token stream (``batch_for_step``: for
the vision / audio archs, N(0, 1) embeddings in place of the tokens and,
for the codebook head, the labels repeated over the codebooks, as the
reference's launcher feeds them), ``make_train_step`` under the
fault-tolerant ``TrainDriver`` with checkpoints every ``--ckpt-every``
steps (it resumes from the newest complete checkpoint in ``--ckpt-dir``).
Every family trains. The reference shards over a host mesh; the port has
one device until ROADMAP item 9.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile

import numpy as np
import torch

from ..configs import get_config
from ..data import LMDataConfig, lm_batch
from ..models import init_model
from ..optim import AdamWConfig
from ..runtime import (DriverConfig, TrainDriver, init_train_state,
                       make_train_step)


def build_small_cfg(arch: str, **over):
    """~100M-scale variant of an arch for end-to-end examples, the
    reference's reduction for every family (``launch/serve.py`` serves at
    it, and this launcher trains at it)."""
    cfg = get_config(arch)
    small = dict(n_layers=min(cfg.n_layers, 8),
                 d_model=512,
                 n_heads=8 if cfg.n_heads else 0,
                 n_kv_heads=max(1, min(cfg.n_kv_heads, 4)) if cfg.n_heads
                 else 0,
                 head_dim=64 if cfg.n_heads else 0,
                 d_ff=1536 if cfg.d_ff else 0,
                 vocab_size=min(cfg.vocab_size, 32_000),
                 vocab_pad_multiple=128,
                 dtype="float32")
    if cfg.family == "moe":
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=512, d_ff_shared=512,
            first_dense_ff=1536 if cfg.moe.first_dense_ff else 0)
    if cfg.family in ("ssm", "hybrid"):
        small["ssm"] = dataclasses.replace(cfg.ssm, d_state=64, head_dim=64,
                                           chunk=128)
    if cfg.family == "hybrid":
        small["shared_attn_every"] = 3
    small.update(over)
    return dataclasses.replace(cfg, **small)


def batch_for_step(cfg, data_cfg: LMDataConfig, step: int) -> dict:
    """The launcher's batch for ``step``, a pure function of the step on
    the CPU: ``lm_batch`` for the text archs; for the vision / audio archs
    float32 N(0, 1) embeddings (b, s, d_model) from a generator seeded by
    (7, step) in place of the tokens (the reference folds the step into
    key 7), and the labels, repeated over the codebooks for the codebook
    head ((b, s, codebooks))."""
    b = lm_batch(data_cfg, step)
    if cfg.modality not in ("vision", "audio"):
        return b
    key = np.random.SeedSequence([7, step]).generate_state(1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(key))
    emb = torch.randn((data_cfg.global_batch, data_cfg.seq_len, cfg.d_model),
                      generator=g)
    lab = b["labels"]
    if cfg.modality == "audio":
        lab = lab[..., None].expand(lab.shape + (cfg.num_codebooks,))
    return {"embeds": emb, "labels": lab}


def make_driver(cfg, *, steps: int, batch: int, seq: int, lr: float,
                ckpt_dir: str, ckpt_every: int, compress_grads: bool = False,
                microbatches: int = 1, device="cuda",
                fault_hook=None) -> TrainDriver:
    """The launcher's driver: masters in ``cfg.param_dtype`` from seed 0,
    AdamW with the launcher's schedule (warmup ``max(steps // 20, 10)``),
    batches ``batch_for_step(cfg, data_cfg, step)``, ``fault_hook`` as
    ``TrainDriver``'s."""
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 10))
    data_cfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                            global_batch=batch)
    params = init_model(cfg, device=device, dtype=cfg.param_dtype)
    opt_state, comp_state = init_train_state(
        cfg, params, compress_grads=compress_grads)
    step_fn = make_train_step(cfg, opt_cfg, num_microbatches=microbatches,
                              compress_grads=compress_grads)

    def driver_step(state, batch):
        out = step_fn(*state, batch)
        return (out.params, out.opt_state, out.comp_state), out.metrics

    return TrainDriver(
        DriverConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                     ckpt_every=ckpt_every),
        driver_step, (params, opt_state, comp_state),
        lambda step: batch_for_step(cfg, data_cfg, step),
        fault_hook=fault_hook)


def main(argv: list[str] | None = None) -> TrainDriver:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full published config")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = get_config(args.arch) if args.full_config \
        else build_small_cfg(args.arch)
    # exact attention through K4 on the card (its plain version on the CPU)
    cfg = dataclasses.replace(cfg, use_pallas=True)
    driver = make_driver(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         compress_grads=args.compress_grads,
                         microbatches=args.microbatches, device=args.device)
    driver.run()

    losses = [m["loss"] for m in driver.metrics_log]
    print(f"steps={len(losses)} first_loss={losses[0]:.4f} "
          f"last_loss={losses[-1]:.4f} "
          f"stragglers={driver.stragglers.slow_steps}")
    return driver


if __name__ == "__main__":
    main()
