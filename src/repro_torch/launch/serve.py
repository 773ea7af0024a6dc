"""Serving launcher: batched generation with the continuous-batching engine.

``python -m repro_torch.launch.serve --arch phi4-mini-3.8b --requests 8``
runs the reduced (~100M) variant of the arch (``build_small_cfg``) on the
card; ``--device cpu`` runs it on the CPU through the plain versions. Every
text arch serves: dense, moe (deepseek-moe-16b, llama4-scout-17b-a16e), ssm
(mamba2-780m) and hybrid (zamba2-7b); the vision and audio archs take
embeddings, which ``ServeEngine``'s token requests cannot carry.
``--nystrom`` turns on the paper's RLS landmark attention and its
compressed KV reads (64 landmarks, 16 recent positions, as the reference).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..models import init_model
from ..runtime import Request, ServeEngine
from .train import build_small_cfg


def main(argv: list[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--nystrom", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = build_small_cfg(args.arch)
    if args.nystrom:
        cfg = dataclasses.replace(cfg, attn_approx="nystrom_rls",
                                  nystrom_landmarks=64, rls_keep_recent=16)
    params = init_model(cfg, device=args.device)     # seed 0
    engine = ServeEngine(cfg, params, slots=args.slots,
                         max_len=args.max_len)

    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(4, 12)).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=args.max_new))
    done = engine.run()
    for req in sorted(done, key=lambda r: r.uid):
        print(f"req {req.uid}: prompt_len={len(req.prompt)} "
              f"generated={req.generated[:8]}...")
    print(f"served {len(done)}/{args.requests} requests")
    return done


if __name__ == "__main__":
    main()
