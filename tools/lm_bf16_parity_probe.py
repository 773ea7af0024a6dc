#!/usr/bin/env python3
"""How far the LM's two exact attention routes move bf16 logits, on the CPU.

    PYTHONPATH=src python tools/lm_bf16_parity_probe.py [--k4 tensor-core]

A cut of the ``chip_smoke.py`` LM cell (phi4-mini-3.8b's architecture at 8
layers, d_model 768, 6 query / 2 KV heads of 128, d_ff 2,048, vocabulary
32,000; bf16; random weights from seed 0) runs one forward of 1,280 tokens
through K4's plain version (``use_pallas=True`` on CPU tensors) and through
the chunked online softmax (``use_pallas=False``, S > 1,024), and prints the
largest logit difference beside the largest logit and the share of
positions whose arg-max agrees; then 64 ``decode_step`` calls against the
forward's last logits. Both routes compute attention in float32 and round
its output to bf16, so this measures how the flipped roundings travel
through bf16 layers. It set the tolerances of ``chip_smoke.py``'s LM parity
checks before the first full-size run.

``--k4 tensor-core`` puts, in place of K4's plain version, the plain
emulation of what K4's bf16 instance computes on the card (bf16 products
summed in float32, softmax weights rounded to bf16 for P·V;
``k4_tensor_core_emulation`` in tests/test_torch_attention.py, which needs
JAX importable): the prediction of the card's prefill parity. A statement
about arithmetic, not a timing: nothing here runs on a GPU.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import decode_step, forward, init_decode_state, \
    init_model


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--k4", choices=("plain", "tensor-core"),
                        default="plain", help="K4's arithmetic on the "
                        "use_pallas route (default: its plain version)")
    if parser.parse_args().k4 == "tensor-core":
        from repro_torch.kernels import ref
        sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
        from test_torch_attention import k4_tensor_core_emulation
        ref.flash_attention_ref = k4_tensor_core_emulation
    torch.set_num_threads(4)
    cfg = dataclasses.replace(
        get_config("phi4-mini-3.8b"), n_layers=8, d_model=768, n_heads=6,
        n_kv_heads=2, d_ff=2048, vocab_size=32_000, dtype="bfloat16",
        use_pallas=True)
    params = init_model(cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 1280)), dtype=torch.int32)
    a = forward(params, cfg, toks).logits
    b = forward(params, dataclasses.replace(cfg, use_pallas=False),
                toks).logits
    d = (a - b).abs()
    print(f"prefill K4-plain vs chunked: max|Δ| {float(d.max()):.4g}, "
          f"mean|Δ| {float(d.mean()):.4g}, largest |logit| "
          f"{float(b.abs().max()):.4g}, arg-max agrees at "
          f"{100 * float((a.argmax(-1) == b.argmax(-1)).float().mean()):.2f} %")
    prompt = toks[:, :64]
    full = forward(params, cfg, prompt).logits[0, -1]
    st = init_decode_state(cfg, 1, 64, device="cpu")
    for i in range(64):
        lg, st = decode_step(params, cfg, prompt[:, i:i + 1], st)
    top2 = torch.topk(full, 2).values
    print(f"decode x64 vs prefill: max|Δ| "
          f"{float((lg[0, 0] - full).abs().max()):.4g}, greedy "
          f"{int(lg[0, 0].argmax())} / {int(full.argmax())}, top-2 gap "
          f"{float(top2[0] - top2[1]):.4g}")


if __name__ == "__main__":
    main()
