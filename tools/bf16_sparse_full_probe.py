#!/usr/bin/env python3
"""Path (c) of ``chip_smoke.py`` phase ``bf16`` at its full n under the
bf16 rule, on one GPU, through the ``hopper`` and the ``torch`` backends.

    PYTHONPATH=src python tools/bf16_sparse_full_probe.py [--out PATH]

The RCV1 cell (``rcv1_like(seed=0)``: 677,399 train and 20,242 test rows,
d = 47,236, RBF(1.0), p = 2048, λ = 1e-6, chunks of 131,072 rows) in bf16
CSR chunks with ``Precision(data_dtype="bf16", solve_dtype="f64")``: bf16
blocks accumulated in float32, float64 p×p solves. ``chip_smoke.py`` fits
this cell with float64 accumulation (``BF16_SPARSE_PRECISION``) and runs
the bf16 rule only at n = 20,000; this probe says whether the float32
accumulation fails at the full n on both backends alike, and so whether
the failure is the policy's or the kernels'.

Four fits under the bf16 rule: each backend with its own draws (the
config's seed), and each with the same injected draws (score landmarks
drawn uniformly, and the column sample of a hopper fit under the float64
accumulation, which fits). For each: whether the fit went through or the
error it raised, its seconds, and the test MSE against f* where it fit,
beside var(f*). Printed one line each and written as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.api import (Precision, RBFKernel, SketchConfig,  # noqa: E402
                             SketchedKRR)
from repro_torch.core.leverage import draw_landmarks  # noqa: E402


def _fit(cfg, rc, **draws) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        model = SketchedKRR(cfg).fit(rc["train"], rc["y"], **draws)
        torch.cuda.synchronize()
    except RuntimeError as err:       # torch.linalg.LinAlgError included
        return dict(ok=False, seconds=time.perf_counter() - t0,
                    error=f"{type(err).__name__}: {err}")
    fit_s = time.perf_counter() - t0
    y = model.predict(rc["test"])
    return dict(ok=True, seconds=fit_s, test_mse=cs._mse(y, rc["f_test"]),
                finite=bool(torch.isfinite(y).all()), model=model)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/bf16_sparse_full_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    rc = cs._rcv1({})
    var_f = float(torch.var(torch.as_tensor(rc["f_test"]).double()))
    base = SketchConfig(RBFKernel(cs.RCV1_BANDWIDTH), p=cs.P, lam=cs.LAM,
                        chunk_rows=cs.CHUNK_ROWS)
    rule = Precision(**cs.BF16_PRECISION)
    rows: dict = {}

    def report(label, r):
        r.pop("model", None)
        rows[label] = r
        what = (f"test MSE {r['test_mse']:.6f} (finite {r['finite']})"
                if r["ok"] else r["error"])
        print(f"[probe] {label}: {r['seconds']:.3f} s, {what}; var(f*) "
              f"{var_f:.4f}", flush=True)

    for backend in ("hopper", "torch"):
        report(f"{backend}, bf16 rule, own draws",
               _fit(base.replace(backend=backend, precision=rule), rc))
    idx = draw_landmarks(torch.Generator().manual_seed(3),
                         torch.full((cs.RCV1_TRAIN,), 1.0 / cs.RCV1_TRAIN),
                         cs.P)
    ref = _fit(base.replace(backend="hopper", precision=Precision(
        **cs.BF16_SPARSE_PRECISION)), rc, score_landmarks=idx)
    sample = ref["model"].sample() if ref["ok"] else None
    report("hopper, float64 accumulation, landmarks injected", ref)
    if sample is not None:
        for backend in ("hopper", "torch"):
            report(f"{backend}, bf16 rule, draws injected",
                   _fit(base.replace(backend=backend, precision=rule), rc,
                        score_landmarks=idx, sample=sample))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=cs.card_line(), var_f_star=var_f,
                                   fits=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
