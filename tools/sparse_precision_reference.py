#!/usr/bin/env python3
"""The JAX package's chunked CSR fit on the RCV1-shaped probe rows (CPU).

    PYTHONPATH=src python tools/sparse_precision_probe.py rows
    PYTHONPATH=src python tools/sparse_precision_reference.py
    PYTHONPATH=src python tools/sparse_precision_probe.py fit

The first step writes the probe's rows (``rcv1_like(seed=0)``, n training
and 4,096 held-out rows) and its fit settings to
``build/sparse_probe/rows.npz``. This script fits those rows with
``repro.api.SketchedKRR`` through the reference's out-of-core driver (xla
backend, float64 enabled, rls_fast / nystrom) under each (bandwidth,
precision policy) cell the rows file lists, prints the test MSE against
f*, and writes every fit's draws (the column sample, and the score
landmarks re-drawn from the driver's own key splits) and predictions to
``build/sparse_probe/reference.npz``. The last step fits the PyTorch port
with those draws, so both sides are compared on one sample.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

jax.config.update("jax_enable_x64", True)

from repro.api import Precision, SketchConfig, SketchedKRR  # noqa: E402
from repro.core import RBFKernel  # noqa: E402
from repro.core.leverage import draw_landmarks  # noqa: E402
from repro.data.sparse import CsrMatrix  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dir", type=Path,
                        default=ROOT / "build" / "sparse_probe")
    args = parser.parse_args()
    r = np.load(args.dir / "rows.npz")
    dim = int(r["n_cols"])
    X = CsrMatrix(jnp.asarray(r["data"]), jnp.asarray(r["indices"]),
                  jnp.asarray(r["indptr"]), dim)
    T = CsrMatrix(jnp.asarray(r["test_data"]), jnp.asarray(r["test_indices"]),
                  jnp.asarray(r["test_indptr"]), dim)
    n, y, f = X.shape[0], jnp.asarray(r["y"]), r["f_star_test"]
    print(f"reference (JAX {jax.__version__}, xla backend): n={n}, "
          f"{T.shape[0]} test rows, var(f*) {f.var():.4f}")
    out = {}
    for name, h, prec in json.loads(str(r["cells"])):
        cfg = SketchConfig(kernel=RBFKernel(h), p=int(r["p"]),
                           lam=float(r["lam"]), chunk_rows=int(r["chunk_rows"]),
                           backend="xla", precision=Precision(**prec))
        t0 = time.perf_counter()
        model = SketchedKRR(cfg).fit(X, y)
        pred = np.asarray(model.predict(T), dtype=np.float64)
        mse = float(np.mean((pred - f) ** 2))
        print(f"bandwidth {h:<4} policy {name:21s} test MSE vs f* "
              f"{mse:.4f}  ({time.perf_counter() - t0:.0f} s)", flush=True)
        key_sample, _ = jax.random.split(jax.random.key(cfg.seed))
        kd, _ = jax.random.split(key_sample)
        landmarks = draw_landmarks(kd, jnp.full((n,), 1.0 / n),
                                   min(cfg.score_pass_p, n), True)
        tag = f"{h}|{name}"
        for field, value in model.sample()._asdict().items():
            out[f"{tag}|{field}"] = np.asarray(value)
        out[f"{tag}|landmarks"] = np.asarray(landmarks)
        out[f"{tag}|pred"] = pred
    np.savez(args.dir / "reference.npz", **out)


if __name__ == "__main__":
    main()
