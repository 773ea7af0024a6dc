#!/usr/bin/env python3
"""Numerics of the RCV1-shaped sparse cell on the CPU, at its parity size.

    PYTHONPATH=src python tools/sparse_precision_probe.py rows [--n 20000]
    PYTHONPATH=src python tools/sparse_precision_reference.py
    PYTHONPATH=src python tools/sparse_precision_probe.py fit

``rows`` writes the first ``n`` rows of ``rcv1_like(seed=0)`` (d = 47,236)
and 4,096 held-out rows, float32, with the fit settings (p = 2048,
lam = 1e-6, chunk_rows = 8,192, rls_fast / nystrom) and the cells below, to
``build/sparse_probe/rows.npz``. ``tools/sparse_precision_reference.py``
fits them with the JAX package. ``fit`` fits them with the port (``torch``
backend) under the same cells with the reference's draws injected, and
reports for each cell the test MSE against f* beside the reference's, and
the largest difference between the two sides' predictions. A cell is a
bandwidth and a precision policy: float32 throughout (the default policy
for float32 data, which keeps the p×p fit solves in float32); float32 with
float64 p×p solves; float32 data and blocks with float64 accumulation and
solves (the sparse cell's policy in ``chip_smoke.py``); float64.

``fit`` then measures how far one float32 rounding of the kernel blocks
moves the scores, β and the predictions under the sparse cell's policy:
every block of CSR rows is multiplied by (1 + u·2⁻²⁴), u uniform in
[−1, 1], through a kernel object that wraps the RBF kernel, and the fit is
repeated with the same draws. Two float32 implementations of one block (K3 and its plain
version, or K3 and K1 on the densified rows) differ by about that much, so
this sets the scale of ``chip_smoke.py``'s sparse parity tolerances.

These are statements about the arithmetic, not timings: nothing here runs
on a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import (CsrMatrix, Precision, RBFKernel,  # noqa: E402
                             SketchConfig, SketchedKRR)
from repro_torch.data import rcv1_like  # noqa: E402

N_TEST, DIM, P, LAM, CHUNK = 4096, 47_236, 2048, 1e-6, 8192
# the sparse cell's policy in chip_smoke.py: float32 data and blocks,
# float64 accumulation (block products, Gram statistics) and p×p solves
CELL_POLICY = dict(data_dtype="f32", accum_dtype="f64", solve_dtype="f64")
CELLS = [("f32", 1.0, dict(data_dtype="f32")),
         ("f32 + f64 solves", 1.0, dict(data_dtype="f32", solve_dtype="f64")),
         ("f32 + f64 acc/solves", 1.0, CELL_POLICY),
         ("f64", 1.0, dict(data_dtype="f64")),
         ("f32", 0.5, dict(data_dtype="f32")),
         ("f32 + f64 acc/solves", 0.5, CELL_POLICY),
         ("f64", 0.5, dict(data_dtype="f64"))]


@dataclasses.dataclass(frozen=True)
class RoundedOnceMore:
    """An RBF kernel whose blocks of CSR rows take one more float32
    rounding; dense blocks (W = k(Z, Z), the same computation on both
    sides of a parity check) are left as they are."""
    bandwidth: float
    gen: torch.Generator

    def gram(self, X, Z):
        out = RBFKernel(self.bandwidth).gram(X, Z)
        if not isinstance(X, CsrMatrix):
            return out
        u = torch.rand(out.shape, generator=self.gen,
                       dtype=torch.float64) * 2 - 1
        return (out.double() * (1 + u * 2.0 ** -24)).to(out.dtype)

    def diag(self, X):
        return RBFKernel(self.bandwidth).diag(X)


def write_rows(out: Path, n: int) -> None:
    d = rcv1_like(n + N_TEST, dim=DIM, seed=0)
    data, ptr = d["data"].astype(np.float32), d["indptr"]
    cut = int(ptr[n])
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "rows.npz", data=data[:cut], indices=d["indices"][:cut],
             indptr=ptr[:n + 1], test_data=data[cut:],
             test_indices=d["indices"][cut:],
             test_indptr=(ptr[n:] - cut).astype(np.int32), n_cols=DIM,
             y=d["y"][:n].astype(np.float32), f_star_test=d["f_star"][n:],
             p=P, lam=LAM, chunk_rows=CHUNK, cells=json.dumps(CELLS))
    print(f"wrote {n} + {N_TEST} rows to {out / 'rows.npz'}")


def fit(out: Path) -> None:
    torch.set_num_threads(4)
    r, ref = np.load(out / "rows.npz"), np.load(out / "reference.npz")
    X = CsrMatrix(r["data"], r["indices"], r["indptr"], DIM)
    T = CsrMatrix(r["test_data"], r["test_indices"], r["test_indptr"], DIM)
    y, f = r["y"], torch.as_tensor(r["f_star_test"])
    print(f"port (torch {torch.__version__}, torch backend): "
          f"n={X.shape[0]}, {N_TEST} test rows, var(f*) {float(f.var()):.4f}")
    models = {}
    for name, h, prec in CELLS:
        tag = f"{h}|{name}"
        draws = dict(sample=[ref[f"{tag}|{k}"]
                             for k in ("idx", "probs", "weights")],
                     score_landmarks=ref[f"{tag}|landmarks"])
        cfg = SketchConfig(RBFKernel(h), p=P, lam=LAM, chunk_rows=CHUNK,
                           device="cpu", precision=Precision(**prec))
        model = SketchedKRR(cfg).fit(X, y, **draws)
        pred = model.predict(T).double()
        want = torch.as_tensor(ref[f"{tag}|pred"])
        mse = float(torch.mean((pred - f) ** 2))
        ref_mse = float(torch.mean((want - f) ** 2))
        dev = float((pred - want).abs().max() / want.abs().max())
        print(f"bandwidth {h:<4} policy {name:21s} test MSE vs f*: port "
              f"{mse:.4f}, reference {ref_mse:.4f}; predictions max|Δ| / "
              f"max|y| {dev:.3e}", flush=True)
        models[tag] = (model, draws)

    a, draws = models["1.0|f32 + f64 acc/solves"]
    rounded = a.config.replace(
        kernel=RoundedOnceMore(1.0, torch.Generator().manual_seed(9)))
    b = SketchedKRR(rounded).fit(X, y, **draws)
    y_a, y_b = a.predict(T), b.predict(T)
    s_a, s_b = a.scores(), b.scores()
    beta_a, beta_b = a.state().beta, b.state().beta
    print("one float32 rounding of the blocks moves (the cell's policy): "
          f"scores {float(((s_a - s_b).abs() / s_b.abs()).max()):.3e} "
          "(max relative), predictions "
          f"{float((y_a - y_b).abs().max() / y_b.abs().max()):.3e} "
          "(max |Δ| / max |y|), beta "
          f"{float(torch.linalg.norm(beta_a - beta_b) / torch.linalg.norm(beta_b)):.3e}"
          " (‖Δβ‖/‖β‖)")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("step", choices=("rows", "fit"))
    parser.add_argument("--n", type=int, default=20_000)
    parser.add_argument("--dir", type=Path,
                        default=ROOT / "build" / "sparse_probe")
    args = parser.parse_args()
    if args.step == "rows":
        write_rows(args.dir, args.n)
    else:
        fit(args.dir)


if __name__ == "__main__":
    main()
