"""CPU probe behind the parity tolerances of ``chip_smoke.py`` phase ``bf16``.

On the card, ``hopper`` and ``torch`` build the same bf16 blocks from float32
sums taken in other orders (K1's tensor-core accumulators against cuBLAS),
so the two round some block entries to neighbouring bf16 values. This probe
puts a number on what that does to each bf16 path, on the CPU, at the
phase's parity size: the same fit through the ``torch`` executor (float32
sums, rounded to bf16) and through an executor whose blocks are computed in
float64 and rounded to bf16 once (``rounded``), with the same draws. For
the CSR path it also runs ``hopper`` (K3's plain version: ‖x‖² and the
cross product rounded to bf16 before the rbf epilogue, as the reference's
``sparse_kernel_block`` does), which differs from ``torch`` in every entry
by those extra roundings. Printed for each pair: the scores' largest relative
difference, β's relative l2 difference, the largest change of a test
prediction over the largest prediction and the predictions' relative l2
difference, and each fit's test MSE against f*.

    PYTHONPATH=src python tools/bf16_parity_probe.py [dense|csr|csr64|serve|all] [n] [threads]

MSD-shaped rows (``pumadyn_like(dim=90, seed=0)``, RBF(6.0)) and RCV1-shaped
CSR rows (``rcv1_like(seed=0)``, RBF(1.0), chunks of 8,192), n = 20,000 by
default, p = 2048, λ = 1e-6, ``Precision(data_dtype="bf16",
solve_dtype="f64")`` (``csr64``: the CSR fit with float64 accumulation,
``accum_dtype="f64"``, the sparse cell's); the quantized server
(``serve_dtype="bf16"``) on a float32 fit of the MSD rows.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.api import Precision, RBFKernel, SketchConfig, SketchedKRR
from repro_torch.core import backends as tb
from repro_torch.core.leverage import draw_landmarks
from repro_torch.data import CsrMatrix, pumadyn_like, rcv1_like

P, LAM, N_TEST, PARITY_CHUNK = 2048, 1e-6, 4096, 8192
BF16 = Precision(data_dtype="bf16", solve_dtype="f64")


@tb.BACKENDS.register("rounded")
@dataclasses.dataclass(frozen=True)
class RoundedOps(tb.TorchOps):
    """Blocks computed in float64 and rounded to their dtype once."""

    name = "rounded"

    def cross(self, X_test, Z, *, prepared=None):
        X_test, Z = self._cast_data(X_test, Z)
        out = torch.promote_types(X_test.dtype, Z.dtype)
        wide = (X_test.astype(torch.float64) if isinstance(X_test, CsrMatrix)
                else X_test.double())
        return self.kernel.gram(wide, Z.double()).to(out)


def _diff(a, b) -> dict:
    sa, sb = a.scores().double(), b.scores().double()
    ba, bb = a.state().beta.double(), b.state().beta.double()
    return dict(scores=float(((sa - sb).abs() / sb.abs()).max()),
                beta=float(torch.linalg.norm(ba - bb) / torch.linalg.norm(bb)))


def _pred_diff(ya, yb) -> float:
    ya, yb = ya.double(), yb.double()
    return float((ya - yb).abs().max() / yb.abs().max())


def _pred_l2(ya, yb) -> float:
    ya, yb = ya.double(), yb.double()
    return float(torch.linalg.norm(ya - yb) / torch.linalg.norm(yb))


def _mse(y, f) -> float:
    return float(torch.mean((y.double() - torch.as_tensor(f).double()) ** 2))


def dense(n: int) -> None:
    d = pumadyn_like(n + N_TEST, dim=90, seed=0)
    X = d["x"].astype(np.float32)
    y = d["y"].astype(np.float32)
    f = d["f_star"][n:]
    Xtr, ytr, Xte = X[:n], y[:n], X[n:]
    cfg = SketchConfig(RBFKernel(6.0), p=P, lam=LAM, device="cpu",
                       precision=BF16)
    idx = draw_landmarks(torch.Generator().manual_seed(3),
                         torch.full((n,), 1.0 / n), P)
    t0 = time.perf_counter()
    fits = {"torch": SketchedKRR(cfg.replace(backend="torch")).fit(
        Xtr, ytr, score_landmarks=idx)}
    draws = dict(score_landmarks=idx, sample=fits["torch"].sample())
    fits["rounded"] = SketchedKRR(cfg.replace(backend="rounded")).fit(
        Xtr, ytr, **draws)
    preds = {k: m.predict(Xte) for k, m in fits.items()}
    e = _diff(fits["torch"], fits["rounded"])
    e["predictions"] = _pred_diff(preds["torch"], preds["rounded"])
    e["predictions_l2"] = _pred_l2(preds["torch"], preds["rounded"])
    print(f"dense bf16 storage, n={n}: torch vs rounded {e}; test MSE "
          f"torch {_mse(preds['torch'], f):.5f}, rounded "
          f"{_mse(preds['rounded'], f):.5f}, var(f*) {np.var(f):.5f} "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)


def csr(n: int, precision: Precision = BF16) -> None:
    d = rcv1_like(n + N_TEST, seed=0)
    ptr, cut = d["indptr"], int(d["indptr"][n])
    data = d["data"].astype(np.float32)
    train = CsrMatrix(data[:cut], d["indices"][:cut], ptr[:n + 1],
                      d["n_cols"])
    test = CsrMatrix(data[cut:], d["indices"][cut:],
                     (ptr[n:] - cut).astype(np.int32), d["n_cols"])
    y, f = d["y"][:n].astype(np.float32), d["f_star"][n:]
    cfg = SketchConfig(RBFKernel(1.0), p=P, lam=LAM, device="cpu",
                       chunk_rows=PARITY_CHUNK, precision=precision)
    idx = draw_landmarks(torch.Generator().manual_seed(3),
                         torch.full((n,), 1.0 / n), P)
    t0 = time.perf_counter()
    fits = {"hopper": SketchedKRR(cfg.replace(backend="hopper")).fit(
        train, y, score_landmarks=idx)}
    draws = dict(score_landmarks=idx, sample=fits["hopper"].sample())
    for name in ("torch", "rounded"):
        fits[name] = SketchedKRR(cfg.replace(backend=name)).fit(
            train, y, **draws)
    preds = {k: m.predict(test) for k, m in fits.items()}
    for a, b in (("torch", "rounded"), ("hopper", "torch")):
        e = _diff(fits[a], fits[b])
        e["predictions"] = _pred_diff(preds[a], preds[b])
        e["predictions_l2"] = _pred_l2(preds[a], preds[b])
        print(f"csr bf16 storage, {precision}, n={n}: {a} vs {b} {e}",
              flush=True)
    print("csr test MSE " + ", ".join(f"{k} {_mse(v, f):.5f}"
                                      for k, v in preds.items())
          + f", var(f*) {np.var(f):.5f} ({time.perf_counter() - t0:.0f} s)",
          flush=True)


def serve(n: int) -> None:
    d = pumadyn_like(n + N_TEST, dim=90, seed=0)
    X = d["x"].astype(np.float32)
    y = d["y"].astype(np.float32)
    cfg = SketchConfig(RBFKernel(6.0), p=P, lam=LAM, device="cpu",
                       precision=Precision(serve_dtype="bf16"))
    model = SketchedKRR(cfg).fit(X[:n], y[:n])
    other = SketchedKRR(cfg.replace(backend="rounded")).import_serving_state(
        model.export_serving_state())
    a = model.predict_batched(X[n:], 256)
    b = other.predict_batched(X[n:], 256)
    st = model.export_serving_state()
    K = tb.ops_for(RBFKernel(6.0), "torch", device="cpu").cross(
        torch.as_tensor(X[n:]), st.landmarks)
    scale = K.double().abs() @ st.beta.double().abs()
    rel = float(((a.double() - b.double()).abs() / scale).max())
    print(f"quantized serving, n={n}: torch vs rounded predictions "
          f"{_pred_diff(a, b):.3e} of the largest, {rel:.3e} of "
          f"sum_j |k_j beta_j| at worst", flush=True)


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 20_000
    torch.set_num_threads(int(sys.argv[3]) if len(sys.argv) > 3 else 4)
    csr64 = lambda m: csr(m, Precision(data_dtype="bf16", accum_dtype="f64",
                                       solve_dtype="f64"))
    for name, fn in (("dense", dense), ("csr", csr), ("csr64", csr64),
                     ("serve", serve)):
        if what in (name, "all"):
            fn(n)
