"""CPU probe behind the tolerances of ``chip_smoke.py`` phase ``iter``.

On the card, ``hopper`` and ``torch`` differ by how their float32 blocks
are rounded (K1's fma order against cuBLAS's). This probe puts a number on
what one float32 rounding of every kernel block does to each path of the
phase, on the CPU: the same fit through the ``torch`` executor (float32
arithmetic) and through an executor whose blocks are computed in float64
and rounded to float32 once, with the same draws (and, for eigenpro, the
same seed). It prints, for falkon_pcg, eigenpro and a streaming fit, the
relative l2 change of β and the largest change of a test prediction over
the largest prediction, and for the streaming fit its scores' largest
relative change; then the streamed score pass against the dense one on the
same landmarks (the two score routes of path (c)).

    PYTHONPATH=src python tools/iter_parity_probe.py [n] [threads]
    PYTHONPATH=src python tools/iter_parity_probe.py scores n1,n2,... [threads]

The second form measures only the two float32 score routes (streamed and
dense) at each n against the float64 scores on the same landmarks (the
dense pass on float64 copies), to show how their difference grows with n.
The third measures the streamed float32 route alone against the streamed
float64 route (which equals the dense float64 pass to 1e-10), holding
O(block_rows·p) whatever n is, so it reaches the cell's n = 463,715:

    PYTHONPATH=src python tools/iter_parity_probe.py streamed n [threads]

MSD-shaped rows (``pumadyn_like(dim=90, seed=0)``) as in ``chip_smoke.py``,
n = 20,000 by default (the phase's parity size), p = 2048, λ = 1e-6,
RBF(6.0), float32 data.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.api import RBFKernel, SketchConfig, SketchedKRR
from repro_torch.core import backends as tb
from repro_torch.core.leverage import draw_landmarks, fast_ridge_leverage
from repro_torch.data import pumadyn_like

P, LAM, BANDWIDTH, N_TEST = 2048, 1e-6, 6.0, 4096


@tb.BACKENDS.register("rounded")
@dataclasses.dataclass(frozen=True)
class RoundedOps(tb.TorchOps):
    """Blocks computed in float64 and rounded to their dtype once."""

    name = "rounded"

    def cross(self, X_test, Z, *, prepared=None):
        X_test, Z = self._cast_data(X_test, Z)
        out = torch.promote_types(X_test.dtype, Z.dtype)
        return self.kernel.gram(X_test.double(), Z.double()).to(out)


def _msd_rows(n: int):
    data = pumadyn_like(n + N_TEST, dim=90, seed=0)
    return data["x"].astype(np.float32), data["y"].astype(np.float32)


def score_routes(sizes: list[int]) -> None:
    """Max relative error of each float32 score route against float64."""
    kernel = RBFKernel(BANDWIDTH)
    lam = LAM * 0.5          # the score pass runs at λε, ε = 0.5
    for n in sizes:
        X = torch.as_tensor(_msd_rows(n)[0][:n])
        idx = draw_landmarks(torch.Generator().manual_seed(5),
                             torch.full((n,), 1.0 / n), P)
        t0 = time.perf_counter()
        exact = fast_ridge_leverage(
            kernel, X.double(), lam, P, idx=idx,
            ops=tb.ops_for(kernel, "torch", device="cpu")).scores
        got = {name: fast_ridge_leverage(
            kernel, X, lam, P, idx=idx,
            ops=tb.ops_for(kernel, name, device="cpu")).scores.double()
            for name in ("streaming", "torch")}

        def rel(a, b):
            return float(((a - b).abs() / b.abs()).max())

        print(f"n={n}: max rel vs float64 scores: streamed "
              f"{rel(got['streaming'], exact):.3e}, dense "
              f"{rel(got['torch'], exact):.3e}; streamed vs dense "
              f"{rel(got['streaming'], got['torch']):.3e} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)


def streamed_route(n: int) -> None:
    """Max relative error of the streamed float32 scores against the
    streamed float64 scores on the same landmarks."""
    kernel = RBFKernel(BANDWIDTH)
    X = torch.as_tensor(_msd_rows(n)[0][:n])
    idx = draw_landmarks(torch.Generator().manual_seed(5),
                         torch.full((n,), 1.0 / n), P)
    ops = tb.ops_for(kernel, "streaming", device="cpu")
    t0 = time.perf_counter()
    exact = fast_ridge_leverage(kernel, X.double(), LAM * 0.5, P, idx=idx,
                                ops=ops).scores
    got = fast_ridge_leverage(kernel, X, LAM * 0.5, P, idx=idx,
                              ops=ops).scores.double()
    print(f"n={n}: streamed float32 scores vs float64: max rel "
          f"{float(((got - exact).abs() / exact.abs()).max()):.3e} "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "streamed":
        torch.set_num_threads(int(sys.argv[3]) if len(sys.argv) > 3 else 4)
        streamed_route(int(sys.argv[2]))
        return
    if len(sys.argv) > 1 and sys.argv[1] == "scores":
        torch.set_num_threads(int(sys.argv[3]) if len(sys.argv) > 3 else 4)
        score_routes([int(v) for v in sys.argv[2].split(",")])
        return
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    torch.set_num_threads(int(sys.argv[2]) if len(sys.argv) > 2 else 4)
    X, y = _msd_rows(n)
    Xtr, ytr, Xte = X[:n], y[:n], torch.as_tensor(X[n:])
    cfg = SketchConfig(RBFKernel(BANDWIDTH), p=P, lam=LAM, device="cpu")
    idx = draw_landmarks(torch.Generator().manual_seed(3),
                         torch.full((n,), 1.0 / n), P)
    for label, kw in [("falkon_pcg", dict(solver="falkon_pcg")),
                      ("eigenpro", dict(solver="eigenpro")),
                      ("streaming", dict(backend="streaming"))]:
        t0 = time.perf_counter()
        c = cfg.replace(**kw)
        a = SketchedKRR(c.replace(backend=kw.get("backend", "torch"))).fit(
            Xtr, ytr, score_landmarks=idx)
        b = SketchedKRR(c.replace(backend="rounded")).fit(
            Xtr, ytr, score_landmarks=idx, sample=a.sample())
        ya, yb = a.predict(Xte), b.predict(Xte)
        ba, bb = a.state().beta, b.state().beta
        line = (f"{label}: beta {float(torch.linalg.norm(ba - bb) / torch.linalg.norm(bb)):.3e}, "
                f"predictions {float((ya - yb).abs().max() / yb.abs().max()):.3e}")
        if label == "streaming":
            sa, sb = a.scores(), b.scores()
            line += f", scores {float(((sa - sb).abs() / sb.abs()).max()):.3e}"
        it = getattr(a.state(), "iters", None)
        if it is not None:
            line += f", iterations {it} / {b.state().iters}"
        print(f"{line} ({time.perf_counter() - t0:.0f} s)", flush=True)
    Xt = torch.as_tensor(Xtr)
    kernel = cfg.kernel
    streamed = fast_ridge_leverage(
        kernel, Xt, LAM * cfg.eps, P, idx=idx,
        ops=tb.ops_for(kernel, "streaming", device="cpu"))
    dense = fast_ridge_leverage(kernel, Xt, LAM * cfg.eps, P, idx=idx,
                                ops=tb.ops_for(kernel, "torch", device="cpu"))
    rel = float(((streamed.scores - dense.scores).abs()
                 / dense.scores.abs()).max())
    print(f"streamed vs dense score pass, same landmarks, n={n}: max rel "
          f"{rel:.3e}", flush=True)


if __name__ == "__main__":
    main()
