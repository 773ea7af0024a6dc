"""On the card: how far float32 falkon_pcg's β is determined at the MSD cell.

    python3 tools/falkon_beta_probe.py      # from the repo root, one CUDA GPU

The parity fits of ``chip_smoke.py`` phase ``iter`` (f): the first 20,000
MSD-shaped rows, SketchConfig(RBFKernel(6.0), p=2048, lam=1e-6), the same
score landmarks and column draw for ``hopper`` and ``torch``. For
falkon_pcg at the default solver_iters (100) and at 300, and for eigenpro
and the streaming backend, it prints hopper-vs-torch differences of the
test and training predictions (max |Δ| over the largest value) and of β
(relative l2), the iterations and the last residuals; for falkon_pcg also
each β against the direct float32 nystrom_regularized β (torch) with the
same draws. Prints only; nothing is checked.
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.api import RBFKernel, SketchConfig, SketchedKRR  # noqa: E402
from repro_torch.core.leverage import draw_landmarks  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def _rel(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _max_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main() -> None:
    resolve_device("cuda")
    Xtr, ytr, Xte, _ = cs._msd_data()
    n = cs.N_PARITY
    Xp, yp, Xq = Xtr[:n], ytr[:n], Xte[:cs.N_PARITY_TEST]
    idx = draw_landmarks(torch.Generator().manual_seed(3),
                         torch.full((n,), 1.0 / n), cs.P)
    cfg = SketchConfig(RBFKernel(cs.BANDWIDTH), p=cs.P, lam=cs.LAM)
    for label, kw in [("falkon_pcg", dict(solver="falkon_pcg")),
                      ("falkon_pcg, solver_iters 300",
                       dict(solver="falkon_pcg", solver_iters=300)),
                      ("eigenpro", dict(solver="eigenpro")),
                      ("streaming", dict(backend="streaming"))]:
        c1 = cfg.replace(**kw)
        hop = SketchedKRR(c1.replace(backend=kw.get("backend", "hopper"))
                          ).fit(Xp, yp, score_landmarks=idx)
        plain = SketchedKRR(c1.replace(backend="torch")).fit(
            Xp, yp, score_landmarks=idx, sample=hop.sample())
        b_h, b_t = hop.state().beta, plain.state().beta
        line = (f"{label}: predictions {_max_rel(hop.predict(Xq), plain.predict(Xq)):.3e}, "
                f"train {_max_rel(hop.predict(Xp), plain.predict(Xp)):.3e}, "
                f"beta {_rel(b_h, b_t):.3e}")
        st = hop.state()
        if hasattr(st, "iters"):
            line += (f", iterations {st.iters} / {plain.state().iters}, "
                     f"last residuals {[float(r) for r in st.residuals[-3:]]}"
                     f" / {[float(r) for r in plain.state().residuals[-3:]]}")
        print(line, flush=True)
        if label.startswith("falkon"):
            direct = SketchedKRR(cfg.replace(
                solver="nystrom_regularized", backend="torch")).fit(
                Xp, yp, score_landmarks=idx, sample=hop.sample())
            b_d = direct.state().beta
            print(f"  beta vs the direct float32 beta: hopper "
                  f"{_rel(b_h, b_d):.3e}, torch {_rel(b_t, b_d):.3e}",
                  flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
