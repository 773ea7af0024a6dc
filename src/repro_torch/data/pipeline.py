"""Synthetic regression data for the port (numpy, made from a seed).

``pumadyn_like`` is the reference's pumadyn-style nonlinear regression
surrogate, bit for bit, with the input width as an argument so the same
generator can stand in at other widths (d = 90 for the YearPredictionMSD
shape the chip run uses).
"""
from __future__ import annotations

import numpy as np


def pumadyn_like(n: int, dim: int = 32, seed: int = 0, noise: float = 0.1,
                 nonlinear: bool = True) -> dict[str, np.ndarray]:
    """Pumadyn-style robot-dynamics regression surrogate (``dim`` inputs):
    f* = tanh(X W1) w2 normalized to unit variance, y = f* + noise·ξ."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, dim))
    w1 = rng.standard_normal((dim, 16)) / np.sqrt(dim)
    w2 = rng.standard_normal(16)
    if nonlinear:
        f_star = np.tanh(X @ w1) @ w2
    else:
        f_star = X @ w1[:, 0]
    f_star = f_star / np.std(f_star)
    y = f_star + noise * rng.standard_normal(n)
    return {"x": X, "f_star": f_star, "y": y, "noise": noise}
