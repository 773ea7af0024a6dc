"""Helpers shared by the PyTorch port's tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX package
and the port, so the two compute on identical data. JAX stays on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

# f64: the bar tests/test_backends.py sets between the JAX backends; f32:
# the block / score tolerances of tests/test_kernels_pallas.py (the two
# frameworks sum in different orders)
F64_TOL = dict(rtol=1e-10, atol=1e-10)
F32_BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)
F32_SCORE_TOL = dict(rtol=2e-4, atol=1e-6)

DTYPES = ["float32", "float64"]

# the tests' tensors are small: one thread, so that a test worker does not
# take cores from the other workers of a parallel run
torch.set_num_threads(1)


def tol(dtype: str, scores: bool = False) -> dict:
    if dtype == "float64":
        return F64_TOL
    return F32_SCORE_TOL if scores else F32_BLOCK_TOL


def normal(shape, seed: int, dtype: str = "float64",
           scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(dtype)


def t(a, device: str = "cpu") -> torch.Tensor:
    """A numpy (or JAX) array as a torch tensor of the same dtype."""
    return torch.as_tensor(np.array(a), device=device)


def n(a) -> np.ndarray:
    """A torch tensor or JAX array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def close(got, want, **kw) -> None:
    np.testing.assert_allclose(n(got), n(want), **kw)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: the test needs the card and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the chip)")
    return torch.device("cuda")
