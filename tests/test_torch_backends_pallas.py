"""The PyTorch port's ``KernelOps`` layer against the JAX ``pallas`` backend
(its Pallas kernels in interpret mode): the cells of
tests/test_torch_backends.py, held against the reference's tiled executor.
Tolerances (tests/_torch_common.py): 1e-10 at float64; 2e-5 on float32
blocks and products, rtol 2e-4 on float32 scores.
"""
import pytest
from _torch_common import DTYPES
from _torch_ops_cases import KERNELS, check_against_reference


@pytest.mark.parametrize("port_backend", ["torch", "hopper"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_ops_match_pallas(name, dtype, port_backend):
    check_against_reference(name, dtype, port_backend, "pallas")
