"""The PyTorch port's ``KernelOps`` layer against the JAX ``xla`` backend.

The port's ``torch`` and ``hopper`` backends (the latter on the CPU, where
its kernel calls take their plain versions) run cross, columns, matvec,
rmatvec, leverage_scores and scores_given_gram for 4 kernels × {f32, f64}
at n = 301, p = 37 (tests/_torch_ops_cases.py), against the reference's
dense ``xla`` executor; tests/test_torch_backends_pallas.py does the same
against its ``pallas`` executor. Tolerances (tests/_torch_common.py):
1e-10 at float64; 2e-5 on float32 blocks and products, rtol 2e-4 on
float32 scores.
"""
import pytest
from _torch_common import DTYPES
from _torch_ops_cases import KERNELS, check_against_reference

from repro_torch.core import backends as tb


def test_registry_and_auto_resolution():
    assert tb.BACKENDS.available() == ("hopper", "streaming", "torch")
    assert tb.resolve_backend("auto", "cpu") == "torch"
    assert tb.resolve_backend("auto", "cuda") == "hopper"
    with pytest.raises(KeyError, match="available"):
        tb.resolve_backend("xla", "cpu")


@pytest.mark.parametrize("port_backend", ["torch", "hopper"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_ops_match_xla(name, dtype, port_backend):
    check_against_reference(name, dtype, port_backend, "xla")
