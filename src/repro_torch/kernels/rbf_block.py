"""K1 ``kernel_block``: C = k(X, Z) on the card through ``csrc/kernel_block.cu``.

The Hopper counterpart of the Pallas kernel
``src/repro/kernels/rbf_block.py::kernel_block``: one launch computes the
whole (n, p) block of an rbf, linear or poly kernel, with the squared
norms and the epilogue fused into the tiled X·Zᵀ product (see the note at
the top of the CUDA source for the tiling and its bound).

Accumulation follows the reference's rule: float64 inputs accumulate in
float64, float32 and bf16 inputs in float32 (IEEE for float32 data, never
TF32); ``acc_dtype`` overrides it. float32 data with float32 accumulation
runs IEEE fma on the CUDA cores; bf16 data with float32 accumulation runs
on the bf16 tensor cores (``mma.sync`` m16n8k16, float32 accumulators:
bf16 products are exact in float32); float64 accumulation (float64 data,
or float32 or bf16 data with ``acc_dtype=float64``, as the sparse path's
W = k(Z, Z)) runs on the FP64 tensor cores (``mma.sync`` m16n8k8, IEEE
float64 fused multiply-adds). The tensor-core builds skip the products of
blocks whose values are all zero. The block comes back in the input dtype,
a bf16 block rounded once, to nearest even. Other dtypes (float16
included) raise before anything is built or launched.

This wrapper takes CUDA tensors only; ``repro_torch.kernels.ops`` sends
CPU tensors to the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from ..core.precision import to_dtype

KINDS = {"rbf": 0, "linear": 1, "poly": 2}
# the operand dtypes the kernels take, and the accumulation dtypes
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
ACC_CODES = {torch.float32: 0, torch.float64: 1}
_INT32_MAX = 2**31 - 1


def default_acc(dtype: torch.dtype) -> torch.dtype:
    """The reference's accumulation rule: f64 in ⇒ f64, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def check_cuda(name: str, *tensors: Tensor) -> None:
    """All operands CUDA tensors on one device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} launches on CUDA tensors of one device, "
                         f"got {[str(t.device) for t in tensors]}")


def check_dtypes(name: str, acc: torch.dtype, *tensors: Tensor) -> None:
    """float32, float64 or bf16 operands and a float32 or float64
    accumulator; anything else raises before a build or a launch."""
    for t in tensors:
        if t.dtype not in DTYPE_CODES:
            raise TypeError(
                f"{name} takes float32, float64 or bfloat16 operands, got "
                f"{t.dtype}")
    if acc not in ACC_CODES:
        raise TypeError(f"{name} accumulates in float32 or float64, got "
                        f"{acc}")


@functools.cache
def _entry():
    from . import _build
    lib = _build.library("kernel_block")
    fn = lib.kernel_block_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_double,
                   ctypes.c_double, ctypes.c_double, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.kernel_block_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def kernel_block(X: Tensor, Z: Tensor, *, kind: str = "rbf",
                 bandwidth: float = 1.0, degree: int = 2, scale: float = 1.0,
                 offset: float = 1.0, acc_dtype=None) -> Tensor:
    """C = k(X, Z) ∈ R^{n×p} in one launch of K1 (CUDA tensors only).

    X (n, d) and Z (p, d) are contiguous float32, float64 or bf16 tensors
    of one dtype on one CUDA device; ``acc_dtype`` (float32 or float64)
    overrides the accumulation rule. Launches on the current stream and
    does not synchronise.
    """
    check_cuda("kernel_block", X, Z)
    acc = default_acc(X.dtype) if acc_dtype is None else to_dtype(acc_dtype)
    check_dtypes("kernel_block", acc, X, Z)
    if kind not in KINDS:
        raise ValueError(f"unsupported kind {kind!r}; one of {sorted(KINDS)}")
    if X.dtype != Z.dtype:
        raise TypeError(f"kernel_block needs one dtype, got {X.dtype} and "
                        f"{Z.dtype}")
    if X.ndim != 2 or Z.ndim != 2 or X.shape[1] != Z.shape[1]:
        raise ValueError(f"kernel_block needs X (n, d) and Z (p, d), got "
                         f"{tuple(X.shape)} and {tuple(Z.shape)}")
    if not (X.is_contiguous() and Z.is_contiguous()):
        raise ValueError("kernel_block needs contiguous X and Z")
    if kind == "poly" and int(degree) < 0:
        raise ValueError(f"poly degree must be >= 0, got {degree}")
    n, d = X.shape
    p = Z.shape[0]
    if max(n, p, d) > _INT32_MAX:
        raise ValueError(f"kernel_block shape {(n, p, d)} exceeds int32")
    out = torch.empty((n, p), dtype=X.dtype, device=X.device)
    if n == 0 or p == 0:
        return out
    fn, err = _entry()
    code = fn(X.data_ptr(), Z.data_ptr(), out.data_ptr(), n, p, d,
              DTYPE_CODES[X.dtype], ACC_CODES[acc], KINDS[kind],
              2.0 * float(bandwidth) ** 2, float(scale), float(offset),
              int(degree), X.device.index,
              torch.cuda.current_stream(X.device).cuda_stream)
    if code:
        raise RuntimeError(f"kernel_block launch failed: "
                           f"{err(code).decode()} (cudaError {code})")
    kernel_block.launches += 1
    return out


kernel_block.launches = 0
