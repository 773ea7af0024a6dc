"""K2 ``rls_scores_fused``: l̃_i = B_i M B_iᵀ on the card (``csrc/rls_scores.cu``).

The Hopper counterpart of the Pallas kernel
``src/repro/kernels/rls_scores.py::rls_scores_fused``: given the p×p
inverse M = (BᵀB + nλI)^{-1}, one launch reads B once per column block of
M and writes one score per row; B·M is never written to device memory.

Accumulation follows the reference's rule (f64 in ⇒ f64, else f32;
``acc_dtype`` overrides); M is read in the accumulation dtype, as the
Pallas body casts it, and the scores come back in B's dtype. float32 data
with float32 accumulation runs on the tensor cores as 3xTF32 (each operand
split into a TF32 high part and the rest, three products summed in
float32), and only for p ≤ ``TF32X3_MAX_P``: on an H100 its scores sit
within 1.31e-5 (relative) of IEEE float32 at p = 2048, 15× inside the
float32 rtol 2e-4, but 2.5e-5 at p = 4096 and 5.0e-5 at p = 8192, growing
with p through the tensor cores' float32 accumulation, so a larger p is
refused and names the float64-accumulating build. float64 and the mixed
builds run IEEE fma on the CUDA cores. bf16 B with float32 accumulation
runs the same tensor-core body with two products (a bf16 value is a TF32
value exactly, so B has no low part): B·M_hi + B·M_lo, M kept in float32;
its scores come back in bf16, whose rounding (a relative step of 2⁻⁸)
is far above the tensor cores' accumulation error, so p is not limited in
that build (``chip_smoke.py`` phase ``limits`` measures it at p = 2048,
4096 and 8192). bf16 B with float64 accumulation runs SIMT fma.

This wrapper takes CUDA tensors only; ``repro_torch.kernels.ops`` sends
CPU tensors to the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from ..core.precision import to_dtype
from .rbf_block import (ACC_CODES, DTYPE_CODES, check_cuda, check_dtypes,
                        default_acc)

_INT32_MAX = 2**31 - 1
# the largest p at which the 3xTF32 build stays 10x inside the float32 rtol
# 2e-4 (measured on an H100 by chip_smoke.py phase k2: 1.31e-5 at p = 2048,
# 2.54e-5 at 4096, 4.96e-5 at 8192)
TF32X3_MAX_P = 2048


@functools.cache
def _entry():
    from . import _build
    lib = _build.library("rls_scores")
    fn = lib.rls_scores_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.rls_scores_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def rls_scores_fused(B: Tensor, M: Tensor, *, acc_dtype=None) -> Tensor:
    """l̃ = rowwise B M Bᵀ ∈ R^n in one launch of K2 (CUDA tensors only).

    B (n, p) contiguous float32, float64 or bf16, M (p, p) on the same
    device (cast to the accumulation dtype here — a p×p copy). Launches on
    the current stream and does not synchronise."""
    check_cuda("rls_scores", B, M)
    acc = default_acc(B.dtype) if acc_dtype is None else to_dtype(acc_dtype)
    check_dtypes("rls_scores", acc, B, M)
    if B.ndim != 2 or M.shape != (B.shape[1], B.shape[1]):
        raise ValueError(f"rls_scores needs B (n, p) and M (p, p), got "
                         f"{tuple(B.shape)} and {tuple(M.shape)}")
    if not B.is_contiguous():
        raise ValueError("rls_scores needs a contiguous B")
    n, p = B.shape
    if max(n, p) > _INT32_MAX:
        raise ValueError(f"rls_scores shape {(n, p)} exceeds int32")
    if B.dtype == torch.float32 and acc == torch.float32 and p > TF32X3_MAX_P:
        raise ValueError(
            f"rls_scores: the float32 build (3xTF32 on the tensor cores) is "
            f"measured within the float32 tolerance only up to p = "
            f"{TF32X3_MAX_P}, got p = {p}; pass acc_dtype=\"float64\" (in a "
            f"SketchConfig: Precision(accum_dtype=\"f64\")) for the IEEE "
            f"float64-accumulating build")
    M = M.to(acc).contiguous()
    out = torch.empty((n,), dtype=B.dtype, device=B.device)
    if n == 0:
        return out
    fn, err = _entry()
    code = fn(B.data_ptr(), M.data_ptr(), out.data_ptr(), n, p,
              DTYPE_CODES[B.dtype], ACC_CODES[acc], B.device.index,
              torch.cuda.current_stream(B.device).cuda_stream)
    if code:
        raise RuntimeError(f"rls_scores launch failed: "
                           f"{err(code).decode()} (cudaError {code})")
    rls_scores_fused.launches += 1
    return out


rls_scores_fused.launches = 0
