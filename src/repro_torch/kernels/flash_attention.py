"""K4 ``flash_attention``: exact softmax attention on the card (``csrc/flash_attention.cu``).

The Hopper counterpart of the Pallas kernel
``src/repro/kernels/flash_attention.py::_flash_fwd_kernel`` (through
``_flash_fwd`` and ``flash_attention``): the forward pass of causal /
sliding-window / GQA attention with an online softmax, the running max,
normaliser and accumulator in float32, fully masked key tiles skipped, and
the output in q's dtype. Query head h reads KV head h // (Hq / Hkv) through
the kernel's own indexing; K and V are never broadcast in device memory.

bfloat16 operands run on the tensor cores (``wgmma``, K/V tiles brought in
by TMA): both products take bf16 operands with float32 sums, and the
softmax weights P are rounded to bf16 for P·V, so an output o_id moves
from the plain version by at most 2⁻⁸·Σ_j p_ij|v_jd|/l_i beyond one bf16
rounding. float32 operands run the SIMT kernel in IEEE float32.

The shape contract is the Pallas wrapper's: a query block of
``min(256, S)`` rows, so S ≤ 256 is any length and a longer S must be a
multiple of 256 (``attention_shapes`` raises otherwise, on either route).
float32 and bfloat16 operands, head dims 32, 64, 112 (zamba2-7b's shared
attention; the bf16 instance runs the 128 tiles over the real 112-wide
rows, TMA reading the missing columns as zeros, so nothing is copied) and
128; bf16 operands 16-byte aligned (TMA reads them).

This wrapper is the forward alone and takes CUDA tensors only. Gradients
go through ``repro_torch.kernels.ops.attention``: its autograd Function
launches this wrapper on detached operands and, as the reference's
``_bwd`` does, differentiates the plain ``ref.attention_ref`` in the
backward (the reference has no backward kernel). Operands that require
grad raise here, so that no caller drops the gradient silently. ``ops``
also sends CPU tensors to ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

BLOCK = 256                      # the Pallas wrapper's bq = bk default
HEAD_DIMS = (32, 64, 112, 128)   # the kernel's template instances
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BF16_ROWS = 192                  # query rows per block of the bf16 instance
# gridDim.y carries B·Hq in the float32 instance and the query tiles in the
# bf16 one (whose B·Hq rides on gridDim.x)
_GRID_Y_MAX = 65_535


def attention_shapes(q: Tensor, k: Tensor,
                     v: Tensor) -> tuple[int, int, int, int, int]:
    """(B, Hq, Hkv, S, D) of q (B, Hq, S, D) and k, v (B, Hkv, S, D), or a
    ``ValueError``: mismatched shapes, Hq not a multiple of Hkv, or an S
    the Pallas wrapper refuses (S > 256 and not a multiple of 256)."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"attention needs q (B, Hq, S, D) and k, v "
                         f"(B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D):
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         "differ in batch, length or head dim")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} "
                         "KV heads")
    bq = min(BLOCK, S)
    if S and S % bq:
        raise ValueError(f"S={S} must divide block sizes ({bq}, {bq})")
    return B, Hq, Hkv, S, D


@functools.cache
def _entry():
    from . import _build
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_double, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.flash_attention_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, scale: float = 0.0) -> Tensor:
    """softmax(mask(q·kᵀ·scale))·v in one launch of K4 (CUDA tensors only).

    q (B, Hq, S, D), k and v (B, Hkv, S, D): contiguous, one dtype (float32
    or bfloat16), one CUDA device. ``window > 0`` keeps keys with
    q − k < window; ``scale = 0`` means 1/√D. Launches on the current
    stream and does not synchronise."""
    from .rbf_block import check_cuda   # not at import: rbf_block imports core
    check_cuda("flash_attention", q, k, v)
    B, Hq, Hkv, S, D = attention_shapes(q, k, v)
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 "
                        f"operands of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention is built for head dims "
                         f"{HEAD_DIMS}, got {D}")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is the forward alone: take "
                           "gradients through repro_torch.kernels.ops."
                           "attention, whose backward recomputes through "
                           "the plain version")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention reads bf16 operands with TMA and "
                         "needs them 16-byte aligned")
    if q.dtype == torch.float32:
        grid_y, what = B * Hq, "(batch, head) pairs"
    else:
        grid_y, what = -(-S // BF16_ROWS), f"query tiles of {BF16_ROWS} rows"
    if grid_y > _GRID_Y_MAX:
        raise ValueError(f"flash_attention takes at most {_GRID_Y_MAX} "
                         f"{what}, got {grid_y}")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    s = float(scale) or 1.0 / D**0.5
    fn, err = _entry()
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              B, Hq, Hkv, S, D, DTYPE_CODES[q.dtype], int(bool(causal)),
              int(window), s, q.device.index,
              torch.cuda.current_stream(q.device).cuda_stream)
    if code:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{err(code).decode()} (cudaError {code})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
