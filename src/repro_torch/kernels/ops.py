"""Dispatch between the hand-written kernels and their plain versions.

A tensor on the CPU goes to the plain PyTorch version in ``ref`` (under the
kernel's own accumulation rule, so both routes compute the same function).
A CUDA tensor goes to the kernel, which launches or raises — there is no
fallback. Any other device raises.
"""
from __future__ import annotations

import torch
from torch import Tensor

from ..core.precision import to_dtype
from . import ref
from .flash_attention import attention_shapes, flash_attention
from .rbf_block import default_acc, kernel_block
from .rls_scores import rls_scores_fused
from .sparse_block import SparseLandmarks, prepare_landmarks, sparse_cross


def _on_cuda(*tensors: Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; anything else raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel route for device {dev}")
    return dev.type == "cuda"


def _acc(dtype: torch.dtype, acc_dtype) -> torch.dtype:
    return default_acc(dtype) if acc_dtype is None else to_dtype(acc_dtype)


def _block(X: Tensor, Z: Tensor, kind: str, acc_dtype, plain, **params):
    if _on_cuda(X, Z):
        return kernel_block(X.contiguous(), Z.to(X.dtype).contiguous(),
                            kind=kind, acc_dtype=acc_dtype, **params)
    acc = _acc(X.dtype, acc_dtype)
    return plain(X.to(acc), Z.to(acc)).to(X.dtype)


def rbf_block(X: Tensor, Z: Tensor, *, bandwidth: float = 1.0,
              acc_dtype=None) -> Tensor:
    return _block(X, Z, "rbf", acc_dtype,
                  lambda x, z: ref.rbf_block_ref(x, z, bandwidth),
                  bandwidth=bandwidth)


def linear_block(X: Tensor, Z: Tensor, *, acc_dtype=None) -> Tensor:
    return _block(X, Z, "linear", acc_dtype, ref.linear_block_ref)


def poly_block(X: Tensor, Z: Tensor, *, degree: int = 2, scale: float = 1.0,
               offset: float = 1.0, acc_dtype=None) -> Tensor:
    return _block(X, Z, "poly", acc_dtype,
                  lambda x, z: ref.poly_block_ref(x, z, degree, scale, offset),
                  degree=degree, scale=scale, offset=offset)


def rls_scores(B: Tensor, M: Tensor, *, acc_dtype=None) -> Tensor:
    """Fused rowwise l̃_i = B_i M B_iᵀ (eq. 9 given M = (BᵀB + nλI)^{-1})."""
    if _on_cuda(B, M):
        return rls_scores_fused(B.contiguous(), M, acc_dtype=acc_dtype)
    acc = _acc(B.dtype, acc_dtype)
    return ref.rls_scores_ref(B.to(acc), M.to(acc)).to(B.dtype)


def sparse_block(data: Tensor, indices: Tensor, indptr: Tensor, Z: Tensor,
                 *, kind: str = "rbf", bandwidth: float = 1.0,
                 degree: int = 2, scale: float = 1.0, offset: float = 1.0,
                 acc_dtype=None,
                 prepared: SparseLandmarks | None = None) -> Tensor:
    """CSR kernel block k(X_csr, Z) for ``kind`` ∈ {rbf, linear, poly}, in
    the result dtype ``promote(data, Z)``, accumulating in ``acc_dtype``
    (default: the result dtype). CUDA operands launch K3 ``sparse_cross``
    (epilogue fused) against ``prepared`` (``sparse_landmarks`` of Z, made
    here when None); CPU operands take the unfused plain version."""
    out = torch.promote_types(data.dtype, Z.dtype)
    if _on_cuda(data, indices, indptr, Z):
        return sparse_cross(data.to(out).contiguous(), indices.contiguous(),
                            indptr.contiguous(), Z.to(out).contiguous(),
                            kind=kind, bandwidth=bandwidth, degree=degree,
                            scale=scale, offset=offset, acc_dtype=acc_dtype,
                            prepared=prepared)
    acc = out if acc_dtype is None else to_dtype(acc_dtype)
    return ref.sparse_kernel_block_ref(
        data, indices, indptr, Z, kind=kind, bandwidth=bandwidth,
        degree=degree, scale=scale, offset=offset, acc_dtype=acc)


def sparse_landmarks(Z: Tensor, data_dtype: torch.dtype, *,
                     acc_dtype=None) -> SparseLandmarks | None:
    """Z prepared once for K3 against CSR blocks whose values are
    ``data_dtype`` (``sparse_block`` then computes in ``promote(data, Z)``,
    accumulating in ``acc_dtype``, default that dtype); None for CPU
    landmarks, whose plain version needs no preparation."""
    if not _on_cuda(Z):
        return None
    out = torch.promote_types(data_dtype, Z.dtype)
    acc = out if acc_dtype is None else to_dtype(acc_dtype)
    return prepare_landmarks(Z.to(out), acc)


class _Attention(torch.autograd.Function):
    """K4 under autograd, the reference's ``custom_vjp``: the forward is K4
    on CUDA operands (launched on detached copies of the views, so the
    wrapper's refusal of grad-requiring operands stays for direct calls)
    and its plain version on CPU ones; the backward recomputes through
    ``ref.attention_ref`` and differentiates that, as the reference's
    ``_bwd`` does."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, causal: bool,
                window: int, scale: float) -> Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        q, k, v = q.detach(), k.detach(), v.detach()
        if _on_cuda(q, k, v):
            return flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window, scale=scale)
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)

    @staticmethod
    def backward(ctx, grad: Tensor):
        need = ctx.needs_input_grad[:3]
        ins = [t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ref.attention_ref(*ins, scale=ctx.scale or None,
                                    causal=ctx.causal, window=ctx.window)
            got = iter(torch.autograd.grad(
                out, [t for t in ins if t.requires_grad], grad))
        return (*(next(got) if n else None for n in need), None, None, None)


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window: int = 0, scale: float = 0.0) -> Tensor:
    """Exact GQA softmax attention, q (B, Hq, S, D) against k, v
    (B, Hkv, S, D) → (B, Hq, S, D) in q's dtype; ``window > 0`` is a
    sliding window, ``scale = 0`` means 1/√D. The Pallas wrapper's shape
    contract holds on both routes (``attention_shapes``). CUDA operands
    launch K4 ``flash_attention``; CPU operands take its plain version.
    Differentiable: the backward recomputes through ``ref.attention_ref``
    (``_Attention``)."""
    attention_shapes(q, k, v)
    return _Attention.apply(q, k, v, causal, int(window), float(scale))


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {"kernel_block": kernel_block.launches,
            "rls_scores": rls_scores_fused.launches,
            "sparse_cross": sparse_cross.launches,
            "flash_attention": flash_attention.launches}


def reset_launch_counts() -> None:
    kernel_block.launches = 0
    rls_scores_fused.launches = 0
    sparse_cross.launches = 0
    flash_attention.launches = 0
