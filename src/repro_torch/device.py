"""Device resolution: every entry point runs on the card unless asked not to.

``resolve_device("cuda")`` raises when no CUDA device is present — the port
never carries on silently on the CPU. Resolving a CUDA device also pins the
float32 matmul rule the kernels are held to: IEEE float32, no TF32, for
cuBLAS and cuDNN alike (the plain paths that the hand-written kernels are
compared against must not round their products to TF32's 10-bit mantissa).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA requests need a visible GPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was asked for but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: "
                         "use 'cuda' or 'cpu'")
    return dev
