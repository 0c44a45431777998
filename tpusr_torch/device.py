"""Device resolution for the port's entry points.

Entry points run on the card unless the caller passes ``device="cpu"``. With
no card and no explicit device they raise: the port never carries on quietly
on the CPU. Every resolution also turns TF32 off, so float32 means fp32 math
in cuDNN convolutions and cuBLAS matmuls alike.
"""

from __future__ import annotations

import torch


def fp32_math() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``device`` or, when None, the current CUDA device; raises when CUDA is
    asked for (explicitly or by default) and none is available."""
    fp32_math()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpusr_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
