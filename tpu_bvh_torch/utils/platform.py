"""Device dispatch: the kernel path for CUDA tensors, the plain path for CPU.

Every op that has a hand-written kernel asks `on_cuda` about its input.
A CUDA tensor always launches the kernel (or the launch raises); a CPU
tensor always takes the plain PyTorch version. There is no size gate and
no fallback.
"""
from __future__ import annotations

import torch


def on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; other devices raise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")
