"""The device the port's constructors build on.

Every entry point runs on the card unless the caller names another device:
``device=None`` means CUDA, and without a CUDA device it raises instead of
building on the CPU. Tests and tools that want the CPU pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is the current CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds on the card by default; pass device='cpu' "
            "to build on the CPU"
        )
    return torch.device("cuda")
