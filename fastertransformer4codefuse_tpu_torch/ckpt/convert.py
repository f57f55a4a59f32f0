"""Checkpoint conversion helpers (port of ckpt/convert.py, the part the
encoder families use).

Only ``_np`` and ``stack_layers`` are here. The HF GPT-NeoX converter
(``config_from_hf``, ``params_from_hf_state_dict``, the QKV reorders) and the
reference's ``.bin`` writer are ROADMAP queue 1 item 9.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import torch_dtype


def _np(x) -> np.ndarray:
    """torch.Tensor | np.ndarray -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def stack_layers(fn, num_layers: int, dtype, device) -> torch.Tensor:
    """Stack the per-layer numpy tensors ``fn(i)`` into one [L, ...] tensor of
    ``dtype`` on ``device``."""
    stacked = torch.from_numpy(np.ascontiguousarray(np.stack([fn(i) for i in range(num_layers)])))
    return stacked.to(device=torch.device(device), dtype=torch_dtype(dtype))
