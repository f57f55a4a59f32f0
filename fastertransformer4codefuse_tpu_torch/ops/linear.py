"""Linear layers with weight-only int8/int4 dispatch (port of ops/linear.py).

A QuantizedTensor weight goes, with the bias and activation applied in the
kernel's epilogue, to K1 (int8, ``ops.quant_matmul``), K6 (int4 with
per-channel scales) or K7 (int4 with group scales, ``ops.quant_matmul_w4``):
the kernel for a CUDA tensor, its plain version for a CPU tensor. A stacked
weight's layer view ``w[l]`` is a free view, so the JAX package's stacked and
2-D variants are one entry here. The transposed int4 LM head goes to K8
(``quantized_matmul_transposed_head``). Dense weights are a plain matmul, as
the JAX package left them to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.params import QuantizedTensor

# activation name -> code shared with csrc/ftcf_common.cuh (enum Act)
ACT_CODES = {None: 0, "gelu": 1, "gelu-tanh": 2, "relu": 3, "silu": 4}


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """Exact gelu, tanh-approximate gelu, relu or silu (the JAX apply_act)."""
    if act == "gelu":
        return F.gelu(y)
    if act == "gelu-tanh":
        return F.gelu(y, approximate="tanh")
    if act == "relu":
        return torch.relu(y)
    if act == "silu":
        return F.silu(y)
    raise ValueError(f"unknown activation {act!r}")


def quantized_matmul(
    x: torch.Tensor,
    w: QuantizedTensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
) -> torch.Tensor:
    """``act(x @ w + bias)`` for a per-layer quantized kernel ``w`` [K, ...out]
    (k_axis 0): int8 per-channel -> K1, int4 per-channel -> K6, int4
    group-wise -> K7."""
    from .quant_matmul import quant_matmul
    from .quant_matmul_w4 import quant_matmul_w4, quant_matmul_w4_group

    if w.k_axis % w.q.ndim != 0:
        raise ValueError("expected a per-layer kernel [K, ...] with k_axis 0")
    if w.bits == 8 and w.group_size:
        raise NotImplementedError("group-wise int8 weights are not on a served path")
    K = w.shape[0]
    x2d = x.reshape(-1, K).contiguous()
    q2d = w.q.reshape(w.q.shape[0], -1)
    b = None if bias is None else bias.reshape(-1)
    if w.bits == 8:
        y = quant_matmul(x2d, q2d, w.scale.reshape(-1), bias=b, act=act)
    elif w.group_size:
        y = quant_matmul_w4_group(x2d, q2d, w.scale.reshape(w.scale.shape[0], -1),
                                  w.group_size, bias=b, act=act)
    else:
        y = quant_matmul_w4(x2d, q2d, w.scale.reshape(-1), bias=b, act=act)
    return y.reshape(x.shape[:-1] + w.q.shape[1:])


def quantized_matmul_transposed_head(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """fp32 logits ``x @ w`` [M, V_pad] against the transposed per-channel
    int4 LM head ``w`` [H/2, V_pad] (k_axis 0): K8."""
    from .quant_matmul_w4 import quant_matmul_w4_head

    if w.k_axis % w.q.ndim != 0 or w.q.ndim != 2:
        raise ValueError("expected a transposed head [K, V_pad] with k_axis 0")
    if w.bits != 4 or w.group_size:
        raise NotImplementedError(
            "only the per-channel int4 transposed head is served; the group-wise head "
            "(JAX linear.py:267-275) is ROADMAP queue 1 item 11"
        )
    return quant_matmul_w4_head(x.contiguous(), w.q, w.scale)


def linear(
    x: torch.Tensor,
    w,
    b: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
) -> torch.Tensor:
    """``y = act(x @ w + b)``; ``w`` a dense [K, ...out] tensor or a per-layer
    QuantizedTensor."""
    if isinstance(w, QuantizedTensor):
        y = quantized_matmul(x, w, bias=b, act=act)
    else:
        w2d = w.reshape(w.shape[0], -1)
        y = (x.reshape(-1, x.shape[-1]).float() @ w2d.float()).to(x.dtype)
        y = y.reshape(x.shape[:-1] + w.shape[1:])
        if b is not None:
            y = y + b.to(y.dtype)
        if act is not None:
            y = apply_act(y, act)
    return y
