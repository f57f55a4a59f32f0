"""Linear layers with weight-only int8/int4 dispatch (port of ops/linear.py).

A QuantizedTensor weight goes, with the bias and activation applied in the
kernel's epilogue, to K1 (int8, per-channel or with fp32 group scales,
``ops.quant_matmul``), K6 (int4 with per-channel scales) or K7 (int4 with
group scales, ``ops.quant_matmul_w4``):
the kernel for a CUDA tensor, its plain version for a CPU tensor. A stacked
weight's layer view ``w[l]`` is a free view, so the JAX package's stacked and
2-D variants are one entry here. The transposed int4 LM head goes to K8, or
with group scales to K7 (``quantized_matmul_transposed_head``). Dense weights
are a plain matmul, as the JAX package left them to XLA.

SmoothQuant W8A8 (``RuntimeConfig.act_int8``, the reference's int8_mode=2):
``linear(..., act_int8=True)`` sends a sequence-wide call of at least
``A8_MIN_M`` rows on an int8 per-channel weight to ``w8a8_matmul``: per-token
int8 activations, an int8 x int8 product with int32 sums, then ``acc * s_x *
scale``, bias and activation. The JAX package computes this product in XLA,
outside any Pallas kernel; on the card it is ``torch._int_mm`` (cuBLASLt),
which counts its calls in ``w8a8_matmul.launches``. Decode-width calls, int4
and group-wise weights stay weight-only, as in the JAX package.
"""
from __future__ import annotations

import math
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


# Sequence-wide calls narrower than this stay weight-only (the JAX package's
# _A8_MIN_M): decode-width GEMMs are bound by the weight bytes.
A8_MIN_M = 16
# torch._int_mm on CUDA takes only more than this many rows: a call of
# A8_MIN_M rows is padded with zero rows
_INT_MM_MIN_M = 17


def a8_takes(x: torch.Tensor, w, act_int8: bool) -> bool:
    """Whether ``linear(x, w, act_int8=...)`` runs W8A8: int8 per-channel
    weights, a sequence width above 1 and at least A8_MIN_M rows."""
    return (bool(act_int8) and isinstance(w, QuantizedTensor) and w.bits == 8
            and not w.group_size and x.ndim >= 3 and x.shape[-2] > 1
            and math.prod(x.shape[:-1]) >= A8_MIN_M)


def quantize_per_token(x2d: torch.Tensor):
    """(int8 codes [M, K], fp32 scales [M]): s_x = amax / 127 over each row
    (1 for a zero row), codes round(x / s_x) half to even. Both divisions take
    a tensor divisor: CUDA computes a division by a Python scalar as a
    multiply by its reciprocal."""
    xf = x2d.float()
    amax = xf.abs().amax(dim=1)
    s_x = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    return torch.round(xf / s_x[:, None]).to(torch.int8), s_x


def int8_mm(x8: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int32 ``x8 @ q`` for int8 [M, K] and [K, N], exact: ``torch._int_mm``
    (on the CPU as it stands; on CUDA with rows padded to the 17 it takes,
    and K and N multiples of 8, else it raises). cuBLASLt's int8 product
    wants both operands K-major: on the card a row-major [K, N] weight is
    copied to [N, K] first (on an H100 at M = 3072, K = 5120, N = 15360 the
    product takes 0.52 ms on a K-major weight, 3.75 ms on a row-major one)."""
    if not x8.is_cuda:
        return torch._int_mm(x8.contiguous(), q)
    from . import _cuda

    M, K = x8.shape
    N = q.shape[1]
    _cuda.require(K % 8 == 0 and N % 8 == 0,
                  f"w8a8_matmul: torch._int_mm needs K and N multiples of 8, got {K}, {N}")
    if M < _INT_MM_MIN_M:
        x8 = torch.cat([x8, x8.new_zeros(_INT_MM_MIN_M - M, K)])
    acc = torch._int_mm(x8.contiguous(), q.t().contiguous().t())
    w8a8_matmul.launches += 1
    return acc[:M]


def w8a8_matmul(
    x2d: torch.Tensor,  # [M, K] float
    q: torch.Tensor,  # [K, N] int8, per-output-channel scales
    scale: torch.Tensor,  # [N]
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    out_dtype=None,
) -> torch.Tensor:
    """SmoothQuant W8A8: ``act((round(x / s_x) @ q) * s_x * scale + bias)``,
    s_x per token; the int32 sums times the two scales in fp32, rounded once
    to ``out_dtype`` (x's dtype by default), then bias and activation in it,
    as the JAX package's ``w8a8_matmul``."""
    x8, s_x = quantize_per_token(x2d)
    acc = int8_mm(x8, q)
    y = acc.float() * s_x[:, None] * scale.float()[None, :]
    y = y.to(out_dtype if out_dtype is not None else x2d.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if act is not None:
        y = apply_act(y, act)
    return y


w8a8_matmul.launches = 0


def quantized_matmul(
    x: torch.Tensor,
    w: QuantizedTensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
) -> torch.Tensor:
    """``act(x @ w + bias)`` for a per-layer quantized kernel ``w`` [K, ...out]
    (k_axis 0): int8 (per-channel or group-wise) -> K1, int4 per-channel ->
    K6, int4 group-wise -> K7."""
    from .quant_matmul import quant_matmul
    from .quant_matmul_w4 import quant_matmul_w4, quant_matmul_w4_group

    if w.k_axis % w.q.ndim != 0:
        raise ValueError("expected a per-layer kernel [K, ...] with k_axis 0")
    K = w.shape[0]
    x2d = x.reshape(-1, K).contiguous()
    q2d = w.q.reshape(w.q.shape[0], -1)
    b = None if bias is None else bias.reshape(-1)
    if w.bits == 8 and w.group_size:
        y = quant_matmul(x2d, q2d, w.scale.reshape(w.scale.shape[0], -1), bias=b, act=act,
                         group_size=w.group_size)
    elif w.bits == 8:
        y = quant_matmul(x2d, q2d, w.scale.reshape(-1), bias=b, act=act)
    elif w.group_size:
        y = quant_matmul_w4_group(x2d, q2d, w.scale.reshape(w.scale.shape[0], -1),
                                  w.group_size, bias=b, act=act)
    else:
        y = quant_matmul_w4(x2d, q2d, w.scale.reshape(-1), bias=b, act=act)
    return y.reshape(x.shape[:-1] + w.q.shape[1:])


def quantized_matmul_transposed_head(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """fp32 logits ``x @ w`` [M, V_pad] against the transposed int4 LM head
    ``w`` [H/2, V_pad] (k_axis 0): K8 with per-channel scales, K7 with fp32
    out with group scales [H/G, V_pad] (as the JAX package runs it on the
    TPU, JAX ``ops/linear.py:267-286``)."""
    from .quant_matmul_w4 import quant_matmul_w4_group, quant_matmul_w4_head

    if w.k_axis % w.q.ndim != 0 or w.q.ndim != 2:
        raise ValueError("expected a transposed head [K, V_pad] with k_axis 0")
    if w.bits != 4:
        raise NotImplementedError("the transposed LM head is served in int4 only")
    if w.group_size:
        return quant_matmul_w4_group(x.contiguous(), w.q, w.scale, w.group_size,
                                     out_dtype=torch.float32)
    return quant_matmul_w4_head(x.contiguous(), w.q, w.scale)


def linear(
    x: torch.Tensor,
    w,
    b: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    act_int8: bool = False,
) -> torch.Tensor:
    """``y = act(x @ w + b)``; ``w`` a dense [K, ...out] tensor or a per-layer
    QuantizedTensor. ``act_int8``: the call runs W8A8 where ``a8_takes``."""
    if a8_takes(x, w, act_int8):
        y = w8a8_matmul(x.reshape(-1, x.shape[-1]), w.q.reshape(w.q.shape[0], -1),
                        w.scale.reshape(-1), None if b is None else b.reshape(-1), act,
                        out_dtype=x.dtype)
        y = y.reshape(x.shape[:-1] + w.q.shape[1:])
    elif isinstance(w, QuantizedTensor):
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
