"""K6, K7 and K8: W4A16 weight-only matmuls over nibble-packed int4 weights.

Port of ops/quant_matmul_w4.py. The packed weight is [K/2, N] int8, logical
row 2i in the low nibble of byte row i and row 2i+1 in the high nibble
(``models.params.QuantizedTensor``). As for K1, a layer's view of the stacked
weight is free, so the JAX package's stacked and 2-D forms are one entry here:

- K6 ``quant_matmul_w4`` (``quant_matmul_w4_pallas_stacked``): per-channel
  fp32 scales [N], ``act(x @ W * scale + bias)``, bf16 out;
- K7 ``quant_matmul_w4_group`` (``quant_matmul_w4_group_stacked``): group
  scales [K/G, N] inside the contraction, ``act(x @ (W * scale) + bias)``,
  bf16 out; the scales are bf16, or fp32 as the JAX package stores them
  under ``FTCF_GSCALE_BF16=0`` (a kernel instance of each, no conversion).
  With ``out_dtype=torch.float32`` it is the group-wise transposed int4 LM
  head [H/2, V_pad] (JAX ``ops/linear.py:267-286``: on the TPU that head
  rides the stacked group kernel as a one-layer stack), counted also in
  ``launches_head``;
- K8 ``quant_matmul_w4_head`` (``quant_matmul_w4_pallas`` as the int4 LM head
  uses it): K6 with fp32 out and no bias.

The CUDA is ``csrc/quant_matmul_w4.cu``: a weight-streaming GEMV at decode
widths (M <= 32) and the TMA + wgmma GEMM of ``csrc/ftcf_gemm.cuh`` above, each
under its launch plan from the tile cache (``ops/tile_tuning.py``). Each ``*_plain`` function is the
same math in plain PyTorch (unpack to int8, dequantize in fp32, contract in
fp32, bias and activation in fp32, one rounding to the output dtype): the CPU
path and the kernel's oracle.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.params import QuantizedTensor
from . import _cuda
from .linear import ACT_CODES, apply_act
from .quant_matmul import GEMV_MAX_M, check_operands, gemm_plan, gemv_splits, kernel_name


def _plain(x, packed, scale, G, bias, act, out_dtype):
    w = QuantizedTensor(q=packed, scale=scale, k_axis=-2, group_size=G, bits=4)
    y = x.float() @ w.dequantize()
    if bias is not None:
        y = y + bias.float()
    if act is not None:
        y = apply_act(y, act)
    return y.to(out_dtype)


def quant_matmul_w4_plain(x, packed, scale, bias=None, act=None):
    return _plain(x, packed, scale, 0, bias, act, x.dtype)


def quant_matmul_w4_group_plain(x, packed, scale, G, bias=None, act=None):
    return _plain(x, packed, scale, G, bias, act, x.dtype)


def quant_matmul_w4_head_plain(x, packed, scale):
    return _plain(x, packed, scale, 0, None, None, torch.float32)


def launch_w4(x, packed, scale, G, bias, act, out, name):
    """One K6/K7/K8 launch into ``out`` (bf16 or fp32): the weight-streaming
    GEMV for M <= 32, the GEMM above, each under its plan from the tile
    cache (``gemv_splits``, ``gemm_plan``). Operands already checked; no
    launch count (the public wrappers count their own)."""
    M, K = x.shape
    N = packed.shape[1]
    lib = _cuda.lib()
    gscale = scale.data_ptr() if G else None
    gscale_f32 = int(bool(G) and scale.dtype == torch.float32)
    pscale = None if G else scale.data_ptr()
    bias_args = (_cuda.ptr(bias), int(bias is not None and bias.dtype == torch.bfloat16),
                 ACT_CODES[act])
    out_f32 = int(out.dtype == torch.float32)
    if M <= GEMV_MAX_M:
        [(splits, chunk)] = gemv_splits(kernel_name("gemv", 4, G, scale), M, [(K, N, 1.0)],
                                        x.device, 4, G)
        ws = torch.empty(splits * M * N, dtype=torch.float32, device=x.device)
        err = lib.ftcf_quant_matmul_w4_gemv(
            x.data_ptr(), packed.data_ptr(), pscale, gscale, gscale_f32, G, M, K, N, splits,
            chunk,
            *bias_args,
            out.data_ptr(), out_f32, ws.data_ptr(), _cuda.stream_of(x),
        )
    else:
        plan = gemm_plan(kernel_name("gemm", 4, G, scale), M, K, N, G, x.device)
        err = lib.ftcf_quant_matmul_w4_gemm(
            x.data_ptr(), packed.data_ptr(), pscale, gscale, gscale_f32, G, M, K, N, *bias_args,
            out.data_ptr(), out_f32, *plan.args(), _cuda.stream_of(x),
        )
    _cuda.check(err, name)
    return out


def _run(x, packed, scale, G, bias, act, out_dtype, name):
    check_operands(x, packed, scale, bias, name, bits=4, group_size=G)
    _cuda.require(act in ACT_CODES, f"{name}: unknown activation {act!r}")
    y = torch.empty(x.shape[0], packed.shape[1], dtype=out_dtype, device=x.device)
    return launch_w4(x, packed, scale, G, bias, act, y, name)


def quant_matmul_w4(
    x: torch.Tensor,  # [M, K] bf16
    packed: torch.Tensor,  # [K/2, N] int8 (a layer's view of the stacked weight)
    scale: torch.Tensor,  # [N] fp32
    bias: Optional[torch.Tensor] = None,  # [N] bf16 or fp32
    act: Optional[str] = None,
) -> torch.Tensor:
    """K6: ``act(x @ unpack(packed) * scale + bias)``, [M, N] in x's dtype. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if not x.is_cuda:
        return quant_matmul_w4_plain(x, packed, scale, bias, act)
    y = _run(x, packed, scale, 0, bias, act, torch.bfloat16, "quant_matmul_w4")
    quant_matmul_w4.launches += 1
    return y


def quant_matmul_w4_group(
    x: torch.Tensor,  # [M, K] bf16
    packed: torch.Tensor,  # [K/2, N] int8
    scale: torch.Tensor,  # [K/G, N] bf16 or fp32
    G: int,
    bias: Optional[torch.Tensor] = None,  # [N] bf16 or fp32
    act: Optional[str] = None,
    out_dtype=None,
) -> torch.Tensor:
    """K7: ``act(x @ (unpack(packed) * scale[k // G]) + bias)``, [M, N] in
    ``out_dtype`` (x's dtype by default; fp32 for the LM head); each
    group's scale applies inside the contraction. fp32 scales take their
    own instance (counted also in ``launches_f32``)."""
    if not x.is_cuda:
        return _plain(x, packed, scale, G, bias, act, out_dtype or x.dtype)
    _cuda.require(G > 0, "quant_matmul_w4_group: needs a group size G > 0")
    _cuda.require(out_dtype in (None, torch.bfloat16, torch.float32),
                  f"quant_matmul_w4_group: out_dtype bf16 or fp32, got {out_dtype}")
    y = _run(x, packed, scale, G, bias, act, out_dtype or torch.bfloat16,
             "quant_matmul_w4_group")
    quant_matmul_w4_group.launches += 1
    quant_matmul_w4_group.launches_f32 += scale.dtype == torch.float32
    quant_matmul_w4_group.launches_head += y.dtype == torch.float32
    return y


def quant_matmul_w4_head(
    x: torch.Tensor,  # [M, H] bf16
    packed: torch.Tensor,  # [H/2, V_pad] int8, the transposed int4 LM head
    scale: torch.Tensor,  # [V_pad] fp32
) -> torch.Tensor:
    """K8: fp32 logits ``x @ unpack(packed) * scale``, [M, V_pad]."""
    if not x.is_cuda:
        return quant_matmul_w4_head_plain(x, packed, scale)
    y = _run(x, packed, scale, 0, None, None, torch.float32, "quant_matmul_w4_head")
    quant_matmul_w4_head.launches += 1
    return y


quant_matmul_w4.launches = 0
quant_matmul_w4_group.launches = 0
quant_matmul_w4_group.launches_f32 = 0  # of them, with fp32 group scales
quant_matmul_w4_group.launches_head = 0  # of them, fp32 out: the group-wise transposed head
quant_matmul_w4_head.launches = 0
