"""K2 and K3: the parallel-residual decode block's fused GEMMs.

Port of ops/quant_matmul_fused.py ``fused_up_proj_down`` (K2) and
``fused_proj_down`` (K3); CUDA in ``csrc/quant_matmul_fused.cu``. The weights
are a layer's views ([K, N] int8, or with ``bits=4`` the packed int4 [K/2, N];
[N] fp32 per-channel scales; [N] biases) instead of the stacked arrays plus a
layer index. The group-wise (G > 0) forms of the JAX kernels are not ported:
the JAX model sends group-wise layers to the unfused K7 (ROADMAP queue 2).

K2 is two launches from one wrapper: the up phase (K1's, or for int4 K6's,
weight-streaming GEMV with the activation) writes bf16 h to a scratch buffer,
then K3 computes the proj + down contraction with the residual and bias. Its
output is the layer output.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from ..models.params import unpack_int4
from .linear import ACT_CODES, apply_act
from .quant_matmul import check_operands, gemv_splits, launch_gemv
from .quant_matmul_w4 import launch_w4


def _contract(x, w, s, bits):
    """fp32 ``x @ w * s`` for an int8 or packed int4 [K(/2), N] weight."""
    q = unpack_int4(w, 0) if bits == 4 else w
    return (x.float() @ q.float()) * s.float()


def fused_proj_down_plain(x1, x2, w1, w2, s1, s2, bias, residual, bits=8):
    y = _contract(x1, w1, s1, bits) + _contract(x2, w2, s2, bits)
    return (y + bias.float() + residual.float()).to(x1.dtype)


def fused_proj_down(
    x1: torch.Tensor,  # [M, K1] attention output (contracts with proj)
    x2: torch.Tensor,  # [M, K2] activated FFN hidden (contracts with down)
    w1: torch.Tensor,  # [K1, N] int8
    w2: torch.Tensor,  # [K2, N] int8
    s1: torch.Tensor,  # [N] fp32
    s2: torch.Tensor,  # [N] fp32
    bias: torch.Tensor,  # [N] the pre-summed parallel bias
    residual: torch.Tensor,  # [M, N] the block input
    bits: int = 8,
) -> torch.Tensor:
    """K3: ``x1 @ w1 * s1 + x2 @ w2 * s2 + bias + residual`` -- the whole
    parallel-residual merge; its output is the layer output. ``bits=4``:
    both weights packed int4 [K/2, N] with per-channel scales."""
    if not x1.is_cuda:
        return fused_proj_down_plain(x1, x2, w1, w2, s1, s2, bias, residual, bits)
    check_operands(x1, w1, s1, bias, "fused_proj_down", bits=bits)
    check_operands(x2, w2, s2, None, "fused_proj_down", bits=bits)
    M, K1 = x1.shape
    K2, N = x2.shape[1], w2.shape[1]
    _cuda.require(w1.shape[1] == N and x2.shape[0] == M, "fused_proj_down: shapes disagree")
    _cuda.require(residual.dtype == torch.bfloat16 and residual.shape == (M, N)
                  and residual.is_contiguous() and residual.device == x1.device,
                  "fused_proj_down: residual must be a contiguous bf16 [M, N]")
    share1 = K1 / (K1 + K2)
    n1 = gemv_splits(K1, N, x1.device, share1, bits)
    n2 = gemv_splits(K2, N, x1.device, 1.0 - share1, bits)
    ws = torch.empty((n1 + n2) * M * N, dtype=torch.float32, device=x1.device)
    out = torch.empty(M, N, dtype=torch.bfloat16, device=x1.device)
    err = _cuda.lib().ftcf_fused_proj_down(
        bits, x1.data_ptr(), w1.data_ptr(), s1.data_ptr(), K1, n1,
        x2.data_ptr(), w2.data_ptr(), s2.data_ptr(), K2, n2, M, N,
        bias.data_ptr(), int(bias.dtype == torch.bfloat16), residual.data_ptr(),
        out.data_ptr(), ws.data_ptr(), _cuda.stream_of(x1),
    )
    _cuda.check(err, "fused_proj_down")
    fused_proj_down.launches += 1
    return out


fused_proj_down.launches = 0


def fused_up_proj_down_plain(
    x_up, x_proj, residual, w_up, w_proj, w_down, s_up, s_proj, s_down, b_up, b_down,
    act="gelu-tanh", bits=8,
):
    h = _contract(x_up, w_up, s_up, bits) + b_up.float()
    if act is not None:
        h = apply_act(h, act)
    h = h.to(x_up.dtype)  # the hidden is rounded to x's dtype before down
    return fused_proj_down_plain(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, residual,
                                 bits)


def fused_up_proj_down(
    x_up: torch.Tensor,  # [M, H] ln2 output
    x_proj: torch.Tensor,  # [M, H] attention output
    residual: torch.Tensor,  # [M, N] the block input
    w_up: torch.Tensor,  # [H, F] int8
    w_proj: torch.Tensor,  # [H, N] int8
    w_down: torch.Tensor,  # [F, N] int8
    s_up: torch.Tensor,  # [F] fp32
    s_proj: torch.Tensor,  # [N] fp32
    s_down: torch.Tensor,  # [N] fp32
    b_up: torch.Tensor,  # [F]
    b_down: torch.Tensor,  # [N]
    act: Optional[str] = "gelu-tanh",
    bits: int = 8,
) -> torch.Tensor:
    """K2: ``residual + x_proj @ Wproj + act(x_up @ Wup + b_up) @ Wdown +
    b_down``, with every weight dequantized by its per-channel scales;
    ``bits=4``: all three weights packed int4."""
    if not x_up.is_cuda:
        return fused_up_proj_down_plain(
            x_up, x_proj, residual, w_up, w_proj, w_down, s_up, s_proj, s_down,
            b_up, b_down, act, bits,
        )
    check_operands(x_up, w_up, s_up, b_up, "fused_up_proj_down", bits=bits)
    _cuda.require(act in ACT_CODES, f"fused_up_proj_down: unknown activation {act!r}")
    h = torch.empty(x_up.shape[0], w_up.shape[1], dtype=torch.bfloat16, device=x_up.device)
    if bits == 4:
        launch_w4(x_up, w_up, s_up, 0, b_up, act, h, "fused_up_proj_down (up)")
    else:
        launch_gemv(x_up, w_up, s_up, b_up, act, h)
    out = fused_proj_down(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, residual, bits)
    fused_up_proj_down.launches += 1
    return out


fused_up_proj_down.launches = 0
