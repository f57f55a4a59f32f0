"""K2, K3 and K13: the parallel-residual decode block's fused GEMMs.

Port of ops/quant_matmul_fused.py ``fused_up_proj_down`` (K2),
``fused_proj_down`` (K3) and ``fused_qkv_up`` (K13); CUDA in
``csrc/quant_matmul_fused.cu``. The weights are a layer's views ([K, N] int8,
or with ``bits=4`` the packed int4 [K/2, N]; [N] fp32 per-channel scales or,
with ``group_size`` G, [K/G, N] group scales, bf16 or fp32 for int4 (each
with its own kernel instance) and fp32 for int8; [N] biases) instead of the
stacked arrays plus a layer index.

K13 computes ``[x1 @ W1 * s1 + b1 | act2(x2 @ W2 * s2 + b2)]`` over the
concatenated output columns; the JAX kernel returns the [M, N1 + N2] array
and its caller slices, the port returns the two halves as two buffers, so the
up half (the FFN hidden h) is the contiguous [M, F] that K3 reads. A decode
layer is then two launches: K13 (qkv and h), then K3 (proj + down + bias +
residual) over (attention output, h).

K2 is two launches from one wrapper: the up phase (a weight-streaming GEMV
with the activation) writes bf16 h to a scratch buffer, then K3 computes the
proj + down contraction with the residual and bias. Its output is the layer
output. The model's decode route is K13 then K3 and calls K2 nowhere; K2
stays ported, held against its plain version.

Each ``*_plain`` function is the same math in plain PyTorch (fp32
contraction, per-channel scales on the sum or group scales folded into the
weight, bias and activation in fp32, one rounding to x's dtype): the CPU path
and the kernels' oracle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda
from ..models.params import QuantizedTensor, unpack_int4
from .linear import ACT_CODES, apply_act
from .quant_matmul import (
    GEMV_MAX_M, check_operands, gemm_plan, gemv_splits, kernel_name, weight_format,
)


def _contract(x, w, s, bits, G=0):
    """fp32 ``x @ dequant(w)`` for an int8 or packed int4 [K(/2), N] weight:
    per-channel scales multiply the sum, group scales each weight."""
    if G:
        return x.float() @ QuantizedTensor(q=w, scale=s, k_axis=-2, group_size=G,
                                           bits=bits).dequantize()
    q = unpack_int4(w, 0) if bits == 4 else w
    return (x.float() @ q.float()) * s.float()


def _bias_ptr(b):
    return _cuda.ptr(b), int(b is not None and b.dtype == torch.bfloat16)


def fused_proj_down_plain(x1, x2, w1, w2, s1, s2, bias, residual, bits=8, group_size=0):
    y = _contract(x1, w1, s1, bits, group_size) + _contract(x2, w2, s2, bits, group_size)
    return (y + bias.float() + residual.float()).to(x1.dtype)


def fused_proj_down(
    x1: torch.Tensor,  # [M, K1] attention output (contracts with proj)
    x2: torch.Tensor,  # [M, K2] activated FFN hidden (contracts with down)
    w1: torch.Tensor,  # [K1(/2), N] int8 payload
    w2: torch.Tensor,  # [K2(/2), N]
    s1: torch.Tensor,  # [N] fp32, or [K1/G, N] group scales
    s2: torch.Tensor,  # [N] fp32, or [K2/G, N]
    bias: torch.Tensor,  # [N] the pre-summed parallel bias
    residual: torch.Tensor,  # [M, N] the block input
    bits: int = 8,
    group_size: int = 0,
) -> torch.Tensor:
    """K3: ``x1 @ w1 * s1 + x2 @ w2 * s2 + bias + residual`` -- the whole
    parallel-residual merge; its output is the layer output. ``bits=4``:
    both weights packed int4 [K/2, N]; ``group_size`` G > 0: group scales."""
    if not x1.is_cuda:
        return fused_proj_down_plain(x1, x2, w1, w2, s1, s2, bias, residual, bits, group_size)
    check_operands(x1, w1, s1, bias, "fused_proj_down", bits=bits, group_size=group_size)
    check_operands(x2, w2, s2, None, "fused_proj_down", bits=bits, group_size=group_size)
    M, K1 = x1.shape
    K2, N = x2.shape[1], w2.shape[1]
    _cuda.require(w1.shape[1] == N and x2.shape[0] == M, "fused_proj_down: shapes disagree")
    _cuda.require(s1.dtype == s2.dtype, "fused_proj_down: the two scales differ in dtype")
    _cuda.require(residual.dtype == torch.bfloat16 and residual.shape == (M, N)
                  and residual.is_contiguous() and residual.device == x1.device,
                  "fused_proj_down: residual must be a contiguous bf16 [M, N]")
    share1 = K1 / (K1 + K2)
    (n1, c1), (n2, c2) = gemv_splits(kernel_name("pd_gemv", bits, group_size, s1), M,
                                     [(K1, N, share1), (K2, N, 1.0 - share1)], x1.device, bits,
                                     group_size)
    ws = torch.empty((n1 + n2) * M * N, dtype=torch.float32, device=x1.device)
    out = torch.empty(M, N, dtype=torch.bfloat16, device=x1.device)
    err = _cuda.lib().ftcf_fused_proj_down(
        weight_format(bits, group_size, s1), group_size,
        x1.data_ptr(), w1.data_ptr(), s1.data_ptr(), K1, n1, c1,
        x2.data_ptr(), w2.data_ptr(), s2.data_ptr(), K2, n2, c2, M, N,
        *_bias_ptr(bias), residual.data_ptr(), out.data_ptr(), ws.data_ptr(),
        _cuda.stream_of(x1),
    )
    _cuda.check(err, "fused_proj_down")
    fused_proj_down.launches += 1
    fused_proj_down.launches_f32 += bits == 4 and _f32_groups(group_size, s1)
    return out


def _f32_groups(group_size, scale) -> bool:
    """The call took an fp32 group-scale instance of int4 weights."""
    return bool(group_size) and scale.dtype == torch.float32 and scale.ndim == 2


# ``launches_f32``: the launches on int4 weights with fp32 group scales (the
# JAX package's FTCF_GSCALE_BF16=0), counted within ``launches``
fused_proj_down.launches = 0
fused_proj_down.launches_f32 = 0


def _segment_plain(x, w, s, b, act, bits, G):
    y = _contract(x, w, s, bits, G)
    if b is not None:
        y = y + b.float()
    if act is not None:
        y = apply_act(y, act)
    return y.to(x.dtype)


def fused_qkv_up_plain(x1, x2, w1, w2, s1, s2, b1=None, b2=None, act1=None, act2=None, bits=8,
                       group_size=0):
    return (_segment_plain(x1, w1, s1, b1, act1, bits, group_size),
            _segment_plain(x2, w2, s2, b2, act2, bits, group_size))


def _launch_ncat(segs, bits, G, name):
    """One launch of the N-joined GEMV (M <= 32) or GEMM over one or two
    segments (x, w, s, b, act), each into a new bf16 [M, N_i], under its plan
    from the tile cache (kernel ``ncat_gemv`` / ``ncat_gemm`` for two
    segments, ``gemv`` / ``gemm`` for one); operands already checked. No
    launch count."""
    x = segs[0][0]
    M, K = x.shape
    outs = [torch.empty(M, sg[1].shape[1], dtype=torch.bfloat16, device=x.device)
            for sg in segs]
    args = []
    for (xs, w, s, b, act), y in zip(segs, outs):
        args.append([xs.data_ptr(), w.data_ptr(), s.data_ptr(), w.shape[1], *_bias_ptr(b),
                     ACT_CODES[act], y.data_ptr()])
    Ns = [a[3] for a in args]
    if len(segs) == 1:  # an empty second segment
        args.append([None, None, None, 0, None, 0, 0, None])
    fmt = weight_format(bits, G, segs[0][2])
    body = "ncat_" if len(segs) == 2 else ""
    if M <= GEMV_MAX_M:
        ranges = gemv_splits(kernel_name(body + "gemv", bits, G, segs[0][2]), M,
                             [(K, N, 1.0) for N in Ns], x.device, bits, G) + [(0, 0)]
        wss = []  # each segment's split workspace, held until the launch
        for a, (splits, chunk) in zip(args, ranges):
            N = a[3]
            ws = torch.empty(max(splits * M * N, 1), dtype=torch.float32, device=x.device)
            wss.append(ws)
            a[4:4] = [splits, chunk]  # (x, w, s, N, splits, chunk, b, bf16, act, y)
            a.append(ws.data_ptr())
        err = _cuda.lib().ftcf_gemv_ncat(fmt, G, M, K, *args[0], *args[1], _cuda.stream_of(x))
    else:
        plan = gemm_plan(kernel_name(body + "gemm", bits, G, segs[0][2]), M, K, sum(Ns), G,
                         x.device)
        err = _cuda.lib().ftcf_gemm_ncat(fmt, G, M, K, *args[0], *args[1], *plan.args(),
                                         _cuda.stream_of(x))
    _cuda.check(err, name)
    return outs


def fused_qkv_up(
    x1: torch.Tensor,  # [M, K] ln1 output (feeds the qkv columns)
    x2: torch.Tensor,  # [M, K] ln2 output (feeds the up columns)
    w1: torch.Tensor,  # [K(/2), N1] int8 payload (qkv)
    w2: torch.Tensor,  # [K(/2), N2] (up)
    s1: torch.Tensor,  # [N1] fp32, or [K/G, N1] group scales
    s2: torch.Tensor,  # [N2] fp32, or [K/G, N2]
    b1: Optional[torch.Tensor] = None,  # [N1]
    b2: Optional[torch.Tensor] = None,  # [N2]
    act1: Optional[str] = None,
    act2: Optional[str] = None,  # up's activation
    bits: int = 8,
    group_size: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13: ``(act1(x1 @ w1 * s1 + b1), act2(x2 @ w2 * s2 + b2))``, [M, N1]
    and [M, N2] in x's dtype, from one launch: the weight-streaming GEMV at
    M <= 32, the TMA + wgmma GEMM above."""
    if not x1.is_cuda:
        return fused_qkv_up_plain(x1, x2, w1, w2, s1, s2, b1, b2, act1, act2, bits, group_size)
    check_operands(x1, w1, s1, b1, "fused_qkv_up", bits=bits, group_size=group_size)
    check_operands(x2, w2, s2, b2, "fused_qkv_up", bits=bits, group_size=group_size)
    _cuda.require(x1.shape == x2.shape, "fused_qkv_up: x1 and x2 must have one shape")
    _cuda.require(s1.dtype == s2.dtype, "fused_qkv_up: the two scales differ in dtype")
    _cuda.require(act1 in ACT_CODES and act2 in ACT_CODES,
                  f"fused_qkv_up: unknown activation {act1!r} / {act2!r}")
    y1, y2 = _launch_ncat([(x1, w1, s1, b1, act1), (x2, w2, s2, b2, act2)], bits, group_size,
                          "fused_qkv_up")
    fused_qkv_up.launches += 1
    fused_qkv_up.launches_f32 += bits == 4 and _f32_groups(group_size, s1)
    fused_qkv_up.launches_g8 += bits == 8 and bool(group_size)
    return y1, y2


fused_qkv_up.launches = 0
fused_qkv_up.launches_f32 = 0
fused_qkv_up.launches_g8 = 0  # on int8 weights with group scales (GEMV and GEMM forms)


def fused_up_proj_down_plain(
    x_up, x_proj, residual, w_up, w_proj, w_down, s_up, s_proj, s_down, b_up, b_down,
    act="gelu-tanh", bits=8, group_size=0,
):
    # the hidden is rounded to x's dtype before down
    h = _segment_plain(x_up, w_up, s_up, b_up, act, bits, group_size)
    return fused_proj_down_plain(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, residual,
                                 bits, group_size)


def fused_up_proj_down(
    x_up: torch.Tensor,  # [M, H] ln2 output
    x_proj: torch.Tensor,  # [M, H] attention output
    residual: torch.Tensor,  # [M, N] the block input
    w_up: torch.Tensor,  # [H(/2), F] int8 payload
    w_proj: torch.Tensor,  # [H(/2), N]
    w_down: torch.Tensor,  # [F(/2), N]
    s_up: torch.Tensor,  # [F] fp32, or [H/G, F] group scales
    s_proj: torch.Tensor,  # [N] fp32, or [H/G, N]
    s_down: torch.Tensor,  # [N] fp32, or [F/G, N]
    b_up: torch.Tensor,  # [F]
    b_down: torch.Tensor,  # [N]
    act: Optional[str] = "gelu-tanh",
    bits: int = 8,
    group_size: int = 0,
) -> torch.Tensor:
    """K2: ``residual + x_proj @ Wproj + act(x_up @ Wup + b_up) @ Wdown +
    b_down``, every weight dequantized by its scales; ``bits=4``: all three
    weights packed int4; ``group_size`` G > 0: group scales."""
    if not x_up.is_cuda:
        return fused_up_proj_down_plain(
            x_up, x_proj, residual, w_up, w_proj, w_down, s_up, s_proj, s_down,
            b_up, b_down, act, bits, group_size,
        )
    check_operands(x_up, w_up, s_up, b_up, "fused_up_proj_down", bits=bits,
                   group_size=group_size)
    _cuda.require(act in ACT_CODES, f"fused_up_proj_down: unknown activation {act!r}")
    (h,) = _launch_ncat([(x_up, w_up, s_up, b_up, act)], bits, group_size,
                        "fused_up_proj_down (up)")
    out = fused_proj_down(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, residual, bits,
                          group_size)
    fused_up_proj_down.launches += 1
    fused_up_proj_down.launches_f32 += bits == 4 and _f32_groups(group_size, s_up)
    return out


fused_up_proj_down.launches = 0
fused_up_proj_down.launches_f32 = 0
