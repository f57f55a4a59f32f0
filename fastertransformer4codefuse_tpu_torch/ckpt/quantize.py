"""Offline weight-only quantization (port of ckpt/quantize.py, torch level).

Symmetric scales over the contraction axis: per output channel, or per
(K-group, output channel) with ``group_size``. int8 stores one value a byte;
int4 packs two nibbles a byte along K, row 2i in the low nibble and row 2i+1
in the high one (``models.params.QuantizedTensor``). The stored (q, scale)
pairs are bit-identical to the JAX package's. Group-wise int4 scales are bf16
(the JAX default; its ``FTCF_GSCALE_BF16=0`` switch to fp32 is not ported).

The checkpoint loader, converters and the ``.bin`` writer are ROADMAP queue 1
item 9.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.params import LM_HEAD_INT4_TILE, Params, QuantizedTensor


def group_scale_dtype(bits: int, group_size: int) -> torch.dtype:
    """bf16 for group-wise int4 scales ([K/G, N], streamed every decode step),
    fp32 otherwise."""
    return torch.bfloat16 if bits == 4 and group_size else torch.float32


def _fp32(w) -> torch.Tensor:
    if isinstance(w, np.ndarray):
        w = torch.from_numpy(np.ascontiguousarray(w))
    return w.to(torch.float32)


def quantize_array(w, k_axis: int = -2, bits: int = 8, group_size: int = 0) -> QuantizedTensor:
    """Symmetric int8/int4 quantization of ``w`` (numpy array or tensor).

    ``scale = max |w| / qmax`` over K (or over each K-group), qmax 127 for
    int8 and 7 for int4; zero columns get scale 1; ``q = round(w / scale)``
    (half to even) clipped to [-127, 127] or [-8, 7]. Group scales are
    rounded to their stored dtype first and q is computed against the rounded
    value, so the stored pair is self-consistent."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    w32 = _fp32(w)
    k_ax = k_axis % w32.ndim
    qmax = 127.0 if bits == 8 else 7.0
    one = torch.ones((), dtype=torch.float32)
    if group_size:
        K = w32.shape[k_ax]
        if K % group_size:
            raise ValueError(f"K={K} is not a multiple of group_size={group_size}")
        wg = w32.reshape(w32.shape[:k_ax] + (K // group_size, group_size) + w32.shape[k_ax + 1:])
        amax = wg.abs().amax(dim=k_ax + 1)
        scale = torch.where(amax > 0, amax / qmax, one).to(group_scale_dtype(bits, group_size))
        q = torch.round(wg / scale.float().unsqueeze(k_ax + 1)).reshape(w32.shape)
    else:
        amax = w32.abs().amax(dim=k_ax)
        scale = torch.where(amax > 0, amax / qmax, one)
        q = torch.round(w32 / scale.unsqueeze(k_ax))
    if bits == 8:
        q = q.clamp(-127, 127).to(torch.int8)
    else:
        q = q.clamp(-8, 7).to(torch.int8)
        if q.shape[k_ax] % 2 or group_size % 2:
            raise ValueError("int4 packing needs an even contraction dim and group size")
        pairs = q.unfold(k_ax, 2, 2)  # [..., K/2, ..., 2]: rows (2i, 2i+1)
        q = (pairs[..., 1] << 4) | (pairs[..., 0] & 0xF)
    return QuantizedTensor(q=q.contiguous(), scale=scale.contiguous(), k_axis=k_ax - w32.ndim,
                           bits=bits, group_size=group_size)


_QUANT_KEYS = ("qkv_w", "proj_w", "up_w", "down_w", "gate_w")


def quantize_params(
    params: Params,
    include_embeddings: bool = False,
    weight_bits: int = 8,
    group_size: int = 0,
) -> Params:
    """Quantize the big per-layer kernels (stacked [L, K, N], along K).
    ``include_embeddings`` also makes the embedding table int8 with per-row
    scales, and the LM head int8 [V, H] with per-row scales or, at
    ``weight_bits=4``, the transposed per-channel int4 head
    (``quantize_lm_head_int4``)."""
    layers = dict(params["layers"])
    for k in _QUANT_KEYS:
        w = layers.get(k)
        if w is None or isinstance(w, QuantizedTensor):
            continue
        layers[k] = quantize_array(w, k_axis=-2, bits=weight_bits, group_size=group_size)
    out = dict(params, layers=layers)
    if include_embeddings:
        if not isinstance(out["embed"], QuantizedTensor):
            out["embed"] = quantize_array(out["embed"], k_axis=-1)  # scale [V]
        if not isinstance(out["lm_head"], QuantizedTensor):
            if weight_bits == 4:
                out["lm_head"] = quantize_lm_head_int4(out["lm_head"])
            else:
                out["lm_head"] = quantize_array(out["lm_head"], k_axis=-1)  # scale [V]
    return out


def quantize_lm_head_int4(w, tile: int = LM_HEAD_INT4_TILE) -> QuantizedTensor:
    """The [V, H] head as a transposed per-channel int4 kernel: packed
    [H/2, V_pad] with k_axis=-2 and one fp32 scale per (padded) vocab column,
    V padded with zero columns to a multiple of ``tile``. ``lm_logits``
    slices the pad columns off."""
    w32 = _fp32(w)
    V, _ = w32.shape
    Vp = -(-V // tile) * tile
    wt = torch.nn.functional.pad(w32.t(), (0, Vp - V))  # [H, V_pad]
    return quantize_array(wt, k_axis=-2, bits=4)
