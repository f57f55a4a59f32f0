"""Offline weight-only quantization (port of ckpt/quantize.py, torch level).

Symmetric scales over the contraction axis: per output channel, or per
(K-group, output channel) with ``group_size``. int8 stores one value a byte;
int4 packs two nibbles a byte along K, row 2i in the low nibble and row 2i+1
in the high one (``models.params.QuantizedTensor``). The stored (q, scale)
pairs are bit-identical to the JAX package's. Group-wise int4 scales are bf16,
or fp32 under ``FTCF_GSCALE_BF16=0``, the JAX package's switch.

``quant_and_save`` is the offline tool: it writes quantized payload and
scale files beside a reference-format checkpoint's float kernels (the
analog of the reference's quant_and_save.py), in plain row-major layout,
which ``ckpt.loader`` reads back.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Iterable, Optional

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..models.params import LM_HEAD_INT4_TILE, Params, QuantizedTensor


def group_scale_dtype(bits: int, group_size: int) -> torch.dtype:
    """bf16 for group-wise int4 scales ([K/G, N], streamed every decode step),
    unless the environment sets ``FTCF_GSCALE_BF16=0``; fp32 otherwise. The
    kernels take either (K7, K2, K3, K13 each have an fp32 group-scale
    instance)."""
    if bits == 4 and group_size and os.environ.get("FTCF_GSCALE_BF16", "1") != "0":
        return torch.bfloat16
    return torch.float32


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
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, one ulp off the true quotient the JAX quantizer takes
    qmax = torch.tensor(127.0 if bits == 8 else 7.0, device=w32.device)
    one = torch.ones((), dtype=torch.float32, device=w32.device)
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
        if w.ndim == 3:
            # one layer at a time (the same bytes: each layer's scales are its
            # own), so a 13B model quantizes on the card in a layer's fp32 room
            per = [quantize_array(w[l], k_axis=-2, bits=weight_bits, group_size=group_size)
                   for l in range(w.shape[0])]
            layers[k] = QuantizedTensor(q=torch.stack([t.q for t in per]),
                                        scale=torch.stack([t.scale for t in per]), k_axis=-2,
                                        bits=weight_bits, group_size=group_size)
            del per
        else:
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


def quantization_error(w, k_axis: int = -2) -> float:
    """Max abs reconstruction error of the int8 per-channel quantization."""
    qt = quantize_array(w, k_axis)
    return float((qt.dequantize() - _fp32(w)).abs().max())


QUANT_WEIGHT_NAMES = (
    "attention.query_key_value.weight",
    "attention.dense.weight",
    "mlp.dense_h_to_4h.weight",
    "mlp.dense_4h_to_h.weight",
)


def quant_and_save(
    ckpt_path: str,
    config: Optional[GptNeoXConfig] = None,
    weight_names: Iterable[str] = QUANT_WEIGHT_NAMES,
    weight_bits: int = 8,
    group_size: int = 0,
) -> None:
    """For every per-layer, per-rank float kernel file
    ``model.layers.{i}.<name>.<rank>.bin`` write the quantized payload and
    scales next to it: ``.q.bin`` / ``.s.bin`` for int8, ``.q4.bin`` /
    ``.s4.bin`` for nibble-packed int4, ``.s4gN.bin`` with group size N.
    Scales are written in the checkpoint's ``weight_data_type``, as the JAX
    tool writes them. Only the float rank files are read, so int8 and int4
    payloads of one directory can be written in either order, each byte for
    byte the JAX tool's. The JAX tool also takes an earlier ``.q4.bin`` (and
    ``.s4*.bin``) for a float kernel and writes int8 quantizations of those
    bytes beside it (``*.q4.q.bin``, ...), which no loader reads; the port
    does not write them."""
    if config is None:
        config = GptNeoXConfig.from_ini(ckpt_path)
    wdt = np.float16 if config.weight_data_type == "fp16" else np.float32
    H = config.hidden_size
    for i in range(config.layer_num):
        for name in weight_names:
            paths = glob.glob(os.path.join(ckpt_path, f"model.layers.{i}.{name}.*.bin"))
            for path in sorted(p for p in paths if re.search(r"\.\d+\.bin$", p)):
                flat = np.fromfile(path, dtype=wdt)
                # every kernel here is [K, rest...], quantized along K
                k_dim = {
                    "attention.query_key_value.weight": H,
                    "attention.dense.weight": flat.size // H,
                    "mlp.dense_h_to_4h.weight": H,
                    "mlp.dense_4h_to_h.weight": flat.size // H,
                }[name]
                qt = quantize_array(flat.reshape(k_dim, -1), k_axis=-2, bits=weight_bits,
                                    group_size=group_size)
                scale = qt.scale.float().numpy().astype(wdt)
                if weight_bits == 8:
                    qt.q.numpy().tofile(path[:-4] + ".q.bin")
                    scale.tofile(path[:-4] + ".s.bin")
                else:
                    suffix = f"g{group_size}" if group_size else ""
                    qt.q.numpy().tofile(path[:-4] + ".q4.bin")
                    scale.tofile(path[:-4] + f".s4{suffix}.bin")
