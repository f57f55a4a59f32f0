"""Parameter dicts for GPT-NeoX models (PyTorch port of models/params.py).

The layout is the JAX package's: a nested dict with every per-layer tensor
stacked along a leading ``[layer_num, ...]`` axis, weights in the x @ W
convention (in-features first). ``layers[name][l]`` is a free view in torch,
so the model's Python layer loop hands each kernel the layer's slice without
a copy.

  qkv_w  [L, H, (nH + 2 nKV) dh]   qkv_b  [L, (nH + 2 nKV) dh]
  proj_w [L, nH dh, H]             proj_b [L, H] (serial residual only)
  up_w   [L, H, I]                 up_b   [L, I]
  gate_w [L, H, I]                 (gated FFN, SwiGLU: act(x @ gate) * (x @ up))
  down_w [L, I, H]                 down_b [L, H] (attention + FFN bias summed
                                                  under the parallel residual)
  MoE (Mixtral) in place of up/gate/down: router_w [L, H, E], eup_w /
  egate_w [L, E, H, I], edown_w [L, E, I, H], float, no expert biases.
  pos_embed [P, H] (learned absolute positions, GPT-2 / OPT / StarCoder);
  lm_head_b [V] (GPT-J's head bias).

With ``int8_mode=1`` the four big kernels are ``QuantizedTensor``s: an int8
payload in the logical shape with fp32 per-output-channel scales, or
(``weight_bits=4``) an int4 payload packed two nibbles per byte along K with
fp32 per-channel or group-wise (``group_size``) scales, bf16 unless
``FTCF_GSCALE_BF16=0`` (``ckpt.quantize.group_scale_dtype``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..core.device import resolve_device
from ..core.dtypes import torch_dtype


def unpack_int4(q: torch.Tensor, k_axis: int = -2) -> torch.Tensor:
    """Packed int4 (two nibbles a byte along ``k_axis``, low nibble first) ->
    int8 values with ``k_axis`` doubled, the nibbles sign-extended."""
    k_ax = k_axis % q.ndim
    lo = (q << 4) >> 4  # arithmetic shifts on int8: sign-extend
    hi = q >> 4
    shape = list(q.shape)
    shape[k_ax] *= 2
    return torch.stack([lo, hi], dim=k_ax + 1).reshape(shape)


@dataclasses.dataclass
class QuantizedTensor:
    """Weight-only-quantized kernel: an int8 container plus scales.

    ``bits=8``: ``q`` keeps the logical kernel shape. ``bits=4``: ``q``
    packs two signed nibbles per byte along the contraction axis ``k_axis``
    (end-relative), interleaved: logical row 2i sits in the LOW nibble of
    byte row i and row 2i+1 in its HIGH nibble. ``scale`` is fp32 with
    ``q``'s logical shape minus ``k_axis`` (per output channel), or, with
    ``group_size`` G > 0, has ``k_axis`` cut to K/G groups (bf16 for int4 unless ``FTCF_GSCALE_BF16=0``).
    Same fields, layout and ``dequantize`` as the JAX class.
    """

    q: torch.Tensor
    scale: torch.Tensor
    k_axis: int = -2
    group_size: int = 0
    bits: int = 8

    @property
    def shape(self):
        """Logical (unquantized) kernel shape."""
        shape = list(self.q.shape)
        if self.bits == 4:
            shape[self.k_axis % len(shape)] *= 2
        return tuple(shape)

    def unpack(self) -> torch.Tensor:
        """int8 values in the logical shape (sign-extended nibbles for bits=4)."""
        return self.q if self.bits == 8 else unpack_int4(self.q, self.k_axis)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        k_ax = self.k_axis % self.q.ndim
        if self.group_size:
            scale = self.scale.float().repeat_interleave(self.group_size, dim=k_ax)
        else:
            scale = self.scale.float().unsqueeze(k_ax)
        return (self.unpack().float() * scale).to(dtype)

    def __getitem__(self, idx):
        """Index the leading (layer) axis of payload and scale together."""
        if self.k_axis >= 0:
            raise ValueError("k_axis must be end-relative (negative)")
        return QuantizedTensor(
            q=self.q[idx], scale=self.scale[idx], k_axis=self.k_axis,
            group_size=self.group_size, bits=self.bits,
        )


Params = Dict[str, Any]

# The int4 LM head's vocab axis is padded to a multiple of this (JAX
# ckpt/quantize.py quantize_lm_head_int4): 100831 -> 102400 for CodeFuse-13B.
LM_HEAD_INT4_TILE = 2560


def init_params(
    config: GptNeoXConfig,
    seed: int = 0,
    dtype: Any = torch.float32,
    std: float = 0.02,
    int8_mode: int = 0,
    quantize_embeddings: bool = False,
    device=None,
    weight_bits: int = 8,
    group_size: int = 0,
) -> Params:
    """Random parameters, built directly on ``device`` (the CUDA card when
    None; raises without one) from one ``torch.Generator`` seeded with
    ``seed`` (tests and the 13B smoke run).

    With ``int8_mode=1`` the four big per-layer kernels are random int8 with
    scales in [0.5, 1.5) * std / 127, as in the JAX package; with
    ``weight_bits=4`` random packed nibbles with scales in [0.5, 1.5) * std
    / 7, per output channel (fp32) or, with ``group_size`` G, per (K-group,
    channel) in bf16. ``quantize_embeddings`` also makes the embedding table
    int8 with per-row scales, and the LM head int8 [V, H] with per-row scales
    or, at ``weight_bits=4``, the transposed packed int4 head [H/2, V_pad]
    (``k_axis=-2``, V padded to a multiple of 2560, per-column fp32 scales).
    The keys follow the config as in the JAX package: ``gate_w`` (a gated
    FFN) quantized like ``up_w``; MoE experts (``router_w``, ``eup_w``,
    ``egate_w``, ``edown_w``) float and bias-free; a learned position table
    ``pos_embed`` of 2048 rows (the JAX package's) with std 0.01. The
    numbers differ from the JAX package's (another generator): parity tests
    share weights through ``from_jax_params``.
    """
    if weight_bits not in (8, 4):
        raise ValueError(f"weight_bits must be 8 or 4, got {weight_bits}")
    dtype = torch_dtype(dtype)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    L, H, I, V = (
        config.layer_num, config.hidden_size, config.inter_size, config.vocab_size
    )
    nHdh = config.head_num * config.size_per_head

    def dense_std(shape, sd):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        return out.normal_(0.0, sd, generator=gen).to(dtype)

    def dense(shape):
        return dense_std(shape, std)

    def rand_i8(shape):
        out = torch.empty(shape, dtype=torch.int8, device=device)
        return out.random_(-128, 128, generator=gen)

    def uniform_scale(shape, qmax):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        return out.uniform_(0.5, 1.5, generator=gen) * (std / qmax)

    def maybe_quant(shape):
        """A stacked [L, K, N] kernel, quantized along K (k_axis=-2)."""
        if int8_mode < 1:
            return dense(shape)
        qmax = 127.0 if weight_bits == 8 else 7.0
        L_, K, N = shape
        if group_size and K % group_size:
            raise ValueError(f"group_size {group_size} does not divide K={K}")
        q = rand_i8((L_, K // 2, N) if weight_bits == 4 else shape)
        if group_size:
            scale = uniform_scale((L_, K // group_size, N), qmax)
            from ..ckpt.quantize import group_scale_dtype

            scale = scale.to(group_scale_dtype(weight_bits, group_size))
        else:
            scale = uniform_scale((L_, N), qmax)
        return QuantizedTensor(q=q, scale=scale, k_axis=-2, bits=weight_bits,
                               group_size=group_size)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "ln1_w": ones((L, H)),
        "qkv_w": maybe_quant((L, H, config.qkv_cols)),
        "proj_w": maybe_quant((L, nHdh, H)),
        "ln2_w": ones((L, H)),
    }
    if config.moe_experts:
        E = config.moe_experts
        layers["router_w"] = dense((L, H, E))
        layers["eup_w"] = dense((L, E, H, I))
        layers["edown_w"] = dense((L, E, I, H))
        if config.gated_ffn:
            layers["egate_w"] = dense((L, E, H, I))
    else:
        layers["up_w"] = maybe_quant((L, H, I))
        layers["down_w"] = maybe_quant((L, I, H))
        if config.gated_ffn:
            layers["gate_w"] = maybe_quant((L, H, I))
    if config.norm != "rmsnorm":
        layers["ln1_b"] = zeros((L, H))
        layers["ln2_b"] = zeros((L, H))
    if config.use_bias or config.qkv_bias:
        layers["qkv_b"] = zeros((L, config.qkv_cols))
    if config.use_bias:
        if not config.moe_experts:  # expert FFNs are bias-free
            layers["up_b"] = zeros((L, I))
            layers["down_b"] = zeros((L, H))
        if not config.use_gptj_residual:
            layers["proj_b"] = zeros((L, H))

    def maybe_quant_rowwise(shape):
        if quantize_embeddings:
            return QuantizedTensor(
                q=rand_i8(shape), scale=uniform_scale(shape[:-1], 127.0), k_axis=-1
            )
        return dense(shape)

    def lm_head_weight():
        if quantize_embeddings and weight_bits == 4:
            # transposed packed head [H/2, V_pad] (ckpt.quantize.quantize_lm_head_int4)
            Vp = -(-V // LM_HEAD_INT4_TILE) * LM_HEAD_INT4_TILE
            return QuantizedTensor(q=rand_i8((H // 2, Vp)), scale=uniform_scale((Vp,), 7.0),
                                   k_axis=-2, bits=4)
        return maybe_quant_rowwise((V, H))  # [V, H]: contracted on H

    out = {
        "embed": maybe_quant_rowwise((V, H)),
        "layers": layers,
        "final_ln_w": ones((H,)),
        "lm_head": lm_head_weight(),
    }
    if config.norm != "rmsnorm":
        out["final_ln_b"] = zeros((H,))
    if config.position_embedding == "learned":
        out["pos_embed"] = dense_std((2048, H), 0.01)
    return out


def _to_torch(a, device) -> torch.Tensor:
    """numpy array (ml_dtypes bfloat16 included) -> torch tensor on device."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_params(tree, device=None) -> Params:
    """Turn the JAX package's parameter pytree (array leaves convertible with
    ``np.asarray``) into this port's dict, value for value, on ``device``
    (the CUDA card when None; raises without one).

    Quantized leaves are recognised by their ``q/scale/k_axis/bits/group_size``
    attributes, so the JAX class is never imported.
    """
    device = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if all(hasattr(v, a) for a in ("q", "scale", "k_axis", "bits", "group_size")):
            return QuantizedTensor(
                q=_to_torch(v.q, device), scale=_to_torch(v.scale, device),
                k_axis=int(v.k_axis), bits=int(v.bits), group_size=int(v.group_size),
            )
        return _to_torch(v, device)

    return conv(tree)


def params_to(params: Params, device, dtype=None) -> Params:
    """A copy of ``params`` (nested dicts and lists) on ``device``; with
    ``dtype``, the floating tensors other than a QuantizedTensor's payload and
    scales in that dtype."""
    if isinstance(params, dict):
        return {k: params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    if isinstance(params, QuantizedTensor):
        return dataclasses.replace(params, q=params.q.to(device), scale=params.scale.to(device))
    if dtype is not None and params.is_floating_point():
        return params.to(device=device, dtype=torch_dtype(dtype))
    return params.to(device)


def param_bytes(params: Params) -> int:
    total = 0

    def walk(v):
        nonlocal total
        if isinstance(v, (dict, list)):
            for x in (v.values() if isinstance(v, dict) else v):
                walk(x)
        elif isinstance(v, QuantizedTensor):
            walk(v.q)
            walk(v.scale)
        else:
            total += v.numel() * v.element_size()

    walk(params)
    return total


def layer_slice(stacked: dict, l: int) -> dict:
    """Per-layer views of a stacked-params dict (no copies)."""
    return {k: v[l] for k, v in stacked.items()}
