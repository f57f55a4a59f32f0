"""SmoothQuant: W8A8 preparation, the reference's ``int8_mode=2`` semantics
(port of ckpt/smoothquant.py).

Per-input-channel smoothing factors s_k = amax_act_k^alpha /
amax_w_k^(1 - alpha) move quantization difficulty from the activations
(outlier channels) into the weights, and fold exactly into the preceding
norm's affine, as the AWQ fold does (``ckpt.calibrate.apply_awq_scaling``):

    qkv_w[l] *= s     ln1_w[l] /= s   (ln1_b too, where present)
    up_w[l]  *= s'    ln2_w[l] /= s'  (gate_w shares s' under a gated FFN:
                                       both read the same ln2 output)

proj and down have no preceding affine; their activations quantize per token
at run time without smoothing. At run time ``RuntimeConfig(act_int8=True)``
sends the sequence-wide GEMMs through ``ops.linear.w8a8_matmul``.

Flow:
    stats  = calibrate.collect_activation_stats(cfg, params, batches)
    params = apply_smoothquant_scaling(cfg, params, stats, alpha=0.5)
    qp     = quantize.quantize_params(params)   # int8 per-channel
    eng    = GptNeoXEngine(cfg, qp, RuntimeConfig(int8_mode=1, act_int8=True))
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..models.params import Params


def smoothquant_scales(amax_act, w, alpha: float = 0.5) -> torch.Tensor:
    """s_k = amax_act_k^alpha / amax_w_k^(1 - alpha), each amax clamped to at
    least 1e-5, as is s; fp32 on ``w``'s device. ``w`` [K, N]."""
    w = torch.as_tensor(w).float()
    a = torch.as_tensor(np.asarray(amax_act, np.float32) if not torch.is_tensor(amax_act)
                        else amax_act).float().to(w.device)
    a = torch.clamp(a, min=1e-5)
    wmax = torch.clamp(w.abs().amax(dim=1), min=1e-5)
    s = a ** alpha / wmax ** (1.0 - alpha)
    return torch.clamp(s, min=1e-5)


def apply_smoothquant_scaling(
    config: GptNeoXConfig,
    params: Params,
    stats: Dict[str, np.ndarray],  # from calibrate.collect_activation_stats
    alpha: float = 0.5,
) -> Params:
    """A copy of ``params`` with the SmoothQuant factors folded into the norm
    affines, fp-forward exact (one s per norm output: the widest consumer's
    weight range governs). Quantize afterwards with
    ``ckpt.quantize.quantize_params``. Works layer by layer on the params'
    device: a stacked kernel is rebuilt one layer at a time."""
    if config.moe_experts:
        raise ValueError("SmoothQuant folds dense FFN blocks; MoE expert weights are not covered")
    src = params["layers"]
    layers = dict(src)
    groups = [("ln1", ["qkv_w"], "qkv")]
    ffn = ["gate_w", "up_w"] if config.gated_ffn else ["up_w"]
    groups.append(("ln2", [k for k in ffn if k in src], "up"))
    for ln_key, w_keys, st_key in groups:
        ws = {k: torch.empty_like(src[k]) for k in w_keys}
        ln_w = src[f"{ln_key}_w"].float().clone()
        has_b = f"{ln_key}_b" in src
        ln_b = src[f"{ln_key}_b"].float().clone() if has_b else None
        for l in range(config.layer_num):
            w_l = {k: src[k][l].float() for k in w_keys}
            s = smoothquant_scales(stats[st_key][l], torch.cat([w_l[k] for k in w_keys], dim=1),
                                   alpha)
            for k in w_keys:
                ws[k][l] = (w_l[k] * s[:, None]).to(ws[k].dtype)
            ln_w[l] /= s
            if has_b:
                ln_b[l] /= s
        layers.update(ws)
        layers[f"{ln_key}_w"] = ln_w.to(src[f"{ln_key}_w"].dtype)
        if has_b:
            layers[f"{ln_key}_b"] = ln_b.to(src[f"{ln_key}_b"].dtype)
    return dict(params, layers=layers)
