"""Activation-aware (AWQ) calibration for weight-only quantization (port of
ckpt/calibrate.py).

Collect each linear's per-input-channel activation amax on sample prompts,
grid-search per-channel weight scales that protect the salient channels (s_k
= (amax_k / geomean)^alpha, alpha against an activation-weighted
reconstruction error of the quantized weight), and fold the scales exactly
into the preceding norm's affine, so the float forward is unchanged: qkv_w
(fed by ln1) and up_w (fed by ln2; under a gated FFN gate_w reads the same
ln2 output and takes the same scales). proj_w and down_w have no preceding
affine and stay round-to-nearest.

The JAX recorder patches the model's ``linear`` and keys each call by its
position in the block (qkv, proj, up, down; qkv, proj, gate, up, down in a
gated block). The port's fused route computes QKV and up in one K13 launch,
so its recorder runs the unfused route and keys each call by the weight it
multiplies (a layer's view of a stacked kernel starts at a known address),
whatever the call order. MoE blocks are refused, as the JAX package
refuses them.

The JAX fold (``apply_awq_scaling``) scales up_w and ln2 but not gate_w,
which changes a gated model's float forward, and reads ln1_b and ln2_b,
which RMSNorm models lack; the port scales gate_w with up_w, by the scales
searched on up_w as the JAX function searches them, and folds into the
norms' biases only where they exist.

Flow:
    stats  = collect_activation_stats(cfg, params, token_batches)
    params = apply_awq_scaling(cfg, params, stats)      # fp-exact rewrite
    params = quantize_params(params, weight_bits=4, group_size=128)
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..engine import kv_cache
from ..models import gptneox as model
from ..models.params import Params, QuantizedTensor

# the linears recorded, by their weight's name
_RECORDED = {"qkv_w": "qkv", "proj_w": "proj", "gate_w": "gate", "up_w": "up",
             "down_w": "down"}


def _addr(w) -> int:
    return (w.q if isinstance(w, QuantizedTensor) else w).data_ptr()


@contextlib.contextmanager
def _record_linear_inputs(config: GptNeoXConfig, params: Params, sink: Dict[str, List]):
    """Patch the model's ``linear`` to keep each recorded call's input amax
    over every axis but the last (on the device), in ``sink[name][layer]``."""
    layers = params["layers"]
    where = {}
    for key, name in _RECORDED.items():
        if key not in layers:
            continue
        for l in range(config.layer_num):
            where[_addr(layers[key][l])] = (name, l)
    real = model.linear

    def recording(x, w, *args, **kwargs):
        hit = where.get(_addr(w))
        if hit is not None:
            name, l = hit
            amax = x.float().abs().amax(dim=tuple(range(x.ndim - 1)))
            sink.setdefault(name, [None] * config.layer_num)[l] = amax
        return real(x, w, *args, **kwargs)

    model.linear = recording
    try:
        yield
    finally:
        model.linear = real


@torch.inference_mode()
def collect_activation_stats(
    config: GptNeoXConfig,
    params: Params,
    token_batches: Sequence[Sequence[Sequence[int]]],
    cache_dtype=torch.bfloat16,
) -> Dict[str, np.ndarray]:
    """Run the calibration prompts (each batch right-padded with end_id)
    through the unfused prefill on the params' device and keep each linear's
    running per-input-channel amax: {"qkv": [L, H], "proj": [L, H], "up":
    [L, H], "down": [L, I]} (and "gate": [L, H] in a gated block) fp32
    numpy, one host read at the end."""
    if config.moe_experts:
        raise ValueError("the positional linear-call recorder assumes the dense block's call "
                         "order; MoE blocks run batched expert einsums it never sees")
    dev = params["final_ln_w"].device
    stats: Dict[str, torch.Tensor] = {}
    for batch in token_batches:
        lens = np.array([len(x) for x in batch], np.int32)
        S = int(lens.max())
        ids = np.full((len(batch), S), config.end_id, np.int32)
        for i, row in enumerate(batch):
            ids[i, : len(row)] = np.asarray(row, np.int32)
        cache = kv_cache.init_cache(config, len(batch), S, cache_dtype, dev)
        sink: Dict[str, List] = {}
        with _record_linear_inputs(config, params, sink):
            model.prefill(config, params, torch.from_numpy(ids).to(dev),
                          torch.from_numpy(lens).to(dev), cache, fused=False)
        for name, per_layer in sink.items():
            if any(a is None for a in per_layer):
                raise RuntimeError(f"calibration saw {name} on only some layers")
            arr = torch.stack(per_layer)
            stats[name] = arr if name not in stats else torch.maximum(stats[name], arr)
    return {k: v.cpu().numpy() for k, v in stats.items()}


def awq_search_scales(
    w,  # [K, N] float (numpy or tensor)
    amax,  # [K] activation amax per input channel
    weight_bits: int = 4,
    group_size: int = 0,
    n_grid: int = 20,
) -> np.ndarray:
    """Grid-search the AWQ exponent: s = (amax / geomean(amax))^alpha for
    alpha in [0, 1) in ``n_grid`` steps, keeping the one whose quantized
    weight has the least activation-weighted error sum((dW * amax)^2).
    Returns s [K] fp32 (ones at alpha 0). Runs on ``w``'s device; the error
    sums in fp64."""
    w = torch.as_tensor(w).float()
    amax = torch.as_tensor(np.asarray(amax, np.float32) if not torch.is_tensor(amax)
                           else amax).float().to(w.device)
    K, N = w.shape
    qmax = float(2 ** (weight_bits - 1) - 1)
    gmean = torch.exp(torch.mean(torch.log(torch.clamp(amax, min=1e-8))))
    ratio = torch.clamp(amax / torch.clamp(gmean, min=1e-8), min=1e-4)
    qmax_t = torch.tensor(qmax, device=w.device)

    def quant_err(ws, s):
        if group_size:
            g = ws.reshape(K // group_size, group_size, N)
            scale = g.abs().amax(dim=1, keepdim=True) / qmax_t
            scale = torch.where(scale > 0, scale, torch.ones_like(scale))
            deq = (torch.round(g / scale).clamp(-qmax - 1, qmax) * scale).reshape(K, N)
        else:
            scale = ws.abs().amax(dim=0, keepdim=True) / qmax_t
            scale = torch.where(scale > 0, scale, torch.ones_like(scale))
            deq = torch.round(ws / scale).clamp(-qmax - 1, qmax) * scale
        dw = deq / s[:, None] - w
        return float(((dw * amax[:, None]) ** 2).sum(dtype=torch.float64))

    best_s, best_err = torch.ones(K, device=w.device), None
    for alpha in np.linspace(0.0, 1.0, n_grid, endpoint=False):
        s = ratio ** float(alpha)
        err = quant_err(w * s[:, None], s)
        if best_err is None or err < best_err:
            best_err, best_s = err, s
    return best_s.cpu().numpy().astype(np.float32)


def apply_awq_scaling(
    config: GptNeoXConfig,
    params: Params,
    stats: Dict[str, np.ndarray],
    weight_bits: int = 4,
    group_size: int = 0,
    n_grid: int = 20,
) -> Params:
    """A copy of ``params`` with the AWQ scales folded in, fp-forward exact:
    qkv_w[l] * s, ln1_{w,b}[l] / s (and up_w with ln2; gate_w takes up_w's
    s). Quantize afterwards with ``ckpt.quantize.quantize_params``."""
    src = params["layers"]
    layers = dict(src)
    gated = ["gate_w"] if "gate_w" in src else []
    for w_key, ln_key, st_key, also in (("qkv_w", "ln1", "qkv", []),
                                        ("up_w", "ln2", "up", gated)):
        ws = {k: src[k].float().clone() for k in [w_key] + also}
        lns = {k: src[k].float().clone() for k in (f"{ln_key}_w", f"{ln_key}_b") if k in src}
        for l in range(config.layer_num):
            s = torch.from_numpy(awq_search_scales(ws[w_key][l], stats[st_key][l], weight_bits,
                                                   group_size, n_grid)).to(ws[w_key].device)
            for w in ws.values():
                w[l] *= s[:, None]
            for a in lns.values():
                a[l] /= s
        for k, v in {**ws, **lns}.items():
            layers[k] = v.to(src[k].dtype)
    return dict(params, layers=layers)
