"""HuggingFace GPT-J -> engine parameters (port of ckpt/convert_gptj.py).

GPT-J is the origin of the parallel residual: x + attn(ln(x)) + mlp(ln(x))
with one LayerNorm, which the shared block reproduces with ln2 := ln1 (the
same parameters give the same normalization). Rotary in GPT-J's style
(interleaved pairs) over ``rotary_dim`` of the head; the fused QKV in the
interleaved (head, qkv, dh) layout; ``down_b`` = fc_out's bias (out_proj has
none, so the summed residual bias is the MLP's); an LM-head bias. The q, k
and v projections are bias-free: the JAX converter stores a zero ``qkv_b``,
the port stores none (adding zeros changes nothing), so K13 runs without a
QKV bias.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..core.device import resolve_device
from ..core.dtypes import torch_dtype
from ..models.params import Params
from .convert import _np, stack_layers


def config_from_hf_gptj(hf_config, model_name: str = "gptj") -> GptNeoXConfig:
    g = lambda k: getattr(hf_config, k)  # noqa: E731
    n_embd, n_head = g("n_embd"), g("n_head")
    return GptNeoXConfig(
        head_num=n_head,
        size_per_head=n_embd // n_head,
        inter_size=g("n_inner") or 4 * n_embd,
        layer_num=g("n_layer"),
        rotary_embedding_dim=g("rotary_dim") or (n_embd // n_head),
        vocab_size=g("vocab_size"),
        start_id=g("bos_token_id") or 0,
        end_id=g("eos_token_id") or 0,
        use_gptj_residual=True,
        layernorm_eps=float(g("layer_norm_epsilon")),
        activation={"gelu_new": "gelu-tanh", "gelu": "gelu"}.get(g("activation_function"),
                                                                 "gelu-tanh"),
        rotary_style="gptj",
        model_name=model_name,
    )


def params_from_hf_gptj_state_dict(
    config: GptNeoXConfig, state_dict: Mapping[str, Any], dtype="fp32", device=None
) -> Params:
    device = resolve_device(device)
    L, H = config.layer_num, config.hidden_size
    nH, dh = config.head_num, config.size_per_head

    def get(name):
        return _np(state_dict[name])

    def stack(fn):
        return stack_layers(fn, L, dtype, device)

    def layer(name, kernel=False):
        return stack(lambda i: get(f"transformer.h.{i}.{name}").T if kernel
                     else get(f"transformer.h.{i}.{name}"))

    def tensor(a):
        return torch.from_numpy(a).to(device=device, dtype=torch_dtype(dtype))

    def fused_qkv(i):
        # q/k/v Linears [H_out, H_in] -> [H, (head, qkv, dh)]
        w = [get(f"transformer.h.{i}.attn.{n}_proj.weight").T.reshape(H, nH, dh)
             for n in "qkv"]
        return np.stack(w, axis=2).reshape(H, 3 * nH * dh)

    layers = {
        "ln1_w": layer("ln_1.weight"),
        "ln1_b": layer("ln_1.bias"),
        "ln2_w": layer("ln_1.weight"),  # the one LayerNorm, shared
        "ln2_b": layer("ln_1.bias"),
        "qkv_w": stack(fused_qkv),
        "proj_w": layer("attn.out_proj.weight", True),
        "up_w": layer("mlp.fc_in.weight", True),
        "up_b": layer("mlp.fc_in.bias"),
        "down_w": layer("mlp.fc_out.weight", True),
        "down_b": layer("mlp.fc_out.bias"),
    }
    return {
        "embed": tensor(get("transformer.wte.weight")),
        "layers": layers,
        "final_ln_w": tensor(get("transformer.ln_f.weight")),
        "final_ln_b": tensor(get("transformer.ln_f.bias")),
        "lm_head": tensor(get("lm_head.weight")),  # [V, H]
        "lm_head_b": tensor(get("lm_head.bias")),
    }
