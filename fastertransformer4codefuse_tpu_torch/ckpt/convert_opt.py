"""HuggingFace OPT -> engine parameters (port of ckpt/convert_opt.py).

OPT: learned absolute positions, serial pre-LN residuals, separate q/k/v
Linears with biases (fused into the concat QKV), ReLU. HF's position table
adds 2 to every position id: the converter drops its first two rows, so the
engine's plain lookup lands on the right rows. Only ``do_layer_norm_before``
configs whose word embedding is the hidden width (every OPT but 350M); the
head untied where the checkpoint carries one.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..core.device import resolve_device
from ..core.dtypes import torch_dtype
from ..models.params import Params
from .convert import _np, fused_qkv_bias_concat, fused_qkv_concat, stack_layers


def config_from_hf_opt(hf_config, model_name: str = "opt") -> GptNeoXConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    H = g("hidden_size")
    if g("word_embed_proj_dim", H) != H:
        raise ValueError("OPT-350M's word-embedding projection is not supported")
    if not g("do_layer_norm_before", True):
        raise ValueError("post-LN OPT variants are not supported")
    nH = g("num_attention_heads")
    return GptNeoXConfig(
        head_num=nH,
        size_per_head=H // nH,
        inter_size=g("ffn_dim"),
        layer_num=g("num_hidden_layers"),
        rotary_embedding_dim=0,
        vocab_size=g("vocab_size"),
        # `or 2` would remap a legitimate token id 0
        start_id=g("bos_token_id") if g("bos_token_id") is not None else 2,
        end_id=g("eos_token_id") if g("eos_token_id") is not None else 2,
        use_gptj_residual=False,
        layernorm_eps=1e-5,
        activation={"relu": "relu", "gelu": "gelu"}.get(g("activation_function", "relu"),
                                                          "relu"),
        position_embedding="learned",
        qkv_layout="concat",
        model_name=model_name,
    )


def params_from_hf_opt_state_dict(
    config: GptNeoXConfig, state_dict: Mapping[str, Any], dtype="fp32", device=None
) -> Params:
    device = resolve_device(device)
    L = config.layer_num
    pre = "model.decoder." if "model.decoder.embed_tokens.weight" in state_dict else "decoder."

    def get(name):
        return _np(state_dict[pre + name])

    def stack(fn):
        return stack_layers(fn, L, dtype, device)

    def layer(name, kernel=False):
        return stack(lambda i: get(f"layers.{i}.{name}").T if kernel
                     else get(f"layers.{i}.{name}"))

    def tensor(a):
        return torch.from_numpy(a).to(device=device, dtype=torch_dtype(dtype))

    attn = "layers.{}.self_attn."
    layers = {
        "ln1_w": layer("self_attn_layer_norm.weight"),
        "ln1_b": layer("self_attn_layer_norm.bias"),
        "ln2_w": layer("final_layer_norm.weight"),
        "ln2_b": layer("final_layer_norm.bias"),
        "qkv_w": stack(lambda i: fused_qkv_concat(get, i, attn)),
        "qkv_b": stack(lambda i: fused_qkv_bias_concat(get, i, attn)),
        "proj_w": layer("self_attn.out_proj.weight", True),
        "proj_b": layer("self_attn.out_proj.bias"),
        "up_w": layer("fc1.weight", True),
        "up_b": layer("fc1.bias"),
        "down_w": layer("fc2.weight", True),
        "down_b": layer("fc2.bias"),
    }
    embed = get("embed_tokens.weight")
    lm_head = _np(state_dict["lm_head.weight"]) if "lm_head.weight" in state_dict else embed
    return {
        "embed": tensor(embed),
        # the two offset rows dropped (HF adds 2 to every position id)
        "pos_embed": tensor(np.ascontiguousarray(get("embed_positions.weight")[2:])),
        "layers": layers,
        "final_ln_w": tensor(get("final_layer_norm.weight")),
        "final_ln_b": tensor(get("final_layer_norm.bias")),
        "lm_head": tensor(lm_head),
    }
