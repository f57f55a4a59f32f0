"""HuggingFace LLaMA -> engine parameters (port of ckpt/convert_llama.py).

The shared GPT-NeoX block serves LLaMA (and CodeLlama) with RMSNorm, a
serial residual, a gated FFN (SwiGLU: silu(x @ gate) * (x @ up) @ down), no
biases, the concat QKV layout with ``kv_head_num`` for grouped-query
attention, and rotary over the whole head in the half-split (HF
``rotate_half``) style.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from ..core.config import GptNeoXConfig
from ..core.device import resolve_device
from ..core.dtypes import torch_dtype
from ..models.params import Params
from .convert import _np, fused_qkv_bias_concat, fused_qkv_concat, stack_layers


def config_from_hf_llama(hf_config, model_name: str = "llama", **over) -> GptNeoXConfig:
    """A GptNeoXConfig from an HF LlamaConfig (or anything with its
    attribute names); ``over`` sets the fields Qwen2 and Mixtral change."""
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    H = g("hidden_size")
    nH = g("num_attention_heads")
    nKV = g("num_key_value_heads", nH) or nH
    dh = g("head_dim", None) or H // nH
    fields = dict(
        head_num=nH,
        size_per_head=dh,
        inter_size=g("intermediate_size"),
        layer_num=g("num_hidden_layers"),
        rotary_embedding_dim=dh,
        vocab_size=g("vocab_size"),
        start_id=g("bos_token_id") or 1,
        end_id=g("eos_token_id") or 2,
        use_gptj_residual=False,
        layernorm_eps=float(g("rms_norm_eps")),
        rotary_base=float(g("rope_theta", 10000.0)),
        activation={"silu": "silu", "gelu": "gelu"}.get(g("hidden_act"), "silu"),
        rotary_style="neox",
        norm="rmsnorm",
        gated_ffn=True,
        kv_head_num=nKV,
        use_bias=False,
        qkv_layout="concat",
        model_name=model_name,
    )
    fields.update(over)
    return GptNeoXConfig(**fields)


def llama_params(config: GptNeoXConfig, state_dict: Mapping[str, Any], dtype, device,
                 ffn) -> Params:
    """The LLaMA-lineage layout under HF's ``model.layers.{i}`` names:
    norms, the concat QKV (with its bias under ``qkv_bias``), o_proj, and
    the FFN keys ``ffn(get, stack)`` returns; the head tied to the
    embedding when the checkpoint has no ``lm_head.weight``."""
    device = resolve_device(device)
    L = config.layer_num

    def get(name):
        return _np(state_dict[name])

    def stack(fn):
        return stack_layers(fn, L, dtype, device)

    def tensor(a):
        return torch.from_numpy(a).to(device=device, dtype=torch_dtype(dtype))

    pre = "model.layers.{}."
    layers = {
        "ln1_w": stack(lambda i: get(pre.format(i) + "input_layernorm.weight")),
        "ln2_w": stack(lambda i: get(pre.format(i) + "post_attention_layernorm.weight")),
        "qkv_w": stack(lambda i: fused_qkv_concat(get, i)),
        "proj_w": stack(lambda i: get(pre.format(i) + "self_attn.o_proj.weight").T),
        **ffn(get, stack),
    }
    if config.qkv_bias:
        layers["qkv_b"] = stack(lambda i: fused_qkv_bias_concat(get, i))
    embed = get("model.embed_tokens.weight")
    lm_head = get("lm_head.weight") if "lm_head.weight" in state_dict else embed
    return {
        "embed": tensor(embed),
        "layers": layers,
        "final_ln_w": tensor(get("model.norm.weight")),
        "lm_head": tensor(lm_head),  # [V, H]
    }


def swiglu_ffn(get, stack):
    """A dense SwiGLU FFN's gate, up and down kernels, [in, out]."""
    pre = "model.layers.{}.mlp."
    return {
        "gate_w": stack(lambda i: get(pre.format(i) + "gate_proj.weight").T),
        "up_w": stack(lambda i: get(pre.format(i) + "up_proj.weight").T),
        "down_w": stack(lambda i: get(pre.format(i) + "down_proj.weight").T),
    }


def params_from_hf_llama_state_dict(
    config: GptNeoXConfig, state_dict: Mapping[str, Any], dtype="fp32", device=None
) -> Params:
    """An HF LlamaForCausalLM state dict -> the engine's parameter dict, in
    ``dtype`` on ``device`` (the card when None)."""
    return llama_params(config, state_dict, dtype, device, swiglu_ffn)
