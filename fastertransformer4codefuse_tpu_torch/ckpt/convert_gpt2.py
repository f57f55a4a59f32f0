"""HuggingFace GPT-2 -> engine parameters, the "gpt" family (port of
ckpt/convert_gpt2.py).

GPT-2 rides the shared block with learned absolute positions
(``pos_embed`` = wpe, ``rotary_embedding_dim=0``), a serial residual,
LayerNorms and projections with biases, the concat QKV layout (c_attn
already emits [q | k | v]), tanh-gelu and the head tied to wte. HF stores
the projections as Conv1D, [in, out]: the engine's layout, no transposes.
``gpt2_lineage_params`` also serves StarCoder (``convert_starcoder``).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from ..core.config import GptNeoXConfig
from ..core.device import resolve_device
from ..core.dtypes import torch_dtype
from ..models.params import Params
from .convert import _np, stack_layers

_ACTS = {"gelu_new": "gelu-tanh", "gelu_pytorch_tanh": "gelu-tanh", "gelu": "gelu",
         "relu": "relu"}


def config_from_hf_gpt2(hf_config, model_name: str = "gpt", **over) -> GptNeoXConfig:
    """A GptNeoXConfig from an HF GPT2Config (or anything with its
    attribute names); ``over`` sets the fields StarCoder changes."""
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    H = g("hidden_size") or g("n_embd")
    nH = g("num_attention_heads") or g("n_head")
    fields = dict(
        head_num=nH,
        size_per_head=H // nH,
        inter_size=g("n_inner") or 4 * H,
        layer_num=g("num_hidden_layers") or g("n_layer"),
        rotary_embedding_dim=0,
        vocab_size=g("vocab_size"),
        start_id=g("bos_token_id") or 50256,
        end_id=g("eos_token_id") or 50256,
        use_gptj_residual=False,
        layernorm_eps=float(g("layer_norm_epsilon", 1e-5)),
        activation=_ACTS.get(g("activation_function", "gelu_new"), "gelu-tanh"),
        position_embedding="learned",
        qkv_layout="concat",
        model_name=model_name,
    )
    fields.update(over)
    return GptNeoXConfig(**fields)


def gpt2_lineage_params(config: GptNeoXConfig, state_dict: Mapping[str, Any], dtype, device,
                        transpose: bool) -> Params:
    """GPT-2's and GPTBigCode's names (``h.{i}`` under an optional
    ``transformer.`` prefix); ``transpose``: nn.Linear [out, in] kernels
    (GPTBigCode) rather than Conv1D [in, out] ones (GPT-2). The head is
    ``lm_head.weight`` where the checkpoint has one, else tied to wte."""
    device = resolve_device(device)
    L = config.layer_num
    pre = "transformer." if "transformer.wte.weight" in state_dict else ""

    def get(name):
        return _np(state_dict[pre + name])

    def stack(name, kernel=False):
        def one(i):
            a = get(f"h.{i}.{name}")
            return a.T if kernel and transpose else a
        return stack_layers(one, L, dtype, device)

    def tensor(a):
        return torch.from_numpy(a).to(device=device, dtype=torch_dtype(dtype))

    layers = {
        "ln1_w": stack("ln_1.weight"), "ln1_b": stack("ln_1.bias"),
        "ln2_w": stack("ln_2.weight"), "ln2_b": stack("ln_2.bias"),
        "qkv_w": stack("attn.c_attn.weight", True), "qkv_b": stack("attn.c_attn.bias"),
        "proj_w": stack("attn.c_proj.weight", True), "proj_b": stack("attn.c_proj.bias"),
        "up_w": stack("mlp.c_fc.weight", True), "up_b": stack("mlp.c_fc.bias"),
        "down_w": stack("mlp.c_proj.weight", True), "down_b": stack("mlp.c_proj.bias"),
    }
    embed = get("wte.weight")
    # the head sits outside the transformer. prefix
    lm_head = _np(state_dict["lm_head.weight"]) if "lm_head.weight" in state_dict else embed
    return {
        "embed": tensor(embed),
        "pos_embed": tensor(get("wpe.weight")),
        "layers": layers,
        "final_ln_w": tensor(get("ln_f.weight")),
        "final_ln_b": tensor(get("ln_f.bias")),
        "lm_head": tensor(lm_head),  # [V, H]
    }


def params_from_hf_gpt2_state_dict(
    config: GptNeoXConfig, state_dict: Mapping[str, Any], dtype="fp32", device=None
) -> Params:
    """An HF GPT2LMHeadModel state dict -> the engine's parameter dict (the
    head tied to wte, as GPT-2's is)."""
    sd = {k: v for k, v in state_dict.items() if k != "lm_head.weight"}
    return gpt2_lineage_params(config, sd, dtype, device, transpose=False)
