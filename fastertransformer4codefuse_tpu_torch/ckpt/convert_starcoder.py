"""HuggingFace GPTBigCode (StarCoder) -> engine parameters (port of
ckpt/convert_starcoder.py).

StarCoder is the GPT-2 recipe (learned absolute positions, serial
residual, biased LayerNorms and projections, tanh-gelu) with multi-query
attention: one K/V head behind n_head query heads, c_attn emitting [q (nH
dh) | k (dh) | v (dh)] (``kv_head_num=1``, ``qkv_layout="concat"``; K4, K5,
K9 and K10 group the nH query heads on the one KV head). GPTBigCode stores
nn.Linear kernels, [out, in]: each is transposed.
"""
from __future__ import annotations

from typing import Any, Mapping

from ..core.config import GptNeoXConfig
from ..models.params import Params
from .convert_gpt2 import config_from_hf_gpt2, gpt2_lineage_params


def config_from_hf_starcoder(hf_config, model_name: str = "starcoder") -> GptNeoXConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    return config_from_hf_gpt2(
        hf_config, model_name,
        start_id=g("bos_token_id") or 0,
        end_id=g("eos_token_id") or 0,
        activation={"gelu_pytorch_tanh": "gelu-tanh", "gelu_new": "gelu-tanh", "gelu": "gelu",
                    "relu": "relu"}.get(g("activation_function", "gelu_pytorch_tanh"),
                                        "gelu-tanh"),
        kv_head_num=1 if bool(g("multi_query", True)) else None,
    )


def params_from_hf_starcoder_state_dict(
    config: GptNeoXConfig, state_dict: Mapping[str, Any], dtype="fp32", device=None
) -> Params:
    return gpt2_lineage_params(config, state_dict, dtype, device, transpose=True)
