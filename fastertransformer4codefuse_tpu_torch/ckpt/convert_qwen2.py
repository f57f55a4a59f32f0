"""HuggingFace Qwen2 -> engine parameters (port of ckpt/convert_qwen2.py).

Qwen2 (Qwen2.5, Qwen2.5-Coder) is the LLaMA recipe with biases on q, k and
v only (``qkv_bias=True``, ``use_bias=False``) and a large ``rope_theta``
(1e6): RMSNorm, SwiGLU and GQA ride the shared block as for LLaMA.
"""
from __future__ import annotations

from typing import Any, Mapping

from ..core.config import GptNeoXConfig
from ..models.params import Params
from .convert_llama import config_from_hf_llama, llama_params, swiglu_ffn


def config_from_hf_qwen2(hf_config, model_name: str = "qwen2") -> GptNeoXConfig:
    return config_from_hf_llama(
        hf_config, model_name,
        rotary_base=float(getattr(hf_config, "rope_theta", 1000000.0)),
        qkv_bias=bool(getattr(hf_config, "attention_bias", True)),
    )


def params_from_hf_qwen2_state_dict(
    config: GptNeoXConfig, state_dict: Mapping[str, Any], dtype="fp32", device=None
) -> Params:
    return llama_params(config, state_dict, dtype, device, swiglu_ffn)
