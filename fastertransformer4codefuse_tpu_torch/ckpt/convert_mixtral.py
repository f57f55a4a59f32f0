"""HuggingFace Mixtral -> engine parameters (port of
ckpt/convert_mixtral.py).

Mixtral is the LLaMA recipe with the dense SwiGLU FFN replaced by a top-k
of E sparse MoE block (``ops.moe.moe_ffn``): a router ([H, E]) and the
experts' kernels stacked [E, in, out] per layer. HF's expert names: w1 the
gate, w2 down, w3 up; the router renormalizes its top-k weights as
``moe_ffn`` does.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from ..core.config import GptNeoXConfig
from ..models.params import Params
from .convert_llama import config_from_hf_llama, llama_params


def config_from_hf_mixtral(hf_config, model_name: str = "mixtral") -> GptNeoXConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    return config_from_hf_llama(
        hf_config, model_name,
        rotary_base=float(g("rope_theta", 1000000.0)),
        moe_experts=g("num_local_experts"),
        moe_top_k=g("num_experts_per_tok", 2),
    )


def params_from_hf_mixtral_state_dict(
    config: GptNeoXConfig, state_dict: Mapping[str, Any], dtype="fp32", device=None
) -> Params:
    E = config.moe_experts

    def ffn(get, stack):
        pre = "model.layers.{}.block_sparse_moe."

        def experts(i, which):  # [E, in, out]
            return np.stack([get(pre.format(i) + f"experts.{j}.{which}.weight").T
                             for j in range(E)])

        return {
            "router_w": stack(lambda i: get(pre.format(i) + "gate.weight").T),
            "egate_w": stack(lambda i: experts(i, "w1")),
            "eup_w": stack(lambda i: experts(i, "w3")),
            "edown_w": stack(lambda i: experts(i, "w2")),
        }

    return llama_params(config, state_dict, dtype, device, ffn)
