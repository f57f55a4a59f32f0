"""Model registry (port of models/registry.py): a family contributes a
config parser, a parameter converter and the model functions its engine
drives.

Registered here: ``gptneox`` (the CodeFuse path, with the HF converters of
``ckpt/convert.py``); the decoder families on the same graph, under the JAX
package's names, each with its converter under ``ckpt/``: ``llama``,
``qwen2``, ``gpt`` (GPT-2), ``opt``, ``starcoder``, ``gptj`` and
``mixtral`` (``make_engine`` builds a ``GptNeoXEngine``); and the encoders
``bert`` and ``longformer``. The JAX package's encoder-decoder, vision and
audio families are ROADMAP item 18, and ``get`` refuses them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    config_from_ini: Callable[[str], Any]
    config_from_hf: Callable[[Any], Any]
    params_from_hf: Callable[..., Any]
    prefill: Callable
    decode_step: Callable = None  # encoder-only families have no decode loop
    lm_logits: Callable = None
    encode: Callable = None  # encoder families: the full bidirectional pass
    make_engine: Callable = None  # (config, params, **kw) -> engine


_REGISTRY: Dict[str, ModelFamily] = {}


def register(family: ModelFamily) -> None:
    _REGISTRY[family.name] = family


def get(name: str) -> ModelFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model family {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def families() -> Dict[str, ModelFamily]:
    return dict(_REGISTRY)


def _register_builtin() -> None:
    from ..ckpt import (
        convert,
        convert_gpt2,
        convert_gptj,
        convert_llama,
        convert_mixtral,
        convert_opt,
        convert_qwen2,
        convert_starcoder,
    )
    from ..core.config import GptNeoXConfig
    from . import bert, gptneox, longformer

    def gptneox_engine(cfg, params, **kw):
        from ..engine.engine import GptNeoXEngine

        return GptNeoXEngine(cfg, params, **kw)

    # name -> (HF config parser, HF state-dict converter): every decoder
    # family runs the GPT-NeoX graph and its engine
    decoders = {
        "gptneox": (convert.config_from_hf, convert.params_from_hf_state_dict),
        "llama": (convert_llama.config_from_hf_llama,
                  convert_llama.params_from_hf_llama_state_dict),
        "gpt": (convert_gpt2.config_from_hf_gpt2, convert_gpt2.params_from_hf_gpt2_state_dict),
        "mixtral": (convert_mixtral.config_from_hf_mixtral,
                    convert_mixtral.params_from_hf_mixtral_state_dict),
        "opt": (convert_opt.config_from_hf_opt, convert_opt.params_from_hf_opt_state_dict),
        "starcoder": (convert_starcoder.config_from_hf_starcoder,
                      convert_starcoder.params_from_hf_starcoder_state_dict),
        "qwen2": (convert_qwen2.config_from_hf_qwen2,
                  convert_qwen2.params_from_hf_qwen2_state_dict),
        "gptj": (convert_gptj.config_from_hf_gptj, convert_gptj.params_from_hf_gptj_state_dict),
    }
    for name, (config_from_hf, params_from_hf) in decoders.items():
        register(
            ModelFamily(
                name=name,
                config_from_ini=GptNeoXConfig.from_ini,
                config_from_hf=config_from_hf,
                params_from_hf=lambda cfg, sd, dtype="fp32", device=None, _f=params_from_hf: (
                    _f(cfg, sd, dtype, device)
                ),
                prefill=gptneox.prefill,
                decode_step=gptneox.decode_step,
                lm_logits=gptneox.lm_logits,
                make_engine=gptneox_engine,
            )
        )
    register(
        ModelFamily(
            name="longformer",  # sliding-window + global attention encoder
            config_from_ini=None,
            config_from_hf=longformer.config_from_hf_longformer,
            params_from_hf=lambda cfg, sd, dtype="fp32", device=None: (
                longformer.params_from_hf_longformer_state_dict(cfg, sd, dtype, device)
            ),
            prefill=longformer.encode,
            encode=longformer.encode,
            make_engine=longformer.LongformerEngine,
        )
    )
    register(
        ModelFamily(
            name="bert",
            config_from_ini=None,
            config_from_hf=bert.config_from_hf_bert,
            params_from_hf=lambda cfg, sd, dtype="fp32", device=None: (
                bert.params_from_hf_bert_state_dict(cfg, sd, dtype, device)
            ),
            prefill=bert.encode,  # bidirectional full pass
            encode=bert.encode,
            make_engine=bert.BertEngine,
        )
    )


_register_builtin()
