"""Model registry (port of models/registry.py): a family contributes a
config parser, a parameter converter and the model functions its engine
drives.

Registered here: ``gptneox`` (the CodeFuse path, with the HF converters of
``ckpt/convert.py``), and the encoders ``bert`` and ``longformer``. The
JAX package's other families are ROADMAP items 17 (decoders) and 18
(encoders, encoder-decoders, vision and audio), and ``get`` refuses them.
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
    from ..ckpt import convert
    from ..core.config import GptNeoXConfig
    from . import bert, gptneox, longformer

    def gptneox_engine(cfg, params, **kw):
        from ..engine.engine import GptNeoXEngine

        return GptNeoXEngine(cfg, params, **kw)

    register(
        ModelFamily(
            name="gptneox",
            config_from_ini=GptNeoXConfig.from_ini,
            config_from_hf=convert.config_from_hf,
            params_from_hf=lambda cfg, sd, dtype="fp32", device=None: (
                convert.params_from_hf_state_dict(cfg, sd, dtype, device)
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
