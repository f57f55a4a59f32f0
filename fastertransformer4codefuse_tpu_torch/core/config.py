"""Model and runtime configuration (PyTorch port).

Stdlib copy of ``fastertransformer4codefuse_tpu/core/config.py``: the same
``GptNeoXConfig`` fields, presets and byte-compatible ``config.ini`` round
trip. ``RuntimeConfig`` keeps the serving knobs and drops the TPU-only ones
(Pallas and flash gates): on CUDA every kernel of the slice is always on, and
dispatch follows the tensor's device. ``fused_decode`` chooses between the
fused decode route (K13 + K3) and the unfused GEMMs.
"""
from __future__ import annotations

import dataclasses
import os
from configparser import ConfigParser
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GptNeoXConfig:
    """Architecture hyper-parameters of a GPT-NeoX family model.

    Mirrors the fields of the reference ``config.ini`` ``[gptneox]`` section
    plus the numerically relevant constants the reference hardcodes
    (layernorm eps 1e-5, rotary base 10000).
    """

    head_num: int
    size_per_head: int
    layer_num: int
    vocab_size: int
    rotary_embedding_dim: int
    start_id: int
    end_id: int
    inter_size: Optional[int] = None  # defaults to 4*hidden
    use_gptj_residual: bool = True
    layernorm_eps: float = 1e-5
    rotary_base: float = 10000.0
    activation: str = "gelu"  # "gelu" (exact) | "gelu-tanh" | "relu" | "silu"
    rotary_style: str = "neox"  # "neox" half-split | "gptj" interleaved pairs
    model_name: str = "gptneox"
    weight_data_type: str = "fp32"
    norm: str = "layernorm"  # | "rmsnorm"
    gated_ffn: bool = False  # SwiGLU: h = act(x@gate) * (x@up)
    kv_head_num: Optional[int] = None  # GQA: KV heads < query heads
    use_bias: bool = True
    qkv_bias: bool = False  # bias on the fused QKV only (Qwen2 layout)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    position_embedding: str = "rope"  # | "learned"
    qkv_layout: str = "interleaved"  # (head, qkv, dh) | "concat" [q | k | v]

    def __post_init__(self):
        if self.inter_size is None:
            object.__setattr__(self, "inter_size", 4 * self.hidden_size)
        if self.kv_head_num is not None and self.kv_head_num != self.head_num:
            if self.qkv_layout != "concat":
                raise ValueError("GQA requires qkv_layout='concat'")
            if self.head_num % self.kv_head_num:
                raise ValueError("head_num must be a multiple of kv_head_num")

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head

    @property
    def num_heads(self) -> int:
        return self.head_num

    @property
    def kv_heads(self) -> int:
        return self.kv_head_num if self.kv_head_num is not None else self.head_num

    @property
    def qkv_cols(self) -> int:
        """Total fused-QKV output width: (nH + 2*nKV) * dh."""
        return (self.head_num + 2 * self.kv_heads) * self.size_per_head

    @property
    def head_dim(self) -> int:
        return self.size_per_head

    # ------------------------------------------------------------------ io ---
    @classmethod
    def from_ini(cls, path: str, section: str = "gptneox") -> "GptNeoXConfig":
        """Read a reference-format ``config.ini`` (possibly inside a ckpt dir)."""
        if os.path.isdir(path):
            path = os.path.join(path, "config.ini")
        cfg = ConfigParser()
        if not cfg.read(path):
            raise FileNotFoundError(f"config.ini not found at {path}")
        sec = cfg[section]
        return cls(
            head_num=int(sec["head_num"]),
            size_per_head=int(sec["size_per_head"]),
            inter_size=int(sec["inter_size"]) if "inter_size" in sec else None,
            layer_num=int(sec["num_layer"]),
            rotary_embedding_dim=int(sec["rotary_embedding"]),
            vocab_size=int(sec["vocab_size"]),
            start_id=int(sec["start_id"]),
            end_id=int(sec["end_id"]),
            use_gptj_residual=sec.get("use_gptj_residual", "1") == "1",
            model_name=sec.get("model_name", "gptneox"),
            weight_data_type=sec.get("weight_data_type", "fp32"),
            layernorm_eps=float(sec.get("layernorm_eps", "1e-5")),
            rotary_base=float(sec.get("rotary_base", "10000.0")),
            rotary_style=sec.get("rotary_style", "neox"),
            activation=sec.get("activation", "gelu"),
            norm=sec.get("norm", "layernorm"),
            gated_ffn=sec.get("gated_ffn", "0") == "1",
            kv_head_num=int(sec["kv_head_num"]) if "kv_head_num" in sec else None,
            use_bias=sec.get("use_bias", "1") == "1",
            qkv_bias=sec.get("qkv_bias", "0") == "1",
            position_embedding=sec.get("position_embedding", "rope"),
            moe_experts=int(sec.get("moe_experts", "0")),
            moe_top_k=int(sec.get("moe_top_k", "2")),
            moe_capacity_factor=float(sec.get("moe_capacity_factor", "2.0")),
            qkv_layout=sec.get("qkv_layout", "interleaved"),
        )

    def to_ini(self, path: str, section: str = "gptneox") -> None:
        if os.path.isdir(path):
            path = os.path.join(path, "config.ini")
        cfg = ConfigParser()
        cfg[section] = {
            "model_name": self.model_name,
            "head_num": str(self.head_num),
            "size_per_head": str(self.size_per_head),
            "inter_size": str(self.inter_size),
            "num_layer": str(self.layer_num),
            "rotary_embedding": str(self.rotary_embedding_dim),
            "vocab_size": str(self.vocab_size),
            "start_id": str(self.start_id),
            "end_id": str(self.end_id),
            "use_gptj_residual": "1" if self.use_gptj_residual else "0",
            "weight_data_type": self.weight_data_type,
        }
        # non-default knobs only, so a reference-converted GPT-NeoX config.ini
        # stays byte-identical to what the reference converter emits
        defaults = {
            "rotary_style": "neox",
            "activation": "gelu",
            "layernorm_eps": 1e-5,
            "rotary_base": 10000.0,
            "norm": "layernorm",
            "gated_ffn": False,
            "kv_head_num": None,
            "use_bias": True,
            "qkv_bias": False,
            "position_embedding": "rope",
            "moe_experts": 0,
            "moe_top_k": 2,
            "moe_capacity_factor": 2.0,
            "qkv_layout": "interleaved",
        }
        for key, default in defaults.items():
            value = getattr(self, key)
            if value != default:
                if isinstance(value, bool):
                    cfg[section][key] = "1" if value else "0"
                elif isinstance(value, float):
                    cfg[section][key] = repr(value)
                else:
                    cfg[section][key] = str(value)
        with open(path, "w") as f:
            cfg.write(f)

    # ----------------------------------------------------------- presets ---
    @classmethod
    def codefuse_13b(cls) -> "GptNeoXConfig":
        """CodeFuse-13B with the reference engine's serving numerics: its FFN
        kernel hardcodes the tanh-approximate gelu."""
        return cls(
            head_num=40,
            size_per_head=128,
            layer_num=40,
            vocab_size=100831,
            rotary_embedding_dim=128,
            inter_size=20480,
            start_id=100256,
            end_id=100256,
            use_gptj_residual=True,
            activation="gelu-tanh",
            model_name="codefuse-13b",
        )

    @classmethod
    def pythia_1_4b(cls) -> "GptNeoXConfig":
        return cls(
            head_num=16,
            size_per_head=128,
            layer_num=24,
            vocab_size=50304,
            rotary_embedding_dim=32,  # rotary_pct 0.25
            inter_size=8192,
            start_id=0,
            end_id=0,
            use_gptj_residual=True,
            model_name="pythia-1.4b",
        )

    @classmethod
    def tiny(cls, **overrides) -> "GptNeoXConfig":
        """A tiny config for unit tests."""
        kw = dict(
            head_num=4,
            size_per_head=16,
            layer_num=2,
            vocab_size=128,
            rotary_embedding_dim=4,
            inter_size=256,
            start_id=0,
            end_id=1,
            use_gptj_residual=True,
            model_name="tiny",
        )
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Engine runtime knobs.

    Attributes:
      dtype: activation/weight compute dtype ("bf16" | "fp32"; "fp16" is an
        alias of bf16, as in the JAX package).
      int8_mode: 0 = dense, 1 = weight-only int8 with per-output-channel scales.
      kv_cache_dtype: KV cache dtype ("int8" adds one bf16 scale per cached
        vector; "int4" packs K and V two positions a byte with the same
        scales, "int8k_int4v" packs only V); None = ``dtype``.
      seq_bucket: the padded prefill width is rounded up to a multiple of this.
      tensor_para_size / data_para_size: the parallel layout the engine's
        ``mesh`` gives (``parallel/``).
      pipeline_para_size: the pp stage count; where it is above 1 the engine
        checks that its ``mesh`` has that many stages (layers and KV cache
        split into contiguous blocks a stage, ``parallel/pipeline.py``, the
        reference's pipeline_para_size_).
      pp_microbatches: M, the microbatches a forward under pp pipelines
        (GptNeoX.cc:780-788 getLocalBatchSize): prefill splits the sequence
        into M chunks, decode the batch rows into M groups, so that stage s
        runs microbatch m while stage s - 1 runs m + 1. M falls back to 1
        where it does not divide the padded width (prefill) or the batch
        (decode). 1 is the serial schedule.
      act_int8: SmoothQuant W8A8 (the reference's int8_mode=2 semantics): with
        int8 per-channel weights, the GEMMs of sequence-wide calls of at least
        16 rows (prefill, chunk ticks, speculative verifies) quantize their
        activations per token and run an int8 x int8 product
        (``ops.linear.w8a8_matmul``); decode-width calls, int4 and group-wise
        weights stay weight-only. The flag is the engine's own: the forward
        carries it, no process-wide state.
      debug_level: "DEBUG" (or, when empty, the ``FT_DEBUG_LEVEL`` environment
        variable set to DEBUG) makes ``generate`` first sweep the weights and
        run a checked prefill and decode step (``utils/debug.py``).
      fused_decode: a parallel-residual layer with its four big kernels
        quantized alike runs QKV and up as one K13 launch (decode, prefill
        and chunk ticks) and, in decode, proj + down + bias + residual as K3;
        False runs the unfused GEMMs (K1/K6/K7).

    Logits are always fp32, as in the reference.
    """

    dtype: str = "bf16"
    int8_mode: int = 0
    kv_cache_dtype: Optional[str] = None
    seq_bucket: int = 128
    tensor_para_size: int = 1
    data_para_size: int = 1
    pipeline_para_size: int = 1
    pp_microbatches: int = 1
    debug_level: str = ""
    fused_decode: bool = True
    act_int8: bool = False

    def debug_enabled(self) -> bool:
        lvl = self.debug_level or os.environ.get("FT_DEBUG_LEVEL", "")
        return lvl.upper() == "DEBUG"
