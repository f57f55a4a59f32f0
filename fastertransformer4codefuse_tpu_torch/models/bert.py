"""BERT encoder (port of models/bert.py).

  - post-LayerNorm residuals: h = LN(x + attn), out = LN(h + ffn);
  - bidirectional attention, masked on padded keys, no KV cache;
  - learned absolute positions, token-type (segment) embeddings and an
    embedding LayerNorm;
  - tanh pooler over [CLS] (HF BertPooler).

The four GEMMs of a layer go through ``ops.linear``: with
``quantize_bert_params`` (int8 per output channel) they run K1 on the card.
The attention stays plain PyTorch, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.layernorm import layernorm
from ..ops.linear import linear
from .params import layer_slice

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    head_num: int
    size_per_head: int
    layer_num: int
    vocab_size: int
    max_position_embeddings: int
    type_vocab_size: int = 2
    inter_size: Optional[int] = None
    layernorm_eps: float = 1e-12
    activation: str = "gelu"
    model_name: str = "bert"

    def __post_init__(self):
        if self.inter_size is None:
            object.__setattr__(self, "inter_size", 4 * self.hidden_size)

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head


def config_from_hf_bert(hf_config, model_name: str = "bert") -> BertConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    nH = g("num_attention_heads")
    H = g("hidden_size")
    return BertConfig(
        head_num=nH,
        size_per_head=H // nH,
        layer_num=g("num_hidden_layers"),
        vocab_size=g("vocab_size"),
        max_position_embeddings=g("max_position_embeddings"),
        type_vocab_size=g("type_vocab_size", 2),
        inter_size=g("intermediate_size"),
        layernorm_eps=float(g("layer_norm_eps", 1e-12)),
        activation={"gelu": "gelu", "gelu_new": "gelu-tanh",
                    "relu": "relu"}.get(g("hidden_act", "gelu"), "gelu"),
        model_name=model_name,
    )


def params_from_hf_bert_state_dict(
    config: BertConfig, state_dict: Mapping[str, Any], dtype=torch.float32, device=None
) -> Dict[str, Any]:
    """HF ``BertModel`` weights (torch or numpy) -> the stacked params dict
    with a fused [H, q | k | v] QKV kernel, in ``dtype`` on ``device`` (the
    CUDA card when None)."""
    from ..ckpt.convert import _np, stack_layers
    from ..core.dtypes import torch_dtype

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    sd = dict(state_dict)
    pre = "bert." if "bert.embeddings.word_embeddings.weight" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    def stack(fn):
        return stack_layers(fn, config.layer_num, dtype, device)

    def dense(a):
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def lw(i, name):
        return get(f"encoder.layer.{i}.{name}")

    def fused_qkv(i):
        return np.concatenate([lw(i, f"attention.self.{n}.weight").T
                               for n in ("query", "key", "value")], axis=1)

    def fused_qkv_b(i):
        return np.concatenate([lw(i, f"attention.self.{n}.bias")
                               for n in ("query", "key", "value")])

    layers = {
        "qkv_w": stack(fused_qkv),
        "qkv_b": stack(fused_qkv_b),
        "proj_w": stack(lambda i: lw(i, "attention.output.dense.weight").T),
        "proj_b": stack(lambda i: lw(i, "attention.output.dense.bias")),
        "attn_ln_w": stack(lambda i: lw(i, "attention.output.LayerNorm.weight")),
        "attn_ln_b": stack(lambda i: lw(i, "attention.output.LayerNorm.bias")),
        "up_w": stack(lambda i: lw(i, "intermediate.dense.weight").T),
        "up_b": stack(lambda i: lw(i, "intermediate.dense.bias")),
        "down_w": stack(lambda i: lw(i, "output.dense.weight").T),
        "down_b": stack(lambda i: lw(i, "output.dense.bias")),
        "out_ln_w": stack(lambda i: lw(i, "output.LayerNorm.weight")),
        "out_ln_b": stack(lambda i: lw(i, "output.LayerNorm.bias")),
    }
    out = {
        "embed": dense(get("embeddings.word_embeddings.weight")),
        "pos_embed": dense(get("embeddings.position_embeddings.weight")),
        "type_embed": dense(get("embeddings.token_type_embeddings.weight")),
        "embed_ln_w": dense(get("embeddings.LayerNorm.weight")),
        "embed_ln_b": dense(get("embeddings.LayerNorm.bias")),
        "layers": layers,
    }
    if pre + "pooler.dense.weight" in sd:
        out["pooler_w"] = dense(get("pooler.dense.weight").T)
        out["pooler_b"] = dense(get("pooler.dense.bias"))
    return out


def _block(config: BertConfig, lp, x, mask):
    """One post-LN encoder block. x [B, S, H]; mask [B, 1, 1, S] additive."""
    B, S, H = x.shape
    nH, dh = config.head_num, config.size_per_head
    qkv = linear(x, lp["qkv_w"], lp["qkv_b"])  # [B, S, 3H]
    q = qkv[..., :H].reshape(B, S, nH, dh)
    k = qkv[..., H: 2 * H].reshape(B, S, nH, dh)
    v = qkv[..., 2 * H:].reshape(B, S, nH, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (dh ** 0.5)
    probs = torch.softmax(scores + mask, dim=-1).to(x.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
    attn = linear(attn.reshape(B, S, H), lp["proj_w"], lp["proj_b"])
    h = layernorm(x + attn, lp["attn_ln_w"], lp["attn_ln_b"], config.layernorm_eps)
    ffn = linear(h, lp["up_w"], lp["up_b"], act=config.activation)
    ffn = linear(ffn, lp["down_w"], lp["down_b"])
    return layernorm(h + ffn, lp["out_ln_w"], lp["out_ln_b"], config.layernorm_eps)


def encode(
    config: BertConfig,
    params: Dict[str, Any],
    input_ids: torch.Tensor,  # [B, S] integer
    lengths: torch.Tensor,  # [B]: the padding mask
    token_type_ids: Optional[torch.Tensor] = None,  # [B, S]
):
    """Full encoder pass -> (last_hidden [B, S, H], pooled [B, H] or None).
    Bidirectional: every real token attends every real token. Runs on the
    device of ``params``."""
    dev = params["embed"].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev)
    B, S = input_ids.shape
    x = params["embed"][input_ids] + params["pos_embed"][None, :S]
    tt = (torch.zeros((B, S), dtype=torch.long, device=dev) if token_type_ids is None
          else torch.as_tensor(token_type_ids, device=dev).long())
    x = x + params["type_embed"][tt]
    x = layernorm(x, params["embed_ln_w"], params["embed_ln_b"], config.layernorm_eps)

    pad = torch.arange(S, device=dev)[None, :] < lengths[:, None]  # [B, S]
    mask = torch.where(pad, 0.0, MASK_VALUE)[:, None, None, :]  # keys masked, fp32

    for l in range(config.layer_num):
        x = _block(config, layer_slice(params["layers"], l), x, mask)

    pooled = None
    if "pooler_w" in params:
        pooled = torch.tanh(linear(x[:, 0], params["pooler_w"], params["pooler_b"]))
    return x, pooled


_GEMM_NAMES = ("qkv_w", "proj_w", "up_w", "down_w")


def quantize_bert_params(params):
    """int8 per output channel on the four GEMM weights of every layer (the
    ``ckpt.quantize.quantize_array`` math of the decoder families);
    embeddings, norms and the pooler stay in their float dtype."""
    from ..ckpt.quantize import quantize_array

    out = dict(params)
    out["layers"] = {
        k: (quantize_array(v, k_axis=-2) if k in _GEMM_NAMES else v)
        for k, v in params["layers"].items()
    }
    return out


class BertEngine:
    """Served-encoder seam (the registry's ``make_engine``): holds the
    params, float or int8, and encodes on their device."""

    def __init__(self, config: BertConfig, params, mesh=None):
        if mesh is not None:
            raise NotImplementedError("tensor-parallel BERT is ROADMAP queue 1 item 19")
        self.config = config
        self.params = params

    def encode(self, input_ids, lengths, token_type_ids=None):
        """(hidden [B, S, H], pooled [B, H] or None) on the params' device;
        the inputs may be numpy arrays or tensors."""
        return encode(self.config, self.params, input_ids, lengths, token_type_ids)
