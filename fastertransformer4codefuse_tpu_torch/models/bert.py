"""BERT encoder (port of models/bert.py).

  - post-LayerNorm residuals: h = LN(x + attn), out = LN(h + ffn);
  - bidirectional attention, masked on padded keys, no KV cache;
  - learned absolute positions, token-type (segment) embeddings and an
    embedding LayerNorm;
  - tanh pooler over [CLS] (HF BertPooler).

The four GEMMs of a layer go through ``ops.linear``: with
``quantize_bert_params`` (int8 per output channel) they run K1 on the card.
The attention stays plain PyTorch, as the JAX package leaves it to XLA.

Tensor parallelism (``mesh``; ``shard_bert_params``, the JAX
``bert_param_shardings``): QKV and FFN-up split by columns, proj and
FFN-down by rows; a rank attends over its heads and its two partial sums a
layer are all-reduced (counted), the biases added after the reduce.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.layernorm import layernorm
from ..ops.linear import linear
from ..parallel.distributed import all_reduce
from ..parallel.sharding import shard_tensor
from .params import QuantizedTensor, layer_slice

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


def _row_split(x, w, b, mesh):
    """``x @ w + b`` for a row-split ``w``: the tp group's partials reduced,
    then the bias."""
    if mesh is None or mesh.tp == 1:
        return linear(x, w, b)
    return all_reduce(linear(x, w), mesh) + b.to(x.dtype)


def _block(config: BertConfig, lp, x, mask, mesh=None):
    """One post-LN encoder block. x [B, S, H]; mask [B, 1, 1, S] additive."""
    B, S, H = x.shape
    dh = config.size_per_head
    qkv = linear(x, lp["qkv_w"], lp["qkv_b"])  # [B, S, 3 * the rank's heads * dh]
    Hl = qkv.shape[-1] // 3
    q = qkv[..., :Hl].reshape(B, S, -1, dh)
    k = qkv[..., Hl: 2 * Hl].reshape(B, S, -1, dh)
    v = qkv[..., 2 * Hl:].reshape(B, S, -1, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (dh ** 0.5)
    probs = torch.softmax(scores + mask, dim=-1).to(x.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
    attn = _row_split(attn.reshape(B, S, Hl), lp["proj_w"], lp["proj_b"], mesh)
    h = layernorm(x + attn, lp["attn_ln_w"], lp["attn_ln_b"], config.layernorm_eps)
    ffn = linear(h, lp["up_w"], lp["up_b"], act=config.activation)
    ffn = _row_split(ffn, lp["down_w"], lp["down_b"], mesh)
    return layernorm(h + ffn, lp["out_ln_w"], lp["out_ln_b"], config.layernorm_eps)


def encode(
    config: BertConfig,
    params: Dict[str, Any],
    input_ids: torch.Tensor,  # [B, S] integer
    lengths: torch.Tensor,  # [B]: the padding mask
    token_type_ids: Optional[torch.Tensor] = None,  # [B, S]
    mesh=None,
):
    """Full encoder pass -> (last_hidden [B, S, H], pooled [B, H] or None).
    Bidirectional: every real token attends every real token. Runs on the
    device of ``params``; ``mesh``: this rank's place under tp, ``params``
    its slice."""
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
        x = _block(config, layer_slice(params["layers"], l), x, mask, mesh)

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


def _qkv_heads(value, mesh):
    """This rank's heads of each segment of the [.., K, q | k | v] fused QKV
    (or its bias [.., q | k | v]): [q_r | k_r | v_r]. The JAX package splits
    the flat columns and lets GSPMD move the heads; explicit ranks need their
    own heads of all three."""
    def take(t):
        parts = torch.chunk(t, 3, dim=-1)
        return torch.cat([shard_tensor(p, p.ndim - 1, mesh) for p in parts], dim=-1)

    if isinstance(value, QuantizedTensor):
        return dataclasses.replace(value, q=take(value.q), scale=take(value.scale))
    return take(value)


# Split axes of the stacked [L, K, N] layer weights (the JAX
# bert_param_shardings' specs); the fused QKV is split a segment at a time
_BERT_SPLITS = {"up_w": 2, "up_b": 1, "proj_w": 1, "down_w": 1}


def shard_bert_params(config: BertConfig, params, mesh):
    """This rank's slice of the params (the JAX ``shard_bert_params``);
    embeddings, norms, the pooler and the row-split layers' biases are
    replicated."""
    if mesh.tp == 1:
        return params
    if config.head_num % mesh.tp:
        raise ValueError(f"{config.head_num} heads do not split over tp {mesh.tp}")
    layers = {}
    for n, v in params["layers"].items():
        if n in ("qkv_w", "qkv_b"):
            layers[n] = _qkv_heads(v, mesh)
        else:
            layers[n] = shard_tensor(v, _BERT_SPLITS.get(n), mesh, n)
    return {**params, "layers": layers}


class BertEngine:
    """Served-encoder seam (the registry's ``make_engine``): holds the
    params, float or int8 (this rank's slice under ``mesh``), and encodes on
    their device."""

    def __init__(self, config: BertConfig, params, mesh=None):
        self.config = config
        self.mesh = mesh
        self.params = params if mesh is None else shard_bert_params(config, params, mesh)

    def encode(self, input_ids, lengths, token_type_ids=None):
        """(hidden [B, S, H], pooled [B, H] or None) on the params' device;
        the inputs may be numpy arrays or tensors."""
        return encode(self.config, self.params, input_ids, lengths, token_type_ids, self.mesh)
