"""DeBERTa-v2/v3 encoder family (port of models/deberta.py): disentangled
attention.

Attention is the sum of three terms, content->content, content->position
(c2p) and position->content (p2c), under one 1/sqrt(n*dh) scale (n the
number of terms), with log-bucketed relative-position embeddings projected
through the (optionally shared) key/query projections and gathered per
(i, j) bucket.

Parity with HF DebertaV2Model (modeling_deberta_v2.py):
  - the embedding LayerNorm output is multiplied by the padding mask;
  - the score mask is two-sided (query AND key must be real tokens);
  - log buckets: |rel| <= mid keeps rel, else sign * (ceil(log(|rel|/mid) /
    log((max-1)/mid) * (mid-1)) + mid), computed on the CPU in float32;
  - c2p gathers at bucket(rel) + span, p2c at bucket(-rel) + span over the
    [key, key] matrix, then transposes; both indices clamped to [0, 2 span);
  - rel_embeddings optionally LayerNorm'd (norm_rel_ebd="layer_norm");
  - share_att_key=True (v3) reuses the content query/key projections for
    the position embeddings; False uses pos_key_proj / pos_query_proj.
The products are plain PyTorch, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.layernorm import layernorm
from ..ops.linear import linear
from .params import layer_slice

MASK_VALUE = float(torch.finfo(torch.float32).min)


@dataclasses.dataclass(frozen=True)
class DebertaConfig:
    head_num: int
    size_per_head: int
    layer_num: int
    vocab_size: int
    max_position_embeddings: int
    inter_size: int
    type_vocab_size: int = 0
    layernorm_eps: float = 1e-7
    activation: str = "gelu"
    relative_attention: bool = True
    position_buckets: int = -1
    max_relative_positions: int = -1
    pos_att_type: Tuple[str, ...] = ("c2p", "p2c")
    norm_rel_ebd: str = "none"
    share_att_key: bool = False
    position_biased_input: bool = True
    model_name: str = "deberta"

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head

    @property
    def att_span(self) -> int:
        if self.position_buckets > 0:
            return self.position_buckets
        if self.max_relative_positions > 0:
            return self.max_relative_positions
        return self.max_position_embeddings


def config_from_hf_deberta(hf_config, model_name="deberta") -> DebertaConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    nH = g("num_attention_heads")
    H = g("hidden_size")
    pat = g("pos_att_type") or []
    return DebertaConfig(
        head_num=nH,
        size_per_head=H // nH,
        layer_num=g("num_hidden_layers"),
        vocab_size=g("vocab_size"),
        max_position_embeddings=g("max_position_embeddings"),
        inter_size=g("intermediate_size"),
        type_vocab_size=g("type_vocab_size", 0),
        layernorm_eps=float(g("layer_norm_eps", 1e-7)),
        activation={"gelu": "gelu", "gelu_new": "gelu-tanh",
                    "relu": "relu"}.get(g("hidden_act", "gelu"), "gelu"),
        relative_attention=bool(g("relative_attention", False)),
        position_buckets=int(g("position_buckets", -1) or -1),
        max_relative_positions=int(g("max_relative_positions", -1) or -1),
        pos_att_type=tuple(pat),
        norm_rel_ebd=str(g("norm_rel_ebd", "none") or "none"),
        share_att_key=bool(g("share_att_key", False)),
        position_biased_input=bool(g("position_biased_input", True)),
        model_name=model_name,
    )


def params_from_hf_deberta_state_dict(
    config: DebertaConfig, state_dict: Mapping[str, Any], dtype=torch.float32, device=None
) -> Dict[str, Any]:
    """HF ``DebertaV2Model`` weights -> the stacked params dict, in ``dtype``
    on ``device`` (the CUDA card when None)."""
    from ..ckpt.convert import _np, stack_layers
    from ..core.dtypes import torch_dtype

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    sd = dict(state_dict)
    pre = "deberta." if "deberta.embeddings.word_embeddings.weight" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    def dense(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def stack(fn):
        return stack_layers(fn, config.layer_num, dtype, device)

    def lw(i, name):
        return get(f"encoder.layer.{i}.{name}")

    def attn(i, which, part):
        return lw(i, f"attention.self.{which}.{part}")

    layers = {
        "q_w": stack(lambda i: attn(i, "query_proj", "weight").T),
        "q_b": stack(lambda i: attn(i, "query_proj", "bias")),
        "k_w": stack(lambda i: attn(i, "key_proj", "weight").T),
        "k_b": stack(lambda i: attn(i, "key_proj", "bias")),
        "v_w": stack(lambda i: attn(i, "value_proj", "weight").T),
        "v_b": stack(lambda i: attn(i, "value_proj", "bias")),
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
    if config.relative_attention and not config.share_att_key:
        if "c2p" in config.pos_att_type:
            layers["pos_k_w"] = stack(lambda i: attn(i, "pos_key_proj", "weight").T)
            layers["pos_k_b"] = stack(lambda i: attn(i, "pos_key_proj", "bias"))
        if "p2c" in config.pos_att_type:
            layers["pos_q_w"] = stack(lambda i: attn(i, "pos_query_proj", "weight").T)
            layers["pos_q_b"] = stack(lambda i: attn(i, "pos_query_proj", "bias"))

    out = {
        "embed": dense(get("embeddings.word_embeddings.weight")),
        "embed_ln_w": dense(get("embeddings.LayerNorm.weight")),
        "embed_ln_b": dense(get("embeddings.LayerNorm.bias")),
        "layers": layers,
    }
    if config.position_biased_input:
        out["pos_embed"] = dense(get("embeddings.position_embeddings.weight"))
    if config.type_vocab_size > 0:
        out["type_embed"] = dense(get("embeddings.token_type_embeddings.weight"))
    if config.relative_attention:
        out["rel_embed"] = dense(get("encoder.rel_embeddings.weight"))
        if "layer_norm" in config.norm_rel_ebd:
            out["rel_ln_w"] = dense(get("encoder.LayerNorm.weight"))
            out["rel_ln_b"] = dense(get("encoder.LayerNorm.bias"))
    return out


def _log_bucket(rel, bucket_size: int, max_position: int) -> torch.Tensor:
    """HF make_log_bucket_position on the CPU (int64 result). The float32 log
    is rounded up to an integer, so it is computed where the divisions are
    exact (the CPU) and moved to the device by the caller."""
    rel = torch.as_tensor(rel, device="cpu").long()
    sign = torch.sign(rel)
    mid = bucket_size // 2
    abs_pos = torch.where((rel < mid) & (rel > -mid), mid - 1, rel.abs()).float()
    log_pos = torch.ceil(
        torch.log(abs_pos / mid) / math.log((max_position - 1) / mid) * (mid - 1)
    ) + mid
    return torch.where(rel.abs() <= mid, rel.float(), log_pos * sign).long()


def relative_positions(config: DebertaConfig, S: int) -> torch.Tensor:
    """[S, S] bucketed relative positions rel[i, j] = bucket(i - j), on the
    CPU."""
    ids = torch.arange(S)
    rel = ids[:, None] - ids[None, :]
    if config.position_buckets > 0:
        max_pos = (config.max_relative_positions if config.max_relative_positions > 0
                   else config.max_position_embeddings)
        rel = _log_bucket(rel, config.position_buckets, max_pos)
    return rel


def _heads(x, nH, dh):
    return x.reshape(x.shape[0], x.shape[1], nH, dh)


def _gather_rel(att: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """att [B, nH, S, R] gathered along R at idx [S, S]: out[b, h, i, j] =
    att[b, h, i, idx[i, j]]."""
    B, nH, S, _ = att.shape
    return torch.gather(att, -1, idx[None, None].expand(B, nH, S, idx.shape[1]))


def _attention(config: DebertaConfig, params, lp, x, rel, allow):
    """Disentangled attention: c2c + c2p + p2c under one sqrt(n*dh) scale
    (DisentangledSelfAttention.forward + disentangled_attention_bias). rel
    [S, S] bucketed positions on x's device; allow [B, S, S] the mask."""
    B, S, H = x.shape
    nH, dh = config.head_num, config.size_per_head
    n_terms = 1 + sum(t in config.pos_att_type for t in ("c2p", "p2c")) * config.relative_attention
    scale = 1.0 / float(np.sqrt(dh * n_terms))

    q = _heads(linear(x, lp["q_w"], lp["q_b"]), nH, dh)
    k = _heads(linear(x, lp["k_w"], lp["k_b"]), nH, dh)
    v = _heads(linear(x, lp["v_w"], lp["v_b"]), nH, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale

    if config.relative_attention:
        span = config.att_span
        re = params["rel_embed"][: 2 * span]
        if "rel_ln_w" in params:
            re = layernorm(re, params["rel_ln_w"], params["rel_ln_b"], config.layernorm_eps)
        re = re[None]  # [1, 2*span, H]
        if "c2p" in config.pos_att_type:
            kw, kb = (("k_w", "k_b") if config.share_att_key else ("pos_k_w", "pos_k_b"))
            pk = _heads(linear(re, lp[kw], lp[kb]), nH, dh)[0]
            # c2p[b, h, i, r] = q_i . pk[r], gathered at bucket(i - j) + span
            c2p = torch.einsum("bqhd,rhd->bhqr", q.float(), pk.float())
            scores = scores + _gather_rel(c2p, torch.clamp(rel + span, 0, 2 * span - 1)) * scale
        if "p2c" in config.pos_att_type:
            qw, qb = (("q_w", "q_b") if config.share_att_key else ("pos_q_w", "pos_q_b"))
            pq = _heads(linear(re, lp[qw], lp[qb]), nH, dh)[0]
            # p2c[b, h, j, r] = k_j . pq[r], gathered at bucket(j - i) + span
            # over the [key, key] matrix, then transposed (HF's order)
            p2c = torch.einsum("bkhd,rhd->bhkr", k.float(), pq.float())
            p2c = _gather_rel(p2c, torch.clamp(-rel + span, 0, 2 * span - 1))
            scores = scores + p2c.transpose(-1, -2) * scale

    scores = torch.where(allow[:, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
    return ctx.reshape(B, S, H)


def encode(config: DebertaConfig, params: Dict[str, Any], input_ids, lengths,
           token_type_ids: Optional[Any] = None):
    """Full encoder pass -> (last_hidden [B, S, H], None), on the params'
    device; the inputs may be numpy arrays or tensors."""
    dev = params["embed"].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev)
    B, S = input_ids.shape
    real = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    x = params["embed"][input_ids]
    if config.position_biased_input:
        x = x + params["pos_embed"][None, :S]
    if config.type_vocab_size > 0:
        tt = (torch.zeros((B, S), dtype=torch.long, device=dev) if token_type_ids is None
              else torch.as_tensor(token_type_ids, device=dev).long())
        x = x + params["type_embed"][tt]
    x = layernorm(x, params["embed_ln_w"], params["embed_ln_b"], config.layernorm_eps)
    x = x * real[:, :, None].to(x.dtype)  # HF zeroes the padded rows

    allow = real[:, :, None] & real[:, None, :]  # [B, S, S]: query AND key real
    rel = relative_positions(config, S).to(dev) if config.relative_attention else None
    for l in range(config.layer_num):
        lp = layer_slice(params["layers"], l)
        a = linear(_attention(config, params, lp, x, rel, allow), lp["proj_w"], lp["proj_b"])
        h = layernorm(x + a, lp["attn_ln_w"], lp["attn_ln_b"], config.layernorm_eps)
        f = linear(h, lp["up_w"], lp["up_b"], act=config.activation)
        f = linear(f, lp["down_w"], lp["down_b"])
        x = layernorm(h + f, lp["out_ln_w"], lp["out_ln_b"], config.layernorm_eps)
    return x, None
