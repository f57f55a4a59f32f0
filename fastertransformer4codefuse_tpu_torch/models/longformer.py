"""Longformer encoder: sliding-window and global attention (port of
models/longformer.py).

Semantics of HF ``LongformerModel``, as in the JAX package:
  - every token attends ``attention_window[l] // 2`` positions on each side
    (per-layer windows), global positions excepted;
  - every token attends the global tokens (standard k/v projections), and the
    global tokens' own rows are recomputed over the whole sequence with the
    ``query_global``/``key_global``/``value_global`` projections;
  - RoBERTa-style position ids (pad-offset cumsum), post-LN blocks, pooler.

``encode(use_kernel=True)`` with no ``global_mask`` runs the local attention
through K12 (``ops/sliding_window.py``, CUDA on the card), whose work grows
as S * w; with global tokens the route is the dense-masked form, chosen by
the presence of the argument as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..core.device import resolve_device
from ..ops.layernorm import layernorm
from ..ops.linear import linear
from ..ops.sliding_window import sliding_window_attention
from .params import layer_slice

MASK_VALUE = float(torch.finfo(torch.float32).min)  # HF uses dtype-min, not -inf


@dataclasses.dataclass(frozen=True)
class LongformerConfig:
    head_num: int
    size_per_head: int
    layer_num: int
    vocab_size: int
    max_position_embeddings: int
    attention_window: Tuple[int, ...]  # per layer, even
    pad_token_id: int = 1
    type_vocab_size: int = 1
    inter_size: Optional[int] = None
    layernorm_eps: float = 1e-12
    activation: str = "gelu"
    model_name: str = "longformer"

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head


def config_from_hf_longformer(hf_config, model_name="longformer") -> LongformerConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    nH = g("num_attention_heads")
    H = g("hidden_size")
    win = g("attention_window")
    if isinstance(win, int):
        win = [win] * g("num_hidden_layers")
    return LongformerConfig(
        head_num=nH,
        size_per_head=H // nH,
        layer_num=g("num_hidden_layers"),
        vocab_size=g("vocab_size"),
        max_position_embeddings=g("max_position_embeddings"),
        attention_window=tuple(int(w) for w in win),
        pad_token_id=g("pad_token_id", 1),
        type_vocab_size=g("type_vocab_size", 1),
        inter_size=g("intermediate_size"),
        layernorm_eps=float(g("layer_norm_eps", 1e-12)),
        activation={"gelu": "gelu", "gelu_new": "gelu-tanh",
                    "relu": "relu"}.get(g("hidden_act", "gelu"), "gelu"),
        model_name=model_name,
    )


def params_from_hf_longformer_state_dict(
    config: LongformerConfig, state_dict: Mapping[str, Any], dtype=torch.float32, device=None
) -> Dict[str, Any]:
    """HF ``LongformerModel`` weights (torch or numpy) -> the stacked params
    dict, in ``dtype`` on ``device`` (the CUDA card when None)."""
    from ..ckpt.convert import _np, stack_layers
    from ..core.dtypes import torch_dtype

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    sd = dict(state_dict)
    pre = "longformer." if "longformer.embeddings.word_embeddings.weight" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    def stack(fn):
        return stack_layers(fn, config.layer_num, dtype, device)

    def dense(a):
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def lw(i, name):
        return get(f"encoder.layer.{i}.{name}")

    layers = {}
    for which, short in (("query", "q"), ("key", "k"), ("value", "v"), ("query_global", "qg"),
                         ("key_global", "kg"), ("value_global", "vg")):
        layers[f"{short}_w"] = stack(lambda i, w=which: lw(i, f"attention.self.{w}.weight").T)
        layers[f"{short}_b"] = stack(lambda i, w=which: lw(i, f"attention.self.{w}.bias"))
    layers.update({
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
    })
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


def _heads(x, nH, dh):
    B, S, _ = x.shape
    return x.reshape(B, S, nH, dh)


def _attention(config, lp, x, w_half, is_masked, is_global, use_kernel=False):
    """One Longformer attention: banded local attention plus global columns,
    then global rows recomputed with the *_global projections
    (LongformerSelfAttention semantics). ``is_global`` None means no global
    tokens."""
    B, S, H = x.shape
    nH, dh = config.head_num, config.size_per_head
    scale = 1.0 / (dh ** 0.5)
    q = _heads(linear(x, lp["q_w"], lp["q_b"]), nH, dh) * scale
    k = _heads(linear(x, lp["k_w"], lp["k_b"]), nH, dh)
    v = _heads(linear(x, lp["v_w"], lp["v_b"]), nH, dh)

    if use_kernel:
        ctx = sliding_window_attention(q, k, v, w_half, is_masked)
    else:
        # allowed = global keys (everyone attends them, standard k/v) or
        # in-band local keys that are neither global nor padding: the
        # dense-mask form of HF's [global columns | band] concat
        i = torch.arange(S, device=x.device)
        in_band = (i[:, None] - i[None, :]).abs() <= w_half  # [S, S]
        allowed = in_band[None] & ~is_masked[:, None, :]
        if is_global is not None:
            allowed = is_global[:, None, :] | (allowed & ~is_global[:, None, :])
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores.masked_fill(~allowed[:, None], MASK_VALUE)
        probs = torch.softmax(scores, dim=-1)
        # padded query rows: every prob zeroed (HF masked_fill on is_index_masked)
        probs = probs.masked_fill(is_masked[:, None, :, None], 0.0)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(x.dtype).float(), v.float()).to(x.dtype)

    if is_global is None:
        # No global tokens. The JAX function computes the global rows here
        # anyway (a dense S x S softmax per layer) and then keeps none of
        # them (jnp.where on an all-False is_global), so skipping them gives
        # the same output without the S^2 work.
        return ctx.reshape(B, S, H)
    qg = _heads(linear(x, lp["qg_w"], lp["qg_b"]), nH, dh) * scale
    kg = _heads(linear(x, lp["kg_w"], lp["kg_b"]), nH, dh)
    vg = _heads(linear(x, lp["vg_w"], lp["vg_b"]), nH, dh)
    g_scores = torch.einsum("bqhd,bkhd->bhqk", qg.float(), kg.float())
    g_scores = g_scores.masked_fill(is_masked[:, None, None, :], MASK_VALUE)
    g_probs = torch.softmax(g_scores, dim=-1).to(x.dtype)
    g_ctx = torch.einsum("bhqk,bkhd->bqhd", g_probs.float(), vg.float()).to(x.dtype)
    ctx = torch.where(is_global[:, :, None, None], g_ctx, ctx)
    return ctx.reshape(B, S, H)


def encode(
    config: LongformerConfig,
    params: Dict[str, Any],
    input_ids: torch.Tensor,  # [B, S] integer
    lengths: torch.Tensor,  # [B]
    global_mask: Optional[torch.Tensor] = None,  # [B, S] bool: global tokens
    use_kernel: bool = False,
):
    """Full encoder pass -> (last_hidden [B, S, H], pooled [B, H] or None).
    Runs on the device of ``params``."""
    dev = params["embed"].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev)
    B, S = input_ids.shape
    real = torch.arange(S, device=dev)[None, :] < lengths[:, None]  # [B, S]
    is_masked = ~real
    is_global = None
    if global_mask is not None:
        is_global = torch.as_tensor(global_mask, device=dev).bool() & real
        # the banded kernel cannot serve global columns: the route follows
        # the argument's presence, as in JAX
        use_kernel = False

    # RoBERTa-style positions: pad-offset cumsum over real tokens
    pos = torch.cumsum(real.long(), dim=1) * real + config.pad_token_id
    x = params["embed"][input_ids] + params["pos_embed"][pos] + params["type_embed"][0]
    x = layernorm(x, params["embed_ln_w"], params["embed_ln_b"], config.layernorm_eps)

    for l in range(config.layer_num):
        lp = layer_slice(params["layers"], l)
        a = _attention(config, lp, x, config.attention_window[l] // 2, is_masked, is_global,
                       use_kernel=use_kernel)
        a = linear(a, lp["proj_w"], lp["proj_b"])
        h = layernorm(x + a, lp["attn_ln_w"], lp["attn_ln_b"], config.layernorm_eps)
        f = linear(h, lp["up_w"], lp["up_b"], act=config.activation)
        f = linear(f, lp["down_w"], lp["down_b"])
        x = layernorm(h + f, lp["out_ln_w"], lp["out_ln_b"], config.layernorm_eps)

    pooled = None
    if "pooler_w" in params:
        pooled = torch.tanh(linear(x[:, 0], params["pooler_w"], params["pooler_b"]))
    return x, pooled


class LongformerEngine:
    """Served-encoder seam for Longformer, beside ``models.bert.BertEngine``:
    holds the params and encodes with ``use_kernel=True``, so a batch without
    global tokens runs K12. The JAX package has no such class; it makes
    Longformer servable behind ``engine.encoder_server.EncoderBatchingServer``."""

    def __init__(self, config: LongformerConfig, params):
        self.config = config
        self.params = params

    def encode(self, input_ids, lengths, global_mask=None):
        """(hidden [B, S, H], pooled [B, H] or None) on the params' device;
        ids, lengths and the mask may be numpy arrays or tensors."""
        return encode(self.config, self.params, input_ids, lengths, global_mask=global_mask,
                      use_kernel=True)
