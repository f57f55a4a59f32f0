"""BART and Marian encoder-decoder families (port of models/bart.py).

Deltas from the T5 family (``models/t5.py``):

  - learned absolute positions with BART's +2 offset (the fairseq legacy),
    applied from position 0 whatever the padding; Marian's sinusoidal table
    is loaded verbatim from the checkpoint with offset 0;
  - post-LayerNorm blocks (residual -> LN), plus an embedding LayerNorm
    (BART; Marian has none); ``scale_embedding`` multiplies the token
    embeddings by sqrt(d_model);
  - scaled dot-product attention (q * dh**-0.5), with biases;
  - generation starts at ``decoder_start_token_id`` and, when
    ``forced_eos_token_id`` is set, the final position is forced to it (HF's
    ForcedEosTokenLogitsProcessor); ``final_logits_bias`` is added to the
    logits.

Cross-attention K/V are projected once from the encoder output for all
decoder layers; the decoder self-attention runs an incremental cache. Every
product is plain PyTorch, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.layernorm import layernorm
from ..ops.linear import apply_act
from .params import layer_slice

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class BartConfig:
    head_num: int
    size_per_head: int
    d_model: int
    layer_num: int  # encoder layers
    dec_layer_num: int
    vocab_size: int
    inter_size: int
    max_position_embeddings: int
    activation: str = "gelu"
    start_id: int = 2  # decoder_start_token_id (== eos for BART)
    end_id: int = 2
    forced_eos_id: int = 2  # -1 = disabled
    pos_offset: int = 2
    embed_scale: float = 1.0
    layernorm_eps: float = 1e-5
    model_name: str = "bart"


def config_from_hf_bart(hf_config, model_name="bart") -> BartConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    nH = g("encoder_attention_heads")
    D = g("d_model")
    feos = g("forced_eos_token_id")
    return BartConfig(
        head_num=nH,
        size_per_head=D // nH,
        d_model=D,
        layer_num=g("encoder_layers"),
        dec_layer_num=g("decoder_layers"),
        vocab_size=g("vocab_size"),
        inter_size=g("encoder_ffn_dim"),
        max_position_embeddings=g("max_position_embeddings"),
        activation={"gelu": "gelu", "gelu_new": "gelu-tanh", "relu": "relu",
                    "swish": "silu", "silu": "silu"}.get(g("activation_function", "gelu"), "gelu"),
        start_id=g("decoder_start_token_id", 2),
        end_id=g("eos_token_id", 2),
        forced_eos_id=-1 if feos is None else int(feos),
        embed_scale=(D ** 0.5) if g("scale_embedding", False) else 1.0,
        model_name=model_name,
    )


def params_from_hf_bart_state_dict(
    config: BartConfig, state_dict: Mapping[str, Any], dtype=torch.float32, device=None
) -> Dict[str, Any]:
    """HF ``BartForConditionalGeneration`` / ``MarianMTModel`` weights (torch
    or numpy) -> the stacked params dict, in ``dtype`` on ``device`` (the CUDA
    card when None)."""
    from ..ckpt.convert import _np, stack_layers
    from ..core.dtypes import torch_dtype

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    sd = dict(state_dict)
    pre = "model." if "model.shared.weight" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    def dense(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def side_layers(side, L, cross):
        def st(fn):
            return stack_layers(fn, L, dtype, device)

        def lw(i, name):
            return get(f"{side}.layers.{i}.{name}")

        out = {}
        projs = [("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                 ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj")]
        norms = [("ln1", "self_attn_layer_norm"), ("ln2", "final_layer_norm")]
        if cross:
            projs += [("xq", "encoder_attn.q_proj"), ("xk", "encoder_attn.k_proj"),
                      ("xv", "encoder_attn.v_proj"), ("xo", "encoder_attn.out_proj")]
            norms += [("ln_x", "encoder_attn_layer_norm")]
        for short, name in projs:
            out[f"{short}_w"] = st(lambda i, n=name: lw(i, f"{n}.weight").T)
            out[f"{short}_b"] = st(lambda i, n=name: lw(i, f"{n}.bias"))
        for short, name in norms:
            out[f"{short}_w"] = st(lambda i, n=name: lw(i, f"{n}.weight"))
            out[f"{short}_b"] = st(lambda i, n=name: lw(i, f"{n}.bias"))
        out["wi"] = st(lambda i: lw(i, "fc1.weight").T)
        out["wi_b"] = st(lambda i: lw(i, "fc1.bias"))
        out["wo"] = st(lambda i: lw(i, "fc2.weight").T)
        out["wo_b"] = st(lambda i: lw(i, "fc2.bias"))
        return out

    out = {
        "embed": dense(get("shared.weight")),
        "enc_pos": dense(get("encoder.embed_positions.weight")),
        "dec_pos": dense(get("decoder.embed_positions.weight")),
        "enc": side_layers("encoder", config.layer_num, cross=False),
        "dec": side_layers("decoder", config.dec_layer_num, cross=True),
    }
    if pre + "encoder.layernorm_embedding.weight" in sd:  # Marian has none
        for side in ("enc", "dec"):
            name = "encoder" if side == "enc" else "decoder"
            out[f"{side}_eln_w"] = dense(get(f"{name}.layernorm_embedding.weight"))
            out[f"{side}_eln_b"] = dense(get(f"{name}.layernorm_embedding.bias"))
    if "final_logits_bias" in sd:
        out["logits_bias"] = dense(_np(sd["final_logits_bias"])[0])
    return out


def _mh(x, w, b, nH, dh):
    y = torch.matmul(x, w.to(x.dtype)) + b.to(x.dtype)
    return y.reshape(x.shape[0], x.shape[1], nH, dh)


def _attn(q, k, v, bias, o_w, o_b):
    """Attention of q (pre-scaled by the caller) with an additive fp32 bias."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)
    B, Q = ctx.shape[0], ctx.shape[1]
    return torch.matmul(ctx.reshape(B, Q, -1), o_w.to(q.dtype)) + o_b.to(q.dtype)


def _ffn(config: BartConfig, lp, h):
    f = apply_act(torch.matmul(h, lp["wi"].to(h.dtype)) + lp["wi_b"].to(h.dtype),
                  config.activation)
    return torch.matmul(f, lp["wo"].to(f.dtype)) + lp["wo_b"].to(f.dtype)


def encode(config: BartConfig, params, input_ids, lengths) -> torch.Tensor:
    """Encoder pass -> [B, S, D] (post-LN stack), on the params' device; the
    inputs may be numpy arrays or tensors."""
    dev = params["embed"].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev)
    B, S = input_ids.shape
    nH, dh = config.head_num, config.size_per_head
    scale = dh ** -0.5
    x = params["embed"][input_ids] * config.embed_scale
    x = x + params["enc_pos"][config.pos_offset: config.pos_offset + S][None]
    if "enc_eln_w" in params:
        x = layernorm(x, params["enc_eln_w"], params["enc_eln_b"], config.layernorm_eps)
    pad = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    bias = torch.where(pad, 0.0, MASK_VALUE)[:, None, None, :]
    for l in range(config.layer_num):
        lp = layer_slice(params["enc"], l)
        q = _mh(x, lp["q_w"], lp["q_b"], nH, dh) * scale
        a = _attn(q, _mh(x, lp["k_w"], lp["k_b"], nH, dh), _mh(x, lp["v_w"], lp["v_b"], nH, dh),
                  bias, lp["o_w"], lp["o_b"])
        h = layernorm(x + a, lp["ln1_w"], lp["ln1_b"], config.layernorm_eps)
        x = layernorm(h + _ffn(config, lp, h), lp["ln2_w"], lp["ln2_b"], config.layernorm_eps)
    return x


def init_decoder_state(config: BartConfig, params, enc_hidden, enc_lengths, S_out: int):
    """Self-attention cache slabs [Ld, B, S_out, nH, dh], the cross K/V of
    every decoder layer (one batched product over the layers each) and the
    additive encoder key mask [B, S_enc]."""
    B, S_enc, D = enc_hidden.shape
    nH, dh = config.head_num, config.size_per_head
    Ld = config.dec_layer_num
    dev, dt = enc_hidden.device, enc_hidden.dtype
    dec = params["dec"]

    def proj_all(w, b):  # [1, B*S, D] @ [Ld, D, n] -> [Ld, B*S, n]
        y = torch.matmul(enc_hidden.reshape(1, B * S_enc, D), w.to(dt)) + b.to(dt)[:, None, :]
        return y.reshape(Ld, B, S_enc, nH, dh)

    lengths = torch.as_tensor(enc_lengths, device=dev)
    return {
        "self_k": torch.zeros((Ld, B, S_out, nH, dh), dtype=dt, device=dev),
        "self_v": torch.zeros((Ld, B, S_out, nH, dh), dtype=dt, device=dev),
        "cross_k": proj_all(dec["xk_w"], dec["xk_b"]),
        "cross_v": proj_all(dec["xv_w"], dec["xv_b"]),
        "enc_mask": torch.where(torch.arange(S_enc, device=dev)[None, :] < lengths[:, None],
                                0.0, MASK_VALUE),
    }


def decode_step(config: BartConfig, params, state, tokens, pos: int):
    """One incremental decoder step at position ``pos`` (a host int), attending
    positions 0..pos. tokens [B]. Returns (logits [B, V] fp32, state), the
    state updated in place."""
    pos = int(pos)
    nH, dh = config.head_num, config.size_per_head
    scale = dh ** -0.5
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    x = params["embed"][tokens][:, None] * config.embed_scale
    x = x + params["dec_pos"][config.pos_offset + pos][None, None]
    if "dec_eln_w" in params:
        x = layernorm(x, params["dec_eln_w"], params["dec_eln_b"], config.layernorm_eps)
    no_bias = torch.zeros((), dtype=torch.float32, device=dev)
    cross_bias = state["enc_mask"][:, None, None, :]
    for l in range(config.dec_layer_num):
        lp = layer_slice(params["dec"], l)
        q = _mh(x, lp["q_w"], lp["q_b"], nH, dh) * scale
        state["self_k"][l, :, pos] = _mh(x, lp["k_w"], lp["k_b"], nH, dh)[:, 0]
        state["self_v"][l, :, pos] = _mh(x, lp["v_w"], lp["v_b"], nH, dh)[:, 0]
        a = _attn(q, state["self_k"][l, :, : pos + 1], state["self_v"][l, :, : pos + 1],
                  no_bias, lp["o_w"], lp["o_b"])
        x1 = layernorm(x + a, lp["ln1_w"], lp["ln1_b"], config.layernorm_eps)
        xq = _mh(x1, lp["xq_w"], lp["xq_b"], nH, dh) * scale
        ca = _attn(xq, state["cross_k"][l], state["cross_v"][l], cross_bias,
                   lp["xo_w"], lp["xo_b"])
        x2 = layernorm(x1 + ca, lp["ln_x_w"], lp["ln_x_b"], config.layernorm_eps)
        x = layernorm(x2 + _ffn(config, lp, x2), lp["ln2_w"], lp["ln2_b"], config.layernorm_eps)
    logits = x[:, 0].float() @ params["embed"].float().t()
    if "logits_bias" in params:
        logits = logits + params["logits_bias"].float()[None]
    return logits, state


@torch.no_grad()
def greedy_generate(config: BartConfig, params, input_ids, lengths, max_out: int) -> np.ndarray:
    """Encoder + incremental greedy decode, HF's semantics: it starts at
    decoder_start_token_id and forces eos at the final position when
    forced_eos_token_id is set. Returns [B, n <= max_out] int32, end_id-padded
    after EOS."""
    enc = encode(config, params, input_ids, lengths)
    state = init_decoder_state(config, params, enc, lengths, max_out + 1)
    B = enc.shape[0]
    tok = np.full((B,), config.start_id, np.int64)
    outs = []
    finished = np.zeros((B,), bool)
    for t in range(max_out):
        logits, state = decode_step(config, params, state, tok, t)
        if t == max_out - 1 and config.forced_eos_id >= 0:
            step = np.full((B,), config.forced_eos_id, np.int64)
        else:
            step = torch.argmax(logits, dim=-1).cpu().numpy()
        step = np.where(finished, config.end_id, step)
        outs.append(step.astype(np.int32))
        finished |= step == config.end_id
        if finished.all():
            break
        tok = step
    return np.stack(outs, axis=1)


def config_from_hf_marian(hf_config, model_name="marian") -> BartConfig:
    """Marian: sinusoidal positions (the checkpoint's buffer, offset 0), no
    embedding LayerNorm, otherwise the BART block structure."""
    cfg = config_from_hf_bart(hf_config, model_name=model_name)
    return dataclasses.replace(cfg, pos_offset=0)


def params_from_hf_marian_state_dict(config, state_dict, dtype=torch.float32, device=None):
    return params_from_hf_bart_state_dict(config, state_dict, dtype, device)
