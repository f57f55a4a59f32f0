"""T5 encoder-decoder family (port of models/t5.py).

  - T5 "LayerNorm" is RMSNorm (no mean subtraction, no bias), pre-LN;
  - attention scores are UNSCALED (no 1/sqrt(dh): folded into T5's init);
  - relative position biases: log-bucketed distance embeddings held by the
    first block of each stack and shared by all its layers (bidirectional
    buckets in the encoder, causal in the decoder);
  - cross-attention reads K/V projected once from the encoder output, for
    all decoder layers in one product;
  - the tied LM head rescales the decoder output by d_model**-0.5.

Every product is plain PyTorch, as the JAX package leaves them to XLA: a
float weight is a ``torch.matmul`` in the activations' dtype, an int8
per-output-channel weight (``quantize_t5_params``) is converted to that
dtype inside the call and its scale applied after the product (``_dot2``).
Scores, biases and softmax are fp32. ``decode_step`` runs one incremental
step on self-attention cache slabs; the engines drive it from a host loop.

Tensor parallelism (``mesh``; ``shard_t5_params``, the JAX
``t5_param_shardings``): q/k/v, the cross q/k/v and the FFN's wi are split
by columns (heads), o, the cross o and wo by rows, and the relative-bias
tables by heads; a rank attends over its heads and its partial sums are
all-reduced after each attention and after the FFN (two counted all-reduces
an encoder layer, three a decoder layer). The head is replicated, so every
rank computes the whole logits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.layernorm import rmsnorm
from ..ops.linear import apply_act
from ..parallel.distributed import all_reduce
from ..parallel.sharding import shard_tensor
from .params import QuantizedTensor, layer_slice

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class T5Config:
    head_num: int
    size_per_head: int  # d_kv (NOT d_model / heads in general)
    d_model: int
    layer_num: int  # encoder layers
    dec_layer_num: int
    vocab_size: int
    inter_size: int
    num_buckets: int = 32
    max_distance: int = 128
    layernorm_eps: float = 1e-6
    activation: str = "relu"
    start_id: int = 0  # decoder_start_token_id
    end_id: int = 1
    tie_head: bool = True
    model_name: str = "t5"


def config_from_hf_t5(hf_config, model_name: str = "t5") -> T5Config:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    act = g("dense_act_fn", None) or (
        "gelu-tanh" if "gelu" in g("feed_forward_proj", "relu") else "relu"
    )
    return T5Config(
        head_num=g("num_heads"),
        size_per_head=g("d_kv"),
        d_model=g("d_model"),
        layer_num=g("num_layers"),
        dec_layer_num=g("num_decoder_layers") or g("num_layers"),
        vocab_size=g("vocab_size"),
        inter_size=g("d_ff"),
        num_buckets=g("relative_attention_num_buckets", 32),
        max_distance=g("relative_attention_max_distance", 128),
        layernorm_eps=float(g("layer_norm_epsilon", 1e-6)),
        activation={"relu": "relu", "gelu_new": "gelu-tanh",
                    "gelu": "gelu"}.get(act, "relu"),
        start_id=g("decoder_start_token_id") or 0,
        end_id=g("eos_token_id") or 1,
        tie_head=bool(g("tie_word_embeddings", True)),
        model_name=model_name,
    )


def params_from_hf_t5_state_dict(
    config: T5Config, state_dict: Mapping[str, Any], dtype=torch.float32, device=None
) -> Dict[str, Any]:
    """HF ``T5ForConditionalGeneration`` weights (torch or numpy) -> the
    stacked params dict (x @ W kernels), in ``dtype`` on ``device`` (the CUDA
    card when None)."""
    from ..ckpt.convert import _np, stack_layers
    from ..core.dtypes import torch_dtype

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    sd = dict(state_dict)

    def get(name):
        return _np(sd[name])

    def stack(L, fn):
        return stack_layers(fn, L, dtype, device)

    def dense(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    L, Ld = config.layer_num, config.dec_layer_num

    def eattn(i, which):
        return get(f"encoder.block.{i}.layer.0.SelfAttention.{which}.weight").T

    def dattn(i, lyr, which):
        name = "SelfAttention" if lyr == 0 else "EncDecAttention"
        return get(f"decoder.block.{i}.layer.{lyr}.{name}.{which}.weight").T

    def ffn(side, i, lyr, which):
        return get(f"{side}.block.{i}.layer.{lyr}.DenseReluDense.{which}.weight").T

    def norm(side, i, lyr):
        return get(f"{side}.block.{i}.layer.{lyr}.layer_norm.weight")

    enc = {
        "ln1_w": stack(L, lambda i: norm("encoder", i, 0)),
        "q_w": stack(L, lambda i: eattn(i, "q")),
        "k_w": stack(L, lambda i: eattn(i, "k")),
        "v_w": stack(L, lambda i: eattn(i, "v")),
        "o_w": stack(L, lambda i: eattn(i, "o")),
        "ln2_w": stack(L, lambda i: norm("encoder", i, 1)),
        "wi": stack(L, lambda i: ffn("encoder", i, 1, "wi")),
        "wo": stack(L, lambda i: ffn("encoder", i, 1, "wo")),
    }
    dec = {
        "ln1_w": stack(Ld, lambda i: norm("decoder", i, 0)),
        "q_w": stack(Ld, lambda i: dattn(i, 0, "q")),
        "k_w": stack(Ld, lambda i: dattn(i, 0, "k")),
        "v_w": stack(Ld, lambda i: dattn(i, 0, "v")),
        "o_w": stack(Ld, lambda i: dattn(i, 0, "o")),
        "ln_x_w": stack(Ld, lambda i: norm("decoder", i, 1)),
        "xq_w": stack(Ld, lambda i: dattn(i, 1, "q")),
        "xk_w": stack(Ld, lambda i: dattn(i, 1, "k")),
        "xv_w": stack(Ld, lambda i: dattn(i, 1, "v")),
        "xo_w": stack(Ld, lambda i: dattn(i, 1, "o")),
        "ln2_w": stack(Ld, lambda i: norm("decoder", i, 2)),
        "wi": stack(Ld, lambda i: ffn("decoder", i, 2, "wi")),
        "wo": stack(Ld, lambda i: ffn("decoder", i, 2, "wo")),
    }
    out = {
        "embed": dense(get("shared.weight")),
        "enc": enc,
        "dec": dec,
        "enc_rel_bias": dense(  # [num_buckets, nH]
            get("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")),
        "dec_rel_bias": dense(
            get("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")),
        "enc_final_ln_w": dense(get("encoder.final_layer_norm.weight")),
        "dec_final_ln_w": dense(get("decoder.final_layer_norm.weight")),
    }
    if "lm_head.weight" in sd and not config.tie_head:
        out["lm_head"] = dense(get("lm_head.weight"))
    return out


def _rel_bucket(rel, bidirectional: bool, num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF T5Attention._relative_position_bucket on the CPU (int64 buckets);
    rel = memory_position - query_position. The float32 log is truncated to
    an integer, so the table is computed where the divisions are exact (the
    CPU; CUDA divides by a Python scalar through its reciprocal) and moved to
    the device by the caller."""
    rel = torch.as_tensor(rel, device="cpu").long()
    buckets = torch.zeros_like(rel)
    n = num_buckets
    if bidirectional:
        n //= 2
        buckets += (rel > 0).long() * n
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = n // 2
    is_small = rel < max_exact
    large = max_exact + (
        torch.log(rel.clamp(min=1).float() / max_exact)
        / math.log(max_distance / max_exact)
        * (n - max_exact)
    ).long()
    large = torch.clamp(large, max=n - 1)
    return buckets + torch.where(is_small, rel, large)


def _pos_bias(config: T5Config, table: torch.Tensor, q_pos, k_pos, bidirectional: bool):
    """[nH, Q, K] fp32 additive attention bias from the bucket table."""
    q_pos = torch.as_tensor(q_pos, device="cpu").long()
    k_pos = torch.as_tensor(k_pos, device="cpu").long()
    rel = k_pos[None, :] - q_pos[:, None]  # [Q, K]
    b = _rel_bucket(rel, bidirectional, config.num_buckets, config.max_distance)
    return table[b.to(table.device)].float().permute(2, 0, 1)


def _dot2(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` over x's last axis, with a float weight [K, N] or a
    per-output-channel int8 weight converted to x's dtype inside the call and
    scaled after the product (fp32), the JAX package's convert-into-dot
    formulation (its einsums are all this one contraction)."""
    if isinstance(w, QuantizedTensor):
        y = torch.matmul(x, w.q.to(x.dtype)).float()
        return (y * w.scale.float()).to(x.dtype)
    return torch.matmul(x, w.to(x.dtype))


def _mh(x, w, nH, dh):
    """x [B, S, D] @ w [D, nH*dh] -> [B, S, nH, dh]."""
    return _dot2(x, w).reshape(x.shape[0], x.shape[1], nH, dh)


def _heads(config: T5Config, mesh) -> int:
    """The heads of this rank."""
    return config.head_num // (1 if mesh is None else mesh.tp)


def _attn(q, k, v, bias, o_w, mesh=None):
    """Unscaled T5 attention. q [B, Q, nH, dh], k/v [B, K, nH, dh], bias
    [B or 1, nH, Q, K] additive fp32 (padding mask included); the heads of
    this rank under tp, the output reduced over the tp group."""
    scores = torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1)) + bias
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.matmul(p.float(), v.float().transpose(1, 2)).transpose(1, 2).to(q.dtype)
    B, Q = ctx.shape[0], ctx.shape[1]
    return all_reduce(_dot2(ctx.reshape(B, Q, -1), o_w), mesh)


def _ffn(config: T5Config, lp, h, mesh=None):
    return all_reduce(_dot2(apply_act(_dot2(h, lp["wi"]), config.activation), lp["wo"]), mesh)


def encode(config: T5Config, params, input_ids, lengths, mesh=None) -> torch.Tensor:
    """Encoder pass -> [B, S, d_model] (final RMSNorm applied), on the
    params' device; the inputs may be numpy arrays or tensors. ``mesh``:
    this rank's place under tp, ``params`` its slice."""
    dev = params["embed"].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev)
    B, S = input_ids.shape
    nH, dh = _heads(config, mesh), config.size_per_head
    x = params["embed"][input_ids]
    pad = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    pos = torch.arange(S)
    bias = _pos_bias(config, params["enc_rel_bias"], pos, pos, True)[None]
    bias = bias + torch.where(pad, 0.0, MASK_VALUE)[:, None, None, :]
    for l in range(config.layer_num):
        lp = layer_slice(params["enc"], l)
        h = rmsnorm(x, lp["ln1_w"], config.layernorm_eps)
        a = _attn(_mh(h, lp["q_w"], nH, dh), _mh(h, lp["k_w"], nH, dh),
                  _mh(h, lp["v_w"], nH, dh), bias, lp["o_w"], mesh)
        x = x + a
        x = x + _ffn(config, lp, rmsnorm(x, lp["ln2_w"], config.layernorm_eps), mesh)
    return rmsnorm(x, params["enc_final_ln_w"], config.layernorm_eps)


def init_decoder_state(config: T5Config, params, enc_hidden, enc_lengths, S_out: int,
                       mesh=None):
    """Self-attention cache slabs [Ld, B, S_out, nH, dh] and the cross K/V of
    every decoder layer, each projected from the encoder output in ONE batched
    product over the layers; ``enc_mask`` [B, S_enc] the additive key mask;
    ``self_bias`` the decoder's relative-position bias. Under tp, the rank's
    heads."""
    B, S_enc, D = enc_hidden.shape
    nH, dh = _heads(config, mesh), config.size_per_head
    Ld = config.dec_layer_num
    dev, dt = enc_hidden.device, enc_hidden.dtype
    dec = params["dec"]

    def proj_all(w):  # [B*S, D] @ [Ld, D, n] -> [Ld, B*S, n]
        x2 = enc_hidden.reshape(1, B * S_enc, D)
        if isinstance(w, QuantizedTensor):
            y = torch.matmul(x2, w.q.to(dt)).float() * w.scale.float()[:, None, :]
            y = y.to(dt)
        else:
            y = torch.matmul(x2, w.to(dt))
        return y.reshape(Ld, B, S_enc, nH, dh)

    lengths = torch.as_tensor(enc_lengths, device=dev)
    return {
        "self_k": torch.zeros((Ld, B, S_out, nH, dh), dtype=dt, device=dev),
        "self_v": torch.zeros((Ld, B, S_out, nH, dh), dtype=dt, device=dev),
        "cross_k": proj_all(dec["xk_w"]),
        "cross_v": proj_all(dec["xv_w"]),
        "enc_mask": torch.where(torch.arange(S_enc, device=dev)[None, :] < lengths[:, None],
                                0.0, MASK_VALUE),
        # [nH, S_out, S_out]: the causal bucket bias of every (query, key)
        # position pair, built once; a step reads its row
        "self_bias": _pos_bias(config, params["dec_rel_bias"], torch.arange(S_out),
                               torch.arange(S_out), False),
    }


def decode_step(config: T5Config, params, state, tokens, pos: int, mesh=None):
    """One incremental decoder step at position ``pos`` (a host int): the
    step's K/V written into the self-attention slabs, attention over
    positions 0..pos (the JAX package attends the whole slab under a causal
    mask, which weighs the later positions zero). tokens [B]. Returns
    (logits [B, V] fp32, state), the state updated in place. Under autograd
    (a training loss through the served step, ``tools/t5_quality_row.py``)
    attention reads a copy of the slabs' rows, as the JAX step is pure."""
    pos = int(pos)
    nH, dh = _heads(config, mesh), config.size_per_head
    dec = params["dec"]
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    x = params["embed"][tokens][:, None]  # [B, 1, D]
    self_bias = state["self_bias"][None, :, pos: pos + 1, : pos + 1]  # [1, nH, 1, pos + 1]
    cross_bias = state["enc_mask"][:, None, None, :]
    for l in range(config.dec_layer_num):
        lp = layer_slice(dec, l)
        h = rmsnorm(x, lp["ln1_w"], config.layernorm_eps)
        q = _mh(h, lp["q_w"], nH, dh)
        state["self_k"][l, :, pos] = _mh(h, lp["k_w"], nH, dh)[:, 0]
        state["self_v"][l, :, pos] = _mh(h, lp["v_w"], nH, dh)[:, 0]
        k_l, v_l = state["self_k"][l, :, : pos + 1], state["self_v"][l, :, : pos + 1]
        if torch.is_grad_enabled():  # later slab writes must not reach saved rows
            k_l, v_l = k_l.clone(), v_l.clone()
        x = x + _attn(q, k_l, v_l, self_bias, lp["o_w"], mesh)
        hx = rmsnorm(x, lp["ln_x_w"], config.layernorm_eps)
        x = x + _attn(_mh(hx, lp["xq_w"], nH, dh), state["cross_k"][l], state["cross_v"][l],
                      cross_bias, lp["xo_w"], mesh)
        x = x + _ffn(config, lp, rmsnorm(x, lp["ln2_w"], config.layernorm_eps), mesh)
    h = rmsnorm(x[:, 0], params["dec_final_ln_w"], config.layernorm_eps)
    if config.tie_head:
        h = h * (config.d_model ** -0.5)  # HF's tied-embedding rescale
        w = params["embed"]
    else:
        w = params["lm_head"]
    return h.float() @ w.float().t(), state


@torch.no_grad()
def greedy_generate(config: T5Config, params, input_ids, lengths, max_out: int) -> np.ndarray:
    """Encoder pass + incremental greedy decode. Returns [B, n <= max_out]
    int32, end_id-padded after EOS (it stops once every row has ended)."""
    enc = encode(config, params, input_ids, lengths)
    state = init_decoder_state(config, params, enc, lengths, max_out + 1)
    B = enc.shape[0]
    tok = np.full((B,), config.start_id, np.int64)
    outs = []
    finished = np.zeros((B,), bool)
    for t in range(max_out):
        logits, state = decode_step(config, params, state, tok, t)
        step = torch.argmax(logits, dim=-1).cpu().numpy()
        step = np.where(finished, config.end_id, step)
        outs.append(step.astype(np.int32))
        finished |= step == config.end_id
        if finished.all():
            break
        tok = step
    return np.stack(outs, axis=1)


# ------------------------------------------------------------ int8 weights --

_GEMM_NAMES = ("q_w", "k_w", "v_w", "o_w", "xq_w", "xk_w", "xv_w", "xo_w", "wi", "wo")


def quantize_t5_params(params):
    """Per-output-channel symmetric int8 on every stacked GEMM weight
    ([L, K, N], k_axis=-2) of both stacks, on the weights' device (the
    ``ckpt.quantize.quantize_array`` math); norms, relative-bias tables and
    embeddings stay float."""
    from ..ckpt.quantize import quantize_array

    out = dict(params)
    for stack in ("enc", "dec"):
        out[stack] = {
            k: (quantize_array(v, k_axis=-2) if k in _GEMM_NAMES else v)
            for k, v in params[stack].items()
        }
    return out


# ------------------------------------------------------------ TP sharding --

# Split axes of the stacked [L, K, N] weights (the JAX t5_param_shardings'
# COL and ROW); every other weight is replicated.
_T5_SPLITS = {"q_w": 2, "k_w": 2, "v_w": 2, "xq_w": 2, "xk_w": 2, "xv_w": 2, "wi": 2,
              "o_w": 1, "xo_w": 1, "wo": 1}


def shard_t5_params(config: T5Config, params, mesh):
    """This rank's slice of the params (the JAX ``shard_t5_params``): heads
    and FFN columns split, the relative-bias tables [buckets, nH] split by
    head, embeddings, norms and the head replicated."""
    if mesh.tp == 1:
        return params
    if config.head_num % mesh.tp:
        raise ValueError(f"{config.head_num} heads do not split over tp {mesh.tp}")
    out = {}
    for k, v in params.items():
        if k in ("enc", "dec"):
            out[k] = {n: shard_tensor(val, _T5_SPLITS.get(n), mesh, n)
                      for n, val in v.items()}
        elif k in ("enc_rel_bias", "dec_rel_bias"):
            out[k] = shard_tensor(v, 1, mesh, k)
        else:
            out[k] = v
    return out
