"""XLNet encoder family (port of models/xlnet.py): Transformer-XL relative
attention.

Scores are the sum of a content term (q + r_w_bias against the keys), a
relative-position term (q + r_r_bias against sinusoid-projected positions,
realigned row by row by the rel-shift) and, with token types, a segment term
(q + r_s_bias against the learned same/other-segment embeddings). Post-LN
blocks. The no-permutation inference path (the content stream only), HF
XLNetModel with attn_type "bi" and use_mems=False, its padding semantics
included: an additive -1e30 on padded keys with the diagonal re-opened.
The products are plain PyTorch, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.layernorm import layernorm
from ..ops.linear import apply_act, linear
from .params import layer_slice


@dataclasses.dataclass(frozen=True)
class XLNetConfig:
    head_num: int
    size_per_head: int
    layer_num: int
    vocab_size: int
    inter_size: int
    layernorm_eps: float = 1e-12
    activation: str = "gelu"
    clamp_len: int = -1
    model_name: str = "xlnet"

    @property
    def d_model(self) -> int:
        return self.head_num * self.size_per_head


def config_from_hf_xlnet(hf_config, model_name="xlnet") -> XLNetConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    return XLNetConfig(
        head_num=g("n_head"),
        size_per_head=g("d_head"),
        layer_num=g("n_layer"),
        vocab_size=g("vocab_size"),
        inter_size=g("d_inner"),
        layernorm_eps=float(g("layer_norm_eps", 1e-12)),
        activation={"gelu": "gelu", "relu": "relu"}.get(g("ff_activation", "gelu"), "gelu"),
        clamp_len=int(g("clamp_len", -1)),
        model_name=model_name,
    )


def params_from_hf_xlnet_state_dict(
    config: XLNetConfig, state_dict: Mapping[str, Any], dtype=torch.float32, device=None
) -> Dict[str, Any]:
    """HF ``XLNetModel`` weights -> the stacked params dict, in ``dtype`` on
    ``device`` (the CUDA card when None). The attention projections stay
    [d_model, nH, dh] as HF stores them."""
    from ..ckpt.convert import _np, stack_layers
    from ..core.dtypes import torch_dtype

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    sd = dict(state_dict)
    pre = "transformer." if "transformer.word_embedding.weight" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    def stack(fn):
        return stack_layers(fn, config.layer_num, dtype, device)

    def ra(i, name):
        return get(f"layer.{i}.rel_attn.{name}")

    layers = {n: stack(lambda i, n=n: ra(i, n))
              for n in ("q", "k", "v", "o", "r", "r_w_bias", "r_r_bias", "r_s_bias",
                        "seg_embed")}
    layers.update({
        "attn_ln_w": stack(lambda i: ra(i, "layer_norm.weight")),
        "attn_ln_b": stack(lambda i: ra(i, "layer_norm.bias")),
        "ff1_w": stack(lambda i: get(f"layer.{i}.ff.layer_1.weight").T),
        "ff1_b": stack(lambda i: get(f"layer.{i}.ff.layer_1.bias")),
        "ff2_w": stack(lambda i: get(f"layer.{i}.ff.layer_2.weight").T),
        "ff2_b": stack(lambda i: get(f"layer.{i}.ff.layer_2.bias")),
        "ff_ln_w": stack(lambda i: get(f"layer.{i}.ff.layer_norm.weight")),
        "ff_ln_b": stack(lambda i: get(f"layer.{i}.ff.layer_norm.bias")),
    })
    embed = torch.from_numpy(get("word_embedding.weight")).to(device=device, dtype=dtype)
    return {"embed": embed, "layers": layers}


def _pos_emb(config: XLNetConfig, S: int) -> torch.Tensor:
    """Sinusoid relative-position embeddings for attn_type "bi": positions
    S down to -S+1 -> [2S, d_model] fp32 on the CPU (computed in float64)."""
    D = config.d_model
    freq = np.arange(0, D, 2.0, dtype=np.float64)
    inv = 1.0 / np.power(10000.0, freq / D)
    pos = np.arange(S, -S, -1.0, dtype=np.float64)
    if config.clamp_len > 0:
        pos = np.clip(pos, -config.clamp_len, config.clamp_len)
    sin = np.einsum("i,d->id", pos, inv)
    return torch.from_numpy(np.concatenate([np.sin(sin), np.cos(sin)], axis=-1).astype(np.float32))


def _rel_shift(x: torch.Tensor, klen: int) -> torch.Tensor:
    """HF rel_shift_bnij as an explicit gather: [B, N, I, J] -> [B, N, I,
    klen]. HF reshapes to [J, I], drops the first row and reshapes back to
    [I, J - 1]: out[..., i, j] is flat element I + i*(J - 1) + j of the
    [I, J] scores, which for XLNet's J = 2I is x[..., i, I - i + j] (row i
    realigned so that column j is key j)."""
    B, N, I, J = x.shape
    i = torch.arange(I, device=x.device)[:, None]
    j = torch.arange(klen, device=x.device)[None, :]
    flat = (I + i * (J - 1) + j).reshape(-1)  # [I * klen]
    return x.reshape(B, N, I * J)[..., flat].reshape(B, N, I, klen)


def encode(config: XLNetConfig, params: Dict[str, Any], input_ids, lengths,
           token_type_ids: Optional[Any] = None):
    """Content-stream forward -> (last_hidden [B, S, D], None), on the
    params' device; the inputs may be numpy arrays or tensors."""
    dev = params["embed"].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev)
    B, S = input_ids.shape
    scale = 1.0 / (config.size_per_head ** 0.5)
    x = params["embed"][input_ids]  # [B, S, D]
    r = _pos_emb(config, S).to(device=dev, dtype=x.dtype)  # [2S, D]

    real = torch.arange(S, device=dev)[None, :] < lengths[:, None]  # [B, S]
    # HF's padding: additive -1e30 on padded KEYS, the diagonal re-opened
    # (non_tgt_mask's -eye) so that a padded row still attends itself
    eye = torch.eye(S, dtype=torch.bool, device=dev)[None]
    attn_mask = ((~real)[:, None, :] & ~eye).float()[:, None]  # [B, 1, S, S]
    seg_onehot = None
    if token_type_ids is not None:
        tt = torch.as_tensor(token_type_ids, device=dev)
        seg_diff = (tt[:, :, None] != tt[:, None, :]).long()
        seg_onehot = torch.nn.functional.one_hot(seg_diff, 2).float()  # [B, i, j, 2]

    for l in range(config.layer_num):
        lp = layer_slice(params["layers"], l)
        q = torch.einsum("bih,hnd->bind", x, lp["q"].to(x.dtype))
        k = torch.einsum("bih,hnd->bind", x, lp["k"].to(x.dtype))
        v = torch.einsum("bih,hnd->bind", x, lp["v"].to(x.dtype))
        kr = torch.einsum("jh,hnd->jnd", r, lp["r"].to(x.dtype))
        ac = torch.einsum("bind,bjnd->bnij", (q + lp["r_w_bias"].to(x.dtype)).float(), k.float())
        bd = torch.einsum("bind,jnd->bnij", (q + lp["r_r_bias"].to(x.dtype)).float(), kr.float())
        score = ac + _rel_shift(bd, klen=S)
        if seg_onehot is not None:
            ef = torch.einsum("bind,snd->bins", (q + lp["r_s_bias"].to(x.dtype)).float(),
                              lp["seg_embed"].float())
            score = score + torch.einsum("bijs,bins->bnij", seg_onehot, ef)
        score = score * scale - 1e30 * attn_mask
        probs = torch.softmax(score, dim=-1).to(x.dtype)
        av = torch.einsum("bnij,bjnd->bind", probs.float(), v.float()).to(x.dtype)
        attn_out = torch.einsum("bind,hnd->bih", av.float(), lp["o"].float()).to(x.dtype)
        x = layernorm(attn_out + x, lp["attn_ln_w"], lp["attn_ln_b"], config.layernorm_eps)
        f = apply_act(linear(x, lp["ff1_w"], lp["ff1_b"]), config.activation)
        f = linear(f, lp["ff2_w"], lp["ff2_b"])
        x = layernorm(f + x, lp["ff_ln_w"], lp["ff_ln_b"], config.layernorm_eps)
    return x, None
