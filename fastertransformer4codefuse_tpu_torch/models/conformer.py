"""Conformer audio-encoder family (port of models/conformer.py), the
reference's WeNet encoder class.

A Conformer block: half-step macaron FFNs around Transformer-XL-style
relative attention (pos_bias_u / pos_bias_v and the ESPnet shift) and a
convolution module (pointwise -> GLU -> depthwise -> batch norm -> act ->
pointwise). Parity oracle: HF Wav2Vec2ConformerModel with
position_embeddings_type="relative", its raw-audio feature extractor
(strided 1-D convolutions with feat_extract_norm "group" or "layer")
included, so the encoder runs from the waveform to the hidden states. (The
JAX package reads every conv layer's norm as a GroupNorm, right for
"group" only.)

The convolutions are XLA ops in the JAX package; here they are
``torch.nn.functional.conv1d``. ``encode`` on the card turns
``torch.backends.cudnn.benchmark`` off, so that cuDNN picks the same
algorithm each call and two calls give equal bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.layernorm import layernorm
from ..ops.linear import apply_act, linear
from .params import layer_slice
from .vit import _float_input


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    head_num: int
    size_per_head: int
    layer_num: int
    inter_size: int
    conv_dim: Tuple[int, ...]
    conv_stride: Tuple[int, ...]
    conv_kernel: Tuple[int, ...]
    depthwise_kernel: int = 31
    layernorm_eps: float = 1e-5
    activation: str = "gelu"
    feat_activation: str = "gelu"
    # HF's feat_extract_norm: "group" (a per-channel GroupNorm on the first
    # conv layer) or "layer" (a LayerNorm over the channels after every conv
    # layer, the large checkpoints' form)
    feat_extract_norm: str = "group"
    model_name: str = "conformer"

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head


def config_from_hf_conformer(hf_config, model_name="conformer") -> ConformerConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    if g("position_embeddings_type") != "relative":
        raise ValueError("the conformer family implements the relative-attention variant "
                         "(the WeNet/ESPnet form)")
    nH = g("num_attention_heads")
    H = g("hidden_size")
    amap = {"gelu": "gelu", "gelu_new": "gelu-tanh", "relu": "relu", "swish": "silu",
            "silu": "silu"}
    return ConformerConfig(
        head_num=nH,
        size_per_head=H // nH,
        layer_num=g("num_hidden_layers"),
        inter_size=g("intermediate_size"),
        conv_dim=tuple(g("conv_dim")),
        conv_stride=tuple(g("conv_stride")),
        conv_kernel=tuple(g("conv_kernel")),
        depthwise_kernel=g("conv_depthwise_kernel_size", 31),
        layernorm_eps=float(g("layer_norm_eps", 1e-5)),
        activation=amap.get(g("hidden_act", "gelu"), "gelu"),
        feat_activation=amap.get(g("feat_extract_activation", "gelu"), "gelu"),
        feat_extract_norm=g("feat_extract_norm", "group"),
        model_name=model_name,
    )


def params_from_hf_conformer_state_dict(
    config: ConformerConfig, state_dict: Mapping[str, Any], dtype=torch.float32, device=None
) -> Dict[str, Any]:
    """HF ``Wav2Vec2ConformerModel`` weights -> the params dict (a list of
    feature-extractor layers, stacked encoder layers), in ``dtype`` on
    ``device`` (the CUDA card when None)."""
    from ..ckpt.convert import _np, stack_layers
    from ..core.dtypes import torch_dtype

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    sd = dict(state_dict)
    pre = ("wav2vec2_conformer."
           if "wav2vec2_conformer.feature_projection.projection.weight" in sd else "")

    def get(name):
        return _np(sd[pre + name])

    def dense(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def stack(fn):
        return stack_layers(fn, config.layer_num, dtype, device)

    feat = []
    for li in range(len(config.conv_dim)):
        c = f"feature_extractor.conv_layers.{li}."
        fl = {"conv_w": dense(get(c + "conv.weight"))}
        if pre + c + "conv.bias" in sd:
            fl["conv_b"] = dense(get(c + "conv.bias"))
        if pre + c + "layer_norm.weight" in sd:
            norm = "ln" if config.feat_extract_norm == "layer" else "gn"
            fl[f"{norm}_w"] = dense(get(c + "layer_norm.weight"))
            fl[f"{norm}_b"] = dense(get(c + "layer_norm.bias"))
        feat.append(fl)

    def lw(i, name):
        return get(f"encoder.layers.{i}.{name}")

    layers = {}
    for which in ("ffn1", "ffn2"):
        layers.update({
            f"{which}_ln_w": stack(lambda i, w=which: lw(i, f"{w}_layer_norm.weight")),
            f"{which}_ln_b": stack(lambda i, w=which: lw(i, f"{w}_layer_norm.bias")),
            f"{which}_up_w": stack(lambda i, w=which: lw(i, f"{w}.intermediate_dense.weight").T),
            f"{which}_up_b": stack(lambda i, w=which: lw(i, f"{w}.intermediate_dense.bias")),
            f"{which}_down_w": stack(lambda i, w=which: lw(i, f"{w}.output_dense.weight").T),
            f"{which}_down_b": stack(lambda i, w=which: lw(i, f"{w}.output_dense.bias")),
        })
    for short, name in (("q", "linear_q"), ("k", "linear_k"), ("v", "linear_v"),
                        ("o", "linear_out")):
        layers[f"{short}_w"] = stack(lambda i, n=name: lw(i, f"self_attn.{n}.weight").T)
        layers[f"{short}_b"] = stack(lambda i, n=name: lw(i, f"self_attn.{n}.bias"))
    cm = "conv_module."
    layers.update({
        "attn_ln_w": stack(lambda i: lw(i, "self_attn_layer_norm.weight")),
        "attn_ln_b": stack(lambda i: lw(i, "self_attn_layer_norm.bias")),
        "pos_w": stack(lambda i: lw(i, "self_attn.linear_pos.weight").T),
        "bias_u": stack(lambda i: lw(i, "self_attn.pos_bias_u")),  # [nH, dh]
        "bias_v": stack(lambda i: lw(i, "self_attn.pos_bias_v")),
        "conv_ln_w": stack(lambda i: lw(i, cm + "layer_norm.weight")),
        "conv_ln_b": stack(lambda i: lw(i, cm + "layer_norm.bias")),
        "pw1_w": stack(lambda i: lw(i, cm + "pointwise_conv1.weight")[:, :, 0].T),
        "dw_w": stack(lambda i: lw(i, cm + "depthwise_conv.weight")),  # [C, 1, K]
        "bn_w": stack(lambda i: lw(i, cm + "batch_norm.weight")),
        "bn_b": stack(lambda i: lw(i, cm + "batch_norm.bias")),
        "bn_mean": stack(lambda i: lw(i, cm + "batch_norm.running_mean")),
        "bn_var": stack(lambda i: lw(i, cm + "batch_norm.running_var")),
        "pw2_w": stack(lambda i: lw(i, cm + "pointwise_conv2.weight")[:, :, 0].T),
        "final_ln_w": stack(lambda i: lw(i, "final_layer_norm.weight")),
        "final_ln_b": stack(lambda i: lw(i, "final_layer_norm.bias")),
    })
    return {
        "feat": feat,
        "proj_ln_w": dense(get("feature_projection.layer_norm.weight")),
        "proj_ln_b": dense(get("feature_projection.layer_norm.bias")),
        "proj_w": dense(get("feature_projection.projection.weight").T),
        "proj_b": dense(get("feature_projection.projection.bias")),
        "enc_ln_w": dense(get("encoder.layer_norm.weight")),
        "enc_ln_b": dense(get("encoder.layer_norm.bias")),
        "layers": layers,
    }


def _rel_pos_emb(D: int, S: int) -> torch.Tensor:
    """ESPnet relative PE: [2S-1, D] fp32 on the CPU (computed in float64),
    the positive part reversed, then the negatives."""
    pos = np.arange(S, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, D, 2, dtype=np.float64) * -(np.log(10000.0) / D))
    pe_pos = np.zeros((S, D))
    pe_neg = np.zeros((S, D))
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    pe = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)
    return torch.from_numpy(pe.astype(np.float32))


def feature_extract(config: ConformerConfig, params, audio: torch.Tensor) -> torch.Tensor:
    """Raw audio [B, T] -> features [B, T', conv_dim[-1]]: strided 1-D
    convolutions, then a per-channel GroupNorm over time where the
    checkpoint has one (``gn_w``: the first layer) or a LayerNorm over the
    channels of each frame (``ln_w``: every layer), then the activation."""
    x = audio[:, None, :]  # [B, 1, T]
    for li, fl in enumerate(params["feat"]):
        x = F.conv1d(x, fl["conv_w"].to(x.dtype), stride=config.conv_stride[li])
        if "conv_b" in fl:
            x = x + fl["conv_b"][None, :, None]
        if "gn_w" in fl:  # GroupNorm(groups == channels): per channel over T
            mean = x.mean(dim=2, keepdim=True)
            var = x.var(dim=2, keepdim=True, unbiased=False)
            x = (x - mean) / torch.sqrt(var + 1e-5)
            x = x * fl["gn_w"][None, :, None] + fl["gn_b"][None, :, None]
        if "ln_w" in fl:  # nn.LayerNorm(C) at its default eps
            x = layernorm(x.transpose(1, 2), fl["ln_w"], fl["ln_b"], 1e-5).transpose(1, 2)
        x = apply_act(x, config.feat_activation)
    return x.transpose(1, 2)  # [B, T', C]


def _conv_module(config, lp, x):
    """LN -> pointwise (2C) + GLU -> depthwise (K, same padding) -> batch norm
    (eval) -> act -> pointwise."""
    C = x.shape[-1]
    h = layernorm(x, lp["conv_ln_w"], lp["conv_ln_b"], config.layernorm_eps)
    h = linear(h, lp["pw1_w"])  # [B, S, 2C]
    h = h[..., :C] * torch.sigmoid(h[..., C:])  # GLU over the channel split
    K = lp["dw_w"].shape[-1]
    hh = F.conv1d(h.transpose(1, 2), lp["dw_w"].to(h.dtype), padding=(K - 1) // 2, groups=C)
    hh = (hh - lp["bn_mean"][None, :, None]) / torch.sqrt(lp["bn_var"][None, :, None] + 1e-5)
    hh = hh * lp["bn_w"][None, :, None] + lp["bn_b"][None, :, None]
    hh = apply_act(hh, config.activation)
    return linear(hh.transpose(1, 2), lp["pw2_w"])


def _espnet_shift(bd: torch.Tensor) -> torch.Tensor:
    """The ESPnet relative shift as an explicit gather: [B, nH, S, 2S-1] ->
    [B, nH, S, S] with out[..., i, j] = bd[..., i, S - 1 - i + j]. (HF pads a
    zero column, reshapes to [2S, S], drops the first row, reshapes back and
    keeps the first S columns: for j < S the flat index lands on column
    S - 1 - i + j of row i, never on the pad.)"""
    S = bd.shape[2]
    i = torch.arange(S, device=bd.device)[:, None]
    j = torch.arange(S, device=bd.device)[None, :]
    idx = (S - 1 - i + j)[None, None].expand(bd.shape[0], bd.shape[1], S, S)
    return torch.gather(bd, -1, idx)


def _rel_attention(config, lp, x, pe):
    """Transformer-XL attention with pos_bias_u/v and the ESPnet shift."""
    B, S, H = x.shape
    nH, dh = config.head_num, config.size_per_head
    q = linear(x, lp["q_w"], lp["q_b"]).reshape(B, S, nH, dh)
    k = linear(x, lp["k_w"], lp["k_b"]).reshape(B, S, nH, dh)
    v = linear(x, lp["v_w"], lp["v_b"]).reshape(B, S, nH, dh)
    p = linear(pe[None], lp["pos_w"]).reshape(2 * S - 1, nH, dh)
    ac = torch.einsum("bihd,bjhd->bhij", (q + lp["bias_u"].to(q.dtype)).float(), k.float())
    bd = torch.einsum("bihd,jhd->bhij", (q + lp["bias_v"].to(q.dtype)).float(), p.float())
    scores = (ac + _espnet_shift(bd)) / (dh ** 0.5)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhij,bjhd->bihd", probs.float(), v.float()).to(x.dtype)
    return linear(ctx.reshape(B, S, H), lp["o_w"], lp["o_b"])


def encode(config: ConformerConfig, params: Dict[str, Any], audio):
    """Raw audio [B, T] (numpy or a tensor; its dtype is the activations') ->
    (hidden [B, T', H], None), on the params' device."""
    dev = params["proj_w"].device
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = False  # one algorithm a shape: equal bytes
    audio = _float_input(audio, dev)
    x = feature_extract(config, params, audio)
    x = layernorm(x, params["proj_ln_w"], params["proj_ln_b"], config.layernorm_eps)
    x = linear(x, params["proj_w"], params["proj_b"])
    pe = _rel_pos_emb(config.hidden_size, x.shape[1]).to(device=dev, dtype=x.dtype)

    def ffn_half(lp, x, which):
        h = layernorm(x, lp[f"{which}_ln_w"], lp[f"{which}_ln_b"], config.layernorm_eps)
        h = linear(h, lp[f"{which}_up_w"], lp[f"{which}_up_b"], act=config.activation)
        return x + 0.5 * linear(h, lp[f"{which}_down_w"], lp[f"{which}_down_b"])

    for l in range(config.layer_num):
        lp = layer_slice(params["layers"], l)
        x = ffn_half(lp, x, "ffn1")
        h = layernorm(x, lp["attn_ln_w"], lp["attn_ln_b"], config.layernorm_eps)
        x = x + _rel_attention(config, lp, h, pe)
        x = x + _conv_module(config, lp, x)
        x = ffn_half(lp, x, "ffn2")
        x = layernorm(x, lp["final_ln_w"], lp["final_ln_b"], config.layernorm_eps)
    return layernorm(x, params["enc_ln_w"], params["enc_ln_b"], config.layernorm_eps), None
