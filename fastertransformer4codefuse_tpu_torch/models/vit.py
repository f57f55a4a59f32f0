"""ViT encoder family (port of models/vit.py): a patch-embedding vision
transformer, the first non-text family.

  - patch embedding: the stride-P PxP conv as one reshape (``patchify``) and
    a GEMM over a plain [C*P*P, H] weight;
  - a learned [CLS] token prepended, learned absolute position embeddings;
  - pre-LN blocks (x + attn(LN(x)), x + mlp(LN(x))) and a final LayerNorm;
  - an optional tanh pooler over [CLS].

No attention mask: every patch attends every patch. The products are plain
PyTorch (``ops.linear`` on float weights), as the JAX package leaves them to
XLA.
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


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    head_num: int
    size_per_head: int
    layer_num: int
    image_size: int
    patch_size: int
    num_channels: int = 3
    inter_size: Optional[int] = None
    layernorm_eps: float = 1e-12
    activation: str = "gelu"
    model_name: str = "vit"

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def config_from_hf_vit(hf_config, model_name="vit") -> ViTConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    nH = g("num_attention_heads")
    H = g("hidden_size")
    return ViTConfig(
        head_num=nH,
        size_per_head=H // nH,
        layer_num=g("num_hidden_layers"),
        image_size=g("image_size"),
        patch_size=g("patch_size"),
        num_channels=g("num_channels", 3),
        inter_size=g("intermediate_size"),
        layernorm_eps=float(g("layer_norm_eps", 1e-12)),
        activation={"gelu": "gelu", "gelu_new": "gelu-tanh",
                    "relu": "relu"}.get(g("hidden_act", "gelu"), "gelu"),
        model_name=model_name,
    )


def params_from_hf_vit_state_dict(
    config: ViTConfig, state_dict: Mapping[str, Any], dtype=torch.float32, device=None
) -> Dict[str, Any]:
    """HF ``ViTModel`` weights -> the stacked params dict, in ``dtype`` on
    ``device`` (the CUDA card when None)."""
    from ..ckpt.convert import _np, stack_layers
    from ..core.dtypes import torch_dtype

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    sd = dict(state_dict)
    pre = "vit." if "vit.embeddings.cls_token" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    def dense(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def stack(fn):
        return stack_layers(fn, config.layer_num, dtype, device)

    def lw(i, name):
        return get(f"encoder.layer.{i}.{name}")

    def fused_qkv(i):
        return np.concatenate([lw(i, f"attention.attention.{n}.weight").T
                               for n in ("query", "key", "value")], axis=1)

    def fused_qkv_b(i):
        return np.concatenate([lw(i, f"attention.attention.{n}.bias")
                               for n in ("query", "key", "value")])

    layers = {
        "ln1_w": stack(lambda i: lw(i, "layernorm_before.weight")),
        "ln1_b": stack(lambda i: lw(i, "layernorm_before.bias")),
        "qkv_w": stack(fused_qkv),
        "qkv_b": stack(fused_qkv_b),
        "proj_w": stack(lambda i: lw(i, "attention.output.dense.weight").T),
        "proj_b": stack(lambda i: lw(i, "attention.output.dense.bias")),
        "ln2_w": stack(lambda i: lw(i, "layernorm_after.weight")),
        "ln2_b": stack(lambda i: lw(i, "layernorm_after.bias")),
        "up_w": stack(lambda i: lw(i, "intermediate.dense.weight").T),
        "up_b": stack(lambda i: lw(i, "intermediate.dense.bias")),
        "down_w": stack(lambda i: lw(i, "output.dense.weight").T),
        "down_b": stack(lambda i: lw(i, "output.dense.bias")),
    }
    # stride-P conv [H, C, P, P] -> patch GEMM [C*P*P, H]: the patch pixels
    # flatten (C, ph, pw) row-major, the conv's contraction order
    conv_w = get("embeddings.patch_embeddings.projection.weight")
    out = {
        "cls": dense(get("embeddings.cls_token")[0, 0]),  # [H]
        "pos_embed": dense(get("embeddings.position_embeddings")[0]),
        "patch_w": dense(conv_w.reshape(conv_w.shape[0], -1).T),
        "patch_b": dense(get("embeddings.patch_embeddings.projection.bias")),
        "final_ln_w": dense(get("layernorm.weight")),
        "final_ln_b": dense(get("layernorm.bias")),
        "layers": layers,
    }
    if pre + "pooler.dense.weight" in sd:
        out["pooler_w"] = dense(get("pooler.dense.weight").T)
        out["pooler_b"] = dense(get("pooler.dense.bias"))
    return out


def _float_input(x, dev) -> torch.Tensor:
    """Pixels or audio on ``dev`` in their own float dtype (float64 and
    integer inputs as float32): as in the JAX package, the input's dtype is
    the activations' dtype, whatever the weights' (fp32 pixels over bf16
    weights run fp32 activations; bf16 pixels, bf16)."""
    x = torch.as_tensor(x, device=dev)
    return x.float() if x.dtype == torch.float64 or not x.is_floating_point() else x


def patchify(config, pixels: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, nP, C*P*P] (channel-major per patch, the conv's
    contraction order). ``config`` needs only ``patch_size``."""
    B, C, Hh, Ww = pixels.shape
    P = config.patch_size
    x = pixels.reshape(B, C, Hh // P, P, Ww // P, P)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, gh, gw, C, P, P]
    return x.reshape(B, (Hh // P) * (Ww // P), C * P * P)


def _attention(q, k, v, scale):
    """Softmax attention in fp32 over [B, S, nH, dh] -> [B, S, nH, dh] in q's
    dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


def encode(config: ViTConfig, params: Dict[str, Any], pixels):
    """Full ViT pass. pixels [B, C, H, W] (numpy or a tensor; their dtype is
    the activations') -> (hidden [B, 1+nP, H], pooled [B, H] or None), on
    the params' device."""
    dev = params["patch_w"].device
    pixels = _float_input(pixels, dev)
    B = pixels.shape[0]
    x = linear(patchify(config, pixels), params["patch_w"], params["patch_b"])
    cls = params["cls"].to(x.dtype)[None, None, :].expand(B, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"][None, : x.shape[1]]

    nH, dh = config.head_num, config.size_per_head
    for l in range(config.layer_num):
        lp = layer_slice(params["layers"], l)
        h = layernorm(x, lp["ln1_w"], lp["ln1_b"], config.layernorm_eps)
        S, Hd = h.shape[1], h.shape[2]
        qkv = linear(h, lp["qkv_w"], lp["qkv_b"])
        q = qkv[..., :Hd].reshape(B, S, nH, dh)
        k = qkv[..., Hd: 2 * Hd].reshape(B, S, nH, dh)
        v = qkv[..., 2 * Hd:].reshape(B, S, nH, dh)
        a = _attention(q, k, v, 1.0 / (dh ** 0.5)).reshape(B, S, Hd)
        x = x + linear(a, lp["proj_w"], lp["proj_b"])  # pre-LN residual
        h2 = layernorm(x, lp["ln2_w"], lp["ln2_b"], config.layernorm_eps)
        f = linear(h2, lp["up_w"], lp["up_b"], act=config.activation)
        x = x + linear(f, lp["down_w"], lp["down_b"])
    x = layernorm(x, params["final_ln_w"], params["final_ln_b"], config.layernorm_eps)
    pooled = None
    if "pooler_w" in params:
        pooled = torch.tanh(linear(x[:, 0], params["pooler_w"], params["pooler_b"]))
    return x, pooled
