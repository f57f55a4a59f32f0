"""Swin encoder family (port of models/swin.py): shifted-window 2D attention.

Attention runs inside MxM pixel windows (a [nW*B, M*M, dh] batched
attention) with learned relative-position biases per window, every other
block on windows shifted by M/2 (a cyclic roll plus a region mask, so that
pixels wrapped across the seam do not attend each other). Patch merging
halves the resolution and doubles the width between stages, so the stages
are a Python loop.

Parity with HF SwinModel (modeling_swin.py):
  - relative_position_index loads straight from the checkpoint buffer;
  - the shifted-window mask fills HF's -100.0 (not -inf);
  - patch merging gathers the 2x2 neighbours in (even-even, odd-even,
    even-odd, odd-odd) order, norms the 4C concat, then reduces bias-free;
  - the pooled output is the mean over the final sequence.
The products are plain PyTorch, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.layernorm import layernorm
from ..ops.linear import linear
from .vit import _float_input, patchify


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_size: int
    patch_size: int
    embed_dim: int
    depths: Tuple[int, ...]
    num_heads: Tuple[int, ...]
    window_size: int
    num_channels: int = 3
    mlp_ratio: float = 4.0
    layernorm_eps: float = 1e-5
    activation: str = "gelu"
    model_name: str = "swin"


def config_from_hf_swin(hf_config, model_name="swin") -> SwinConfig:
    g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    return SwinConfig(
        image_size=g("image_size"),
        patch_size=g("patch_size"),
        embed_dim=g("embed_dim"),
        depths=tuple(g("depths")),
        num_heads=tuple(g("num_heads")),
        window_size=g("window_size"),
        num_channels=g("num_channels", 3),
        mlp_ratio=float(g("mlp_ratio", 4.0)),
        layernorm_eps=float(g("layer_norm_eps", 1e-5)),
        activation={"gelu": "gelu", "gelu_new": "gelu-tanh"}.get(g("hidden_act", "gelu"), "gelu"),
        model_name=model_name,
    )


def params_from_hf_swin_state_dict(
    config: SwinConfig, state_dict: Mapping[str, Any], dtype=torch.float32, device=None
) -> Dict[str, Any]:
    """HF ``SwinModel`` weights -> the params dict (a list of stages, each a
    list of block dicts), in ``dtype`` on ``device`` (the CUDA card when
    None); the relative-position index stays int64."""
    from ..ckpt.convert import _np
    from ..core.dtypes import torch_dtype

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    sd = dict(state_dict)
    pre = "swin." if "swin.embeddings.patch_embeddings.projection.weight" in sd else ""

    def get(name):
        return _np(sd[pre + name])

    def dense(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    conv_w = get("embeddings.patch_embeddings.projection.weight")
    stages: List[Dict[str, Any]] = []
    for si, depth in enumerate(config.depths):
        blocks = []
        for bi in range(depth):
            p = f"encoder.layers.{si}.blocks.{bi}."
            a = p + "attention."
            index = sd[pre + a + "self.relative_position_index"]
            blocks.append({
                "ln1_w": dense(get(p + "layernorm_before.weight")),
                "ln1_b": dense(get(p + "layernorm_before.bias")),
                "bias_table": dense(get(a + "self.relative_position_bias_table")),
                "bias_index": torch.as_tensor(np.asarray(index)).long().to(device),
                "q_w": dense(get(a + "self.query.weight").T),
                "q_b": dense(get(a + "self.query.bias")),
                "k_w": dense(get(a + "self.key.weight").T),
                "k_b": dense(get(a + "self.key.bias")),
                "v_w": dense(get(a + "self.value.weight").T),
                "v_b": dense(get(a + "self.value.bias")),
                "proj_w": dense(get(a + "output.dense.weight").T),
                "proj_b": dense(get(a + "output.dense.bias")),
                "ln2_w": dense(get(p + "layernorm_after.weight")),
                "ln2_b": dense(get(p + "layernorm_after.bias")),
                "up_w": dense(get(p + "intermediate.dense.weight").T),
                "up_b": dense(get(p + "intermediate.dense.bias")),
                "down_w": dense(get(p + "output.dense.weight").T),
                "down_b": dense(get(p + "output.dense.bias")),
            })
        stage = {"blocks": blocks}
        dkey = f"encoder.layers.{si}.downsample.reduction.weight"
        if pre + dkey in sd:
            stage["down_reduction"] = dense(get(dkey).T)  # [4C, 2C]
            stage["down_ln_w"] = dense(get(f"encoder.layers.{si}.downsample.norm.weight"))
            stage["down_ln_b"] = dense(get(f"encoder.layers.{si}.downsample.norm.bias"))
        stages.append(stage)
    return {
        "patch_w": dense(conv_w.reshape(conv_w.shape[0], -1).T),
        "patch_b": dense(get("embeddings.patch_embeddings.projection.bias")),
        "embed_ln_w": dense(get("embeddings.norm.weight")),
        "embed_ln_b": dense(get("embeddings.norm.bias")),
        "stages": stages,
        "final_ln_w": dense(get("layernorm.weight")),
        "final_ln_b": dense(get("layernorm.bias")),
    }


def _window_partition(x: torch.Tensor, M: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, M*M, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // M, M, W // M, M, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, M * M, C)


def _window_merge(w: torch.Tensor, M: int, H: int, W: int) -> torch.Tensor:
    """[B*nW, M*M, C] -> [B, H, W, C], the inverse of ``_window_partition``."""
    B = w.shape[0] // ((H // M) * (W // M))
    x = w.reshape(B, H // M, W // M, M, M, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def _shift_mask(H: int, W: int, M: int, shift: int) -> torch.Tensor:
    """HF's img_mask regions -> [nW, M*M, M*M] fp32 additive mask on the CPU
    (-100 across the region boundaries of the cyclic wrap)."""
    img = torch.zeros((1, H, W, 1))
    cnt = 0
    for h in (slice(0, -M), slice(-M, -shift), slice(-shift, None)):
        for w in (slice(0, -M), slice(-M, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    mw = _window_partition(img, M)[:, :, 0]  # [nW, M*M]
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _block(cfg: SwinConfig, bp, x, H, W, nH, shift):
    """One Swin block on [B, H*W, C]: pre-LN, windowed (shifted) attention."""
    B, L, C = x.shape
    M = min(cfg.window_size, H, W)
    if min(H, W) <= cfg.window_size:
        shift = 0
    dh = C // nH
    shortcut = x
    h = layernorm(x, bp["ln1_w"], bp["ln1_b"], cfg.layernorm_eps).reshape(B, H, W, C)
    # pad to window multiples (right and bottom), shift, partition
    Hp, Wp = -(-H // M) * M, -(-W // M) * M
    h = torch.nn.functional.pad(h, (0, 0, 0, Wp - W, 0, Hp - H))
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    wins = _window_partition(h, M)  # [B*nW, M*M, C]
    q = linear(wins, bp["q_w"], bp["q_b"]).reshape(-1, M * M, nH, dh)
    k = linear(wins, bp["k_w"], bp["k_b"]).reshape(-1, M * M, nH, dh)
    v = linear(wins, bp["v_w"], bp["v_b"]).reshape(-1, M * M, nH, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (dh ** 0.5)
    rel = bp["bias_table"][bp["bias_index"].reshape(-1)].reshape(M * M, M * M, nH)
    scores = scores + rel.permute(2, 0, 1)[None].float()  # [nH, M*M, M*M]
    if shift:
        nW = (Hp // M) * (Wp // M)
        mask = _shift_mask(Hp, Wp, M, shift).to(scores.device)  # [nW, M*M, M*M]
        scores = scores.reshape(B, nW, nH, M * M, M * M) + mask[None, :, None]
        scores = scores.reshape(-1, nH, M * M, M * M)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
    ctx = linear(ctx.reshape(-1, M * M, C), bp["proj_w"], bp["proj_b"])
    h = _window_merge(ctx, M, Hp, Wp)
    if shift:
        h = torch.roll(h, (shift, shift), dims=(1, 2))
    x = shortcut + h[:, :H, :W].reshape(B, L, C)
    h2 = layernorm(x, bp["ln2_w"], bp["ln2_b"], cfg.layernorm_eps)
    f = linear(h2, bp["up_w"], bp["up_b"], act=cfg.activation)
    return x + linear(f, bp["down_w"], bp["down_b"])


def encode(config: SwinConfig, params: Dict[str, Any], pixels):
    """Full Swin pass. pixels [B, C, H, W] (numpy or a tensor; their dtype is
    the activations') -> (hidden [B, L_last, C_last], pooled [B, C_last]), on
    the params' device."""
    dev = params["patch_w"].device
    pixels = _float_input(pixels, dev)
    B = pixels.shape[0]
    P = config.patch_size
    H, W = pixels.shape[2] // P, pixels.shape[3] // P
    x = linear(patchify(config, pixels), params["patch_w"], params["patch_b"])
    x = layernorm(x, params["embed_ln_w"], params["embed_ln_b"], config.layernorm_eps)
    for si, stage in enumerate(params["stages"]):
        nH = config.num_heads[si]
        for bi, bp in enumerate(stage["blocks"]):
            shift = 0 if bi % 2 == 0 else config.window_size // 2
            x = _block(config, bp, x, H, W, nH, shift)
        if "down_reduction" in stage:
            # patch merging: 2x2 neighbours (ee, oe, eo, oo) -> norm -> reduce
            C = x.shape[-1]
            g = x.reshape(B, H, W, C)
            m = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2],
                           g[:, 1::2, 1::2]], dim=-1).reshape(B, (H // 2) * (W // 2), 4 * C)
            m = layernorm(m, stage["down_ln_w"], stage["down_ln_b"], config.layernorm_eps)
            x = linear(m, stage["down_reduction"])  # bias-free
            H, W = H // 2, W // 2
    x = layernorm(x, params["final_ln_w"], params["final_ln_b"], config.layernorm_eps)
    return x, x.float().mean(dim=1).to(x.dtype)
