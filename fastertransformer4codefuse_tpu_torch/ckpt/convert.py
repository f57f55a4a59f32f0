"""HuggingFace GPT-NeoX -> engine parameters, and the reference's ``.bin``
writer (port of ckpt/convert.py).

- ``params_from_hf_state_dict``: an in-memory HF state dict -> the engine's
  parameter dict (no intermediate files).
- ``convert_hf_to_bin``: write the reference's on-disk ``.bin`` +
  ``config.ini`` layout, which ``ckpt.loader.load_bin_checkpoint`` reads
  back, byte for byte what the JAX package writes.

HF stores the fused QKV output dim as [heads, 3, head_dim]. The engine keeps
that order (a transpose only); the reference's on-disk order [3, heads,
head_dim] is written by ``convert_hf_to_bin`` and undone by the loader.
``_np`` and ``stack_layers`` serve the encoder converters too.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..core.device import resolve_device
from ..core.dtypes import torch_dtype
from ..models.params import Params


def _np(x) -> np.ndarray:
    """torch.Tensor | np.ndarray -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def stack_layers(fn, num_layers: int, dtype, device) -> torch.Tensor:
    """Stack the per-layer numpy tensors ``fn(i)`` into one [L, ...] tensor of
    ``dtype`` on ``device``."""
    stacked = torch.from_numpy(np.ascontiguousarray(np.stack([fn(i) for i in range(num_layers)])))
    return stacked.to(device=torch.device(device), dtype=torch_dtype(dtype))


def fused_qkv_concat(get, i: int, prefix: str = "model.layers.{}.self_attn.") -> np.ndarray:
    """HF separate q/k/v Linears [out, H] -> the engine's fused
    [H, q_all | k_all | v_all] (``qkv_layout="concat"``)."""
    p = prefix.format(i)
    return np.concatenate(
        [get(p + "q_proj.weight").T, get(p + "k_proj.weight").T, get(p + "v_proj.weight").T],
        axis=1,
    )


def fused_qkv_bias_concat(get, i: int, prefix: str = "model.layers.{}.self_attn.") -> np.ndarray:
    """The bias counterpart of ``fused_qkv_concat``."""
    p = prefix.format(i)
    return np.concatenate([get(p + "q_proj.bias"), get(p + "k_proj.bias"), get(p + "v_proj.bias")])


def config_from_hf(hf_config, model_name: str = "gptneox") -> GptNeoXConfig:
    """A GptNeoXConfig from a transformers GPTNeoXConfig (the field mapping of
    the reference's huggingface_convert.py). HF's ``hidden_act="gelu"`` is
    the exact-erf gelu."""
    g = lambda k: getattr(hf_config, k)  # noqa: E731
    n_heads = g("num_attention_heads")
    head_size = g("hidden_size") // n_heads
    return GptNeoXConfig(
        head_num=n_heads,
        size_per_head=head_size,
        inter_size=g("intermediate_size"),
        layer_num=g("num_hidden_layers"),
        rotary_embedding_dim=int(head_size * g("rotary_pct")),
        vocab_size=g("vocab_size"),
        start_id=g("bos_token_id") or 0,
        end_id=g("eos_token_id") or 0,
        use_gptj_residual=bool(g("use_parallel_residual")),
        layernorm_eps=float(g("layer_norm_eps")),
        rotary_base=float(getattr(hf_config, "rotary_emb_base", 10000.0)),
        activation="gelu" if g("hidden_act") == "gelu" else g("hidden_act"),
        model_name=model_name,
    )


def _reorder_qkv_weight(w_hf: np.ndarray, n_heads: int) -> np.ndarray:
    """HF qkv weight [3H, H] (out layout [nH, 3, dh]) -> [H, 3, nH*dh]."""
    out_dim, hidden = w_hf.shape
    dh = out_dim // (3 * n_heads)
    w = w_hf.T.reshape(hidden, n_heads, 3, dh)
    return np.transpose(w, (0, 2, 1, 3)).reshape(hidden, 3, n_heads * dh)


def _reorder_qkv_bias(b_hf: np.ndarray, n_heads: int) -> np.ndarray:
    """HF qkv bias [3H] (layout [nH, 3, dh]) -> [3, nH*dh]."""
    dh = b_hf.shape[0] // (3 * n_heads)
    b = b_hf.reshape(n_heads, 3, dh)
    return np.transpose(b, (1, 0, 2)).reshape(3, n_heads * dh)


def params_from_hf_state_dict(
    config: GptNeoXConfig,
    state_dict: Mapping[str, Any],
    dtype="fp32",
    device=None,
) -> Params:
    """An HF GPTNeoXForCausalLM state dict -> the engine's parameter dict, in
    ``dtype`` on ``device`` (the card when None)."""
    device = resolve_device(device)
    L = config.layer_num

    def get(name):
        return _np(state_dict[name])

    def stack(fmt, transform=lambda x: x):
        return stack_layers(lambda i: transform(get(fmt.format(i))), L, dtype, device)

    def tensor(a):
        return torch.from_numpy(a).to(device=device, dtype=torch_dtype(dtype))

    pre = "gpt_neox.layers.{}."
    layers = {
        "ln1_w": stack(pre + "input_layernorm.weight"),
        "ln1_b": stack(pre + "input_layernorm.bias"),
        # the engine keeps HF's (head, qkv, dh) fused order: a transpose only
        "qkv_w": stack(pre + "attention.query_key_value.weight", lambda w: w.T),
        "qkv_b": stack(pre + "attention.query_key_value.bias"),
        "proj_w": stack(pre + "attention.dense.weight", lambda w: w.T),
        "ln2_w": stack(pre + "post_attention_layernorm.weight"),
        "ln2_b": stack(pre + "post_attention_layernorm.bias"),
        "up_w": stack(pre + "mlp.dense_h_to_4h.weight", lambda w: w.T),
        "up_b": stack(pre + "mlp.dense_h_to_4h.bias"),
        "down_w": stack(pre + "mlp.dense_4h_to_h.weight", lambda w: w.T),
    }
    if config.use_gptj_residual:
        # pre-summed biases, as the reference converter writes them
        layers["down_b"] = stack_layers(
            lambda i: get(pre.format(i) + "attention.dense.bias")
            + get(pre.format(i) + "mlp.dense_4h_to_h.bias"), L, dtype, device)
    else:
        layers["down_b"] = stack(pre + "mlp.dense_4h_to_h.bias")
        layers["proj_b"] = stack(pre + "attention.dense.bias")
    return {
        "embed": tensor(get("gpt_neox.embed_in.weight")),
        "layers": layers,
        "final_ln_w": tensor(get("gpt_neox.final_layer_norm.weight")),
        "final_ln_b": tensor(get("gpt_neox.final_layer_norm.bias")),
        "lm_head": tensor(get("embed_out.weight")),  # [V, H]
    }


def convert_hf_to_bin(
    model,
    saved_dir: str,
    infer_tp: int = 1,
    weight_data_type: str = "fp32",
    model_name: str = "gptneox",
) -> GptNeoXConfig:
    """Write a reference-format checkpoint directory from ``model``: anything
    with an HF GPT-NeoX ``.config`` and ``.state_dict()`` (a
    GPTNeoXForCausalLM, or a stand-in holding its tensors under the same
    names). File names and TP splits are the reference converter's: qkv
    reordered to [3, heads, dh] and split on its columns, up split on its
    columns, proj and down split on their input rows, the row-split kernels'
    biases divided by TP, and under the parallel residual the summed bias
    ``mlp.attention.bias.sum``."""
    os.makedirs(saved_dir, exist_ok=True)
    np_dtype = {"fp32": np.float32, "fp16": np.float16}[weight_data_type]
    config = config_from_hf(model.config, model_name)
    config = dataclasses.replace(config, weight_data_type=weight_data_type)
    config.to_ini(saved_dir)

    nH = config.head_num
    factor = infer_tp
    sd = {k: _np(v) for k, v in model.state_dict().items()}

    def save(name, arr):
        # a contiguous copy first: casting a transposed view element by
        # element is ~2x slower at 13B widths
        np.ascontiguousarray(arr).astype(np_dtype).tofile(os.path.join(saved_dir, name))

    save("model.wte.bin", sd["gpt_neox.embed_in.weight"])
    save("model.final_layernorm.weight.bin", sd["gpt_neox.final_layer_norm.weight"])
    save("model.final_layernorm.bias.bin", sd["gpt_neox.final_layer_norm.bias"])
    save("model.lm_head.weight.bin", sd["embed_out.weight"])

    for i in range(config.layer_num):
        p = f"gpt_neox.layers.{i}."
        o = f"model.layers.{i}."
        save(o + "input_layernorm.weight.bin", sd[p + "input_layernorm.weight"])
        save(o + "input_layernorm.bias.bin", sd[p + "input_layernorm.bias"])
        save(o + "post_attention_layernorm.weight.bin", sd[p + "post_attention_layernorm.weight"])
        save(o + "post_attention_layernorm.bias.bin", sd[p + "post_attention_layernorm.bias"])

        qkv_w = _reorder_qkv_weight(sd[p + "attention.query_key_value.weight"], nH)
        qkv_b = _reorder_qkv_bias(sd[p + "attention.query_key_value.bias"], nH)
        for j, chunk in enumerate(np.split(qkv_w, factor, axis=-1)):
            save(o + f"attention.query_key_value.weight.{j}.bin", chunk)
        for j, chunk in enumerate(np.split(qkv_b, factor, axis=-1)):
            save(o + f"attention.query_key_value.bias.{j}.bin", chunk)

        proj_w = sd[p + "attention.dense.weight"].T  # [nH*dh, H]
        for j, chunk in enumerate(np.split(proj_w, factor, axis=0)):
            save(o + f"attention.dense.weight.{j}.bin", chunk)
        attn_bias = sd[p + "attention.dense.bias"]
        save(o + "attention.dense.bias.bin", attn_bias / factor if factor > 1 else attn_bias)

        up_w = sd[p + "mlp.dense_h_to_4h.weight"].T  # [H, I]
        for j, chunk in enumerate(np.split(up_w, factor, axis=-1)):
            save(o + f"mlp.dense_h_to_4h.weight.{j}.bin", chunk)
        for j, chunk in enumerate(np.split(sd[p + "mlp.dense_h_to_4h.bias"], factor, axis=-1)):
            save(o + f"mlp.dense_h_to_4h.bias.{j}.bin", chunk)

        down_w = sd[p + "mlp.dense_4h_to_h.weight"].T  # [I, H]
        for j, chunk in enumerate(np.split(down_w, factor, axis=0)):
            save(o + f"mlp.dense_4h_to_h.weight.{j}.bin", chunk)
        down_bias = sd[p + "mlp.dense_4h_to_h.bias"]
        save(o + "mlp.dense_4h_to_h.bias.bin", down_bias / factor if factor > 1 else down_bias)

        if config.use_gptj_residual:
            # the reference sums the already divided biases
            save(o + "mlp.attention.bias.sum.bin", (attn_bias + down_bias) / factor)
    return config
