"""Reference-format ``.bin`` checkpoint directory -> engine parameters (port
of ckpt/loader.py).

Reads the per-rank layout the reference loads:
``model.layers.{i}.<name>[.rank].bin`` raw tensors plus ``config.ini``, and
the pre-quantized variants ``ckpt.quantize.quant_and_save`` writes beside
them (``.q.bin`` int8 + ``.s.bin`` scales; ``.q4.bin`` packed int4 +
``.s4[gN].bin`` scales). TP-split rank files are joined back to whole
tensors, and the reference's divided-by-TP shared biases are multiplied back.

The reference's own ``.q.bin`` files are CUTLASS-preprocessed:
``q_layout="cutlass"`` undoes that (``ckpt.cutlass_interop``); the default
``"plain"`` reads the row-major layout of ``quant_and_save``.

Files are read into host memory in one bulk call (the native C++ reader, or a
Python thread pool where the library is missing), assembled in numpy, and the
parameters built on ``device`` (the card when None). Every array equals the
JAX loader's for the same directory.
"""
from __future__ import annotations

import glob
import logging
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..core.device import resolve_device
from ..core.dtypes import torch_dtype
from ..models.params import QuantizedTensor
from .quantize import group_scale_dtype, quantize_array, quantize_params

logger = logging.getLogger(__name__)

# what the last load_bin_checkpoint call read: bytes, seconds and the reader
last_read = {}


def _ft_qkv_to_engine(w: np.ndarray, nH: int) -> np.ndarray:
    """The reference's on-disk fused-QKV order [..., 3, nH*dh] -> the engine's
    (HF's) [..., nH*3*dh] with (head, qkv, dh) flat order."""
    lead = w.shape[:-2]
    dh = w.shape[-1] // nH
    w = w.reshape(*lead, 3, nH, dh)
    order = tuple(range(len(lead))) + (len(lead) + 1, len(lead), len(lead) + 2)
    return np.transpose(w, order).reshape(*lead, 3 * nH * dh)


def _rank_files(ckpt: str, base: str) -> list:
    """The plain rank files ``<base>.<rank>.bin`` in rank order."""
    cands = [p for p in glob.glob(os.path.join(ckpt, base + ".*.bin"))
             if re.search(r"\.(\d+)\.bin$", p)]
    files = sorted(cands, key=lambda p: int(re.search(r"\.(\d+)\.bin$", p).group(1)))
    if not files:
        raise FileNotFoundError(f"no files matching {base}.*.bin in {ckpt}")
    return files


def detect_tp_size(ckpt: str) -> int:
    return len(_rank_files(ckpt, "model.layers.0.attention.query_key_value.bias"))


def _bulk_read_dir(ckpt_path: str, num_threads: int):
    """Every ``.bin`` of the directory in host memory: {path: uint8 array}.
    One native call (C++ thread-pool reads) where the library is built, a
    Python thread pool otherwise; ``last_read`` records which ran."""
    from .. import native

    paths = sorted(glob.glob(os.path.join(ckpt_path, "*.bin")))
    bufs = [np.empty(os.path.getsize(p), np.uint8) for p in paths]
    t0 = time.perf_counter()
    if native.available():
        reader = "native (native/lib/libftcf_native.so)"
        native.read_files(paths, bufs, threads=num_threads)
    else:
        reader = "python thread pool"

        def rd(i):
            with open(paths[i], "rb") as f:
                f.readinto(memoryview(bufs[i]))

        with ThreadPoolExecutor(num_threads) as pool:
            list(pool.map(rd, range(len(paths))))
    secs = time.perf_counter() - t0
    nbytes = sum(b.nbytes for b in bufs)
    last_read.clear()
    last_read.update(reader=reader, bytes=nbytes, seconds=secs, files=len(paths))
    logger.info("read %d files, %.3f GB in %.2f s with the %s reader", len(paths), nbytes / 1e9,
                secs, reader)
    return dict(zip(paths, bufs))


def load_bin_checkpoint(
    ckpt_path: str,
    config: Optional[GptNeoXConfig] = None,
    dtype="fp32",
    int8_mode: int = 0,
    weight_bits: int = 8,
    group_size: int = 0,
    num_threads: int = 16,
    q_layout: str = "plain",
    quantize_embeddings: Optional[bool] = None,
    device=None,
) -> tuple:
    """Load a reference-format checkpoint directory: (config, params).

    ``int8_mode >= 1`` reads the ``.q.bin`` (or, ``weight_bits=4``, the
    ``.q4.bin`` + ``.s4[gN].bin``) payloads, or quantizes the float kernels
    on load where the directory has none. ``quantize_embeddings`` also
    quantizes the embedding table and the LM head; ``int8_mode=2`` is its
    alias. Tensors are built on ``device`` (the card when None)."""
    device = resolve_device(device)
    if quantize_embeddings is None:
        quantize_embeddings = int8_mode >= 2
    if config is None:
        config = GptNeoXConfig.from_ini(ckpt_path)
    tdt = torch_dtype(dtype)
    wdt = np.float16 if config.weight_data_type == "fp16" else np.float32
    L, H, nH, dh, I, V = (config.layer_num, config.hidden_size, config.head_num,
                          config.size_per_head, config.inter_size, config.vocab_size)
    tp = detect_tp_size(ckpt_path)
    blobs = _bulk_read_dir(ckpt_path, num_threads)

    def view(path, dt):
        return blobs[path].view(dt)

    def read(name, shape=None, dt=wdt):
        arr = view(os.path.join(ckpt_path, name), dt)
        return arr.reshape(shape) if shape is not None else arr

    def read_split(base, rank_shape, axis, dt=wdt):
        parts = [view(p, dt).reshape(rank_shape) for p in _rank_files(ckpt_path, base)]
        return np.concatenate(parts, axis=axis)

    def to_dev(a, dt=tdt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    def stack(fn):
        return to_dev(np.stack([fn(i) for i in range(L)]))

    lh = nH * dh // tp  # local hidden per rank
    li = I // tp
    layer = "model.layers.{}."

    layers = {
        "ln1_w": stack(lambda i: read(f"model.layers.{i}.input_layernorm.weight.bin", (H,))),
        "ln1_b": stack(lambda i: read(f"model.layers.{i}.input_layernorm.bias.bin", (H,))),
        "qkv_b": stack(lambda i: _ft_qkv_to_engine(
            read_split(f"model.layers.{i}.attention.query_key_value.bias", (3, lh), axis=-1),
            nH)),
        "ln2_w": stack(lambda i: read(f"model.layers.{i}.post_attention_layernorm.weight.bin",
                                      (H,))),
        "ln2_b": stack(lambda i: read(f"model.layers.{i}.post_attention_layernorm.bias.bin",
                                      (H,))),
        "up_b": stack(lambda i: read_split(f"model.layers.{i}.mlp.dense_h_to_4h.bias", (li,),
                                           axis=-1)),
    }
    if config.use_gptj_residual:
        # the reference stores (attention bias + down bias) / tp: restore the sum
        layers["down_b"] = stack(
            lambda i: read(f"model.layers.{i}.mlp.attention.bias.sum.bin", (H,)) * tp)
    else:
        layers["down_b"] = stack(
            lambda i: read(f"model.layers.{i}.mlp.dense_4h_to_h.bias.bin", (H,)) * tp)
        layers["proj_b"] = stack(
            lambda i: read(f"model.layers.{i}.attention.dense.bias.bin", (H,)) * tp)

    # Quantize on load when the directory holds no payloads of the asked width
    # (the float kernels, cast to dtype, then one whole-tensor quantization;
    # also the way TP > 1 int4 directories load).
    quantize_on_load = int8_mode >= 1 and not glob.glob(
        os.path.join(ckpt_path, "*.q4.bin" if weight_bits == 4 else "*.q.bin"))
    kernels = {
        "qkv_w": ("attention.query_key_value.weight", H, (H, 3 * nH * dh)),
        "proj_w": ("attention.dense.weight", nH * dh, (nH * dh, H)),
        "up_w": ("mlp.dense_h_to_4h.weight", H, (H, I)),
        "down_w": ("mlp.dense_4h_to_h.weight", I, (I, H)),
    }

    def qkv_order(key):
        return (lambda a: _ft_qkv_to_engine(a, nH)) if key == "qkv_w" else None

    if int8_mode >= 1 and weight_bits == 4 and not quantize_on_load:
        # .q4.bin nibble-packed + .s4[gN].bin scales: tp 1 only (a TP > 1
        # directory quantizes its merged float kernels on load instead)
        if tp != 1:
            raise ValueError("int4 .bin loading takes tp=1 directories; merge via the fp files")
        ssuffix = f"s4g{group_size}" if group_size else "s4"
        s_dtype = group_scale_dtype(4, group_size)

        def load_q4(name, kdim, shape, reorder):
            N = shape[1]
            s_shape = (kdim // group_size, N) if group_size else (N,)
            qs, ss = [], []
            for i in range(L):
                base = os.path.join(ckpt_path, layer.format(i) + name)
                q = view(base + ".0.q4.bin", np.int8).reshape(kdim // 2, -1)
                sc = view(base + f".0.{ssuffix}.bin", wdt)
                if reorder is not None:
                    # the column permutation commutes with the K-axis packing
                    q = reorder(q.reshape(kdim // 2, 3, -1))
                    sc = reorder(sc.reshape(s_shape[:-1] + (3, -1)))
                qs.append(q.reshape(kdim // 2, N))
                ss.append(sc.reshape(s_shape))
            # bf16 group scales from the disk's fp16 / fp32 (exact where the
            # stored value is a normal fp16: quantize_array rounded it to bf16)
            return QuantizedTensor(q=to_dev(np.stack(qs), torch.int8),
                                   scale=to_dev(np.stack(ss), s_dtype), k_axis=-2, bits=4,
                                   group_size=group_size)

        for key, (name, kdim, shape) in kernels.items():
            layers[key] = load_q4(name, kdim, shape, qkv_order(key))
    elif int8_mode >= 1 and not quantize_on_load:

        def q_rank_files(base, suffix):
            files = sorted(
                glob.glob(os.path.join(ckpt_path, f"{base}.*.{suffix}.bin")),
                key=lambda p: int(re.search(rf"\.(\d+)\.{suffix}\.bin$", p).group(1)),
            )
            if not files:
                raise FileNotFoundError(f"no {base}.*.{suffix}.bin in {ckpt_path}")
            return files

        def rank_q(p, rank_q_shape):
            flat = view(p, np.int8)
            if q_layout == "cutlass":
                # the reference's payloads are CUTLASS-preprocessed per rank
                # matrix [rows, prod(cols)]: undo to row-major int8
                from .cutlass_interop import unpreprocess_weights

                rows = rank_q_shape[0]
                flat = unpreprocess_weights(flat, rows, flat.size // rows)
            return flat.reshape(rank_q_shape)

        def load_quant(name, rank_q_shape, rank_s_shape, axis, s_axis, final_shape,
                       final_s_shape, reorder):
            """.q.bin / .s.bin per layer. TP 1 and column-split kernels take the
            payloads as they are; row-split kernels of TP > 1 have per-rank
            scales, so their ranks are dequantized and requantized whole."""
            qs, ss = [], []
            for i in range(L):
                base = layer.format(i) + name
                qparts = [rank_q(p, rank_q_shape) for p in q_rank_files(base, "q")]
                sparts = [view(p, wdt).reshape(rank_s_shape) for p in q_rank_files(base, "s")]
                if tp == 1 or axis != 0:
                    q = np.concatenate(qparts, axis=axis)
                    s = np.concatenate(sparts, axis=s_axis)
                    if reorder is not None:
                        q, s = reorder(q), reorder(s)
                    q, s = q.reshape(final_shape), s.reshape(final_s_shape)
                else:
                    deq = np.concatenate(
                        [qp.astype(np.float32) * sp[None, :].astype(np.float32)
                         for qp, sp in zip(qparts, sparts)], axis=0)
                    qt = quantize_array(deq.reshape(final_shape), -2)
                    q, s = qt.q.numpy(), qt.scale.numpy()
                qs.append(q)
                ss.append(s)
            return QuantizedTensor(q=to_dev(np.stack(qs), torch.int8),
                                   scale=to_dev(np.stack(ss), torch.float32), k_axis=-2)

        layers["qkv_w"] = load_quant(
            kernels["qkv_w"][0], (H, 3, lh), (3, lh), -1, -1, (H, 3 * nH * dh), (3 * nH * dh,),
            qkv_order("qkv_w"))
        layers["proj_w"] = load_quant(kernels["proj_w"][0], (lh, H), (H,), 0, None,
                                      (nH * dh, H), (H,), None)
        layers["up_w"] = load_quant(kernels["up_w"][0], (H, li), (li,), -1, -1, (H, I), (I,),
                                    None)
        layers["down_w"] = load_quant(kernels["down_w"][0], (li, H), (H,), 0, None, (I, H),
                                      (H,), None)
    else:
        layers["qkv_w"] = stack(lambda i: _ft_qkv_to_engine(read_split(
            f"model.layers.{i}.attention.query_key_value.weight", (H, 3, lh), axis=-1), nH))
        layers["proj_w"] = stack(lambda i: read_split(
            f"model.layers.{i}.attention.dense.weight", (lh, H), axis=0))
        layers["up_w"] = stack(lambda i: read_split(
            f"model.layers.{i}.mlp.dense_h_to_4h.weight", (H, li), axis=-1))
        layers["down_w"] = stack(lambda i: read_split(
            f"model.layers.{i}.mlp.dense_4h_to_h.weight", (li, H), axis=0))

    params = {
        "embed": to_dev(read("model.wte.bin", (V, H))),
        "layers": layers,
        "final_ln_w": to_dev(read("model.final_layernorm.weight.bin", (H,))),
        "final_ln_b": to_dev(read("model.final_layernorm.bias.bin", (H,))),
        "lm_head": to_dev(read("model.lm_head.weight.bin", (V, H))),
    }
    del blobs
    if int8_mode >= 1 and (quantize_on_load or quantize_embeddings):
        # float kernels (quantize on load) and, with quantize_embeddings, the
        # embedding table and LM head (the int4 transposed head at
        # weight_bits=4) become QuantizedTensors; loaded payloads are kept
        params = quantize_params(params, include_embeddings=quantize_embeddings,
                                 weight_bits=weight_bits, group_size=group_size)
    return config, params
