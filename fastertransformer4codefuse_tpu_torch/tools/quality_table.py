"""Quantization-quality table over the trained proxy model (port of the JAX
repo's tools/quality_table.py).

What each served precision costs in model quality: held-out byte-level NLL
and perplexity, and greedy-token agreement with the float engine, for int8,
SmoothQuant W8A8, int4 per-channel, int4 group-128 and int4 group-128 + AWQ,
with the int8, int8k_int4v and int4 KV caches (their decode-path NLL beside
the float model's through a bf16 cache). The JAX tool's rows in its order and
its markdown table, built with the port's ``ckpt.quantize``,
``ckpt.calibrate`` (AWQ) and ``ckpt.smoothquant``; W8A8 runs through the
engine's ``act_int8``, not a process-wide switch.

``--dtype`` is the activations' dtype: ``bf16`` is the card's (and the
default); ``fp32`` runs on the CPU only (``--device cpu``), since on the card
K1 and K4 take bf16 activations ("fp32 activations on the card", ROADMAP.md
queue 1). The float row is named after the dtype.

    python -m fastertransformer4codefuse_tpu_torch.tools.quality_table \\
        --ckpt /tmp/ftcf_proxy.npz [--out PERF.md] [--dtype fp32 --device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ckpt.calibrate import apply_awq_scaling, collect_activation_stats
from ..ckpt.quantize import quantize_params
from ..ckpt.smoothquant import apply_smoothquant_scaling
from ..core.config import RuntimeConfig
from ..core.dtypes import torch_dtype
from ..engine.engine import GptNeoXEngine
from ..models.params import params_to
from .quality_eval import eval_decode_nll, eval_nll, greedy_agreement
from .train_proxy import config_of_ckpt, load_params

FP32_ON_CARD = ("--dtype fp32 runs on the CPU only (--device cpu): on the card K1 and K4 take "
                "bf16 activations (ROADMAP.md queue 1, 'fp32 activations on the card')")

W8A8 = "int8 W8A8 (SmoothQuant)"
AWQ = "int4 g128 + AWQ"
# the table's rows in the JAX tool's order: (name, weights, KV cache); the
# float row (weights None) is named after the activations' dtype
ROWS = ((None, None, None), ("int8", "int8", None), ("int8 + int8 KV", "int8", "int8"),
        (W8A8, "w8a8", None), ("int4 per-channel", "int4", None), ("int4 g128", "g128", None),
        (AWQ, "awq", None), (f"{AWQ} + int8 KV", "awq", "int8"),
        (f"{AWQ} + int8k4v KV", "awq", "int8k_int4v"), (f"{AWQ} + int4 KV", "awq", "int4"))


def variant_names(dtype: str):
    """The table's rows in the JAX tool's order."""
    return [name or dtype for name, _, _ in ROWS]


def build_variants(cfg, params, calib, dtype: str, names):
    """{name: (params served in ``dtype``, int8_mode, kv dtype or None)} for
    the rows ``names``: each quantized from the fp32 ``params``, then its
    float leaves cast to ``dtype``; the activation statistics (AWQ and
    SmoothQuant) are collected once, from the served float model."""
    dt = torch_dtype(dtype)
    dev = params["final_ln_w"].device

    def served(p):
        return params_to(p, dev, dt)

    float_p = served(params)
    cache = {}

    def stats():
        if "stats" not in cache:
            print("collecting activation stats...", flush=True)
            cache["stats"] = collect_activation_stats(cfg, float_p, calib)
        return cache["stats"]

    def weights(kind):
        if kind not in cache:
            if kind == "int8":
                q = quantize_params(params)
            elif kind == "w8a8":
                q = quantize_params(apply_smoothquant_scaling(cfg, params, stats()))
            elif kind == "int4":
                q = quantize_params(params, weight_bits=4)
            elif kind == "g128":
                q = quantize_params(params, weight_bits=4, group_size=128)
            else:  # awq
                q = quantize_params(apply_awq_scaling(cfg, params, stats(), weight_bits=4,
                                                      group_size=128),
                                    weight_bits=4, group_size=128)
            cache[kind] = served(q)
        return cache[kind]

    spec = {name or dtype: (kind, kv) for name, kind, kv in ROWS}
    return {name: (float_p, 0, None) if spec[name][0] is None
            else (weights(spec[name][0]), 1, spec[name][1]) for name in names}


def kv_torch_dtype(kv: str):
    """A table row's KV name -> what the cache constructors take."""
    return {"int8": torch.int8}.get(kv, kv)


def quality_rows(cfg, params, held, dtype: str = "bf16", names=None, prompts: int = 8,
                 gen_len: int = 48, decode_bytes: int = 4096):
    """The table's rows (name, nll, ppl, dNLL, agreement, decode dNLL or
    None) over the held-out stream ``held``: NLL over all of it, the
    decode-path NLL over its first ``decode_bytes``, greedy agreement over
    ``prompts`` prompts of 64 bytes. ``params``: the fp32 proxy on the
    device the run takes."""
    names = list(names or variant_names(dtype))
    calib = [[held[i * 256: (i + 1) * 256].tolist() for i in range(4)]]
    variants = build_variants(cfg, params, calib, dtype, names)
    prompt_ids = [held[i * 64: i * 64 + 64].tolist() for i in range(prompts)]

    def engine(p, mode, kv, a8=False):
        return GptNeoXEngine(cfg, p, RuntimeConfig(dtype=dtype, int8_mode=mode, kv_cache_dtype=kv,
                                                   seq_bucket=64, act_int8=a8))

    float_p = variants[names[0]][0]
    eng_fp = engine(float_p, 0, None)
    dec_ids = held[: min(len(held), decode_bytes)]
    dec_fp = None
    if any(v[2] is not None for v in variants.values()):
        # the decode-path baseline: float weights through a bf16 cache
        dec_fp = eval_decode_nll(cfg, float_p, dec_ids, torch.bfloat16)
        print(f"decode-path {dtype}/bf16KV NLL baseline: {dec_fp:.4f}", flush=True)
    rows = []
    nll_fp = None
    for name, (p, mode, kv) in variants.items():
        a8 = name == W8A8
        nll = eval_nll(cfg, p, held, a8=a8)
        if nll_fp is None:
            nll_fp, agree = nll, 1.0
        else:
            agree = greedy_agreement(eng_fp, engine(p, mode, kv, a8), prompt_ids,
                                     output_len=gen_len)
        dec_d = None
        if kv is not None:
            dec_d = eval_decode_nll(cfg, p, dec_ids, kv_torch_dtype(kv)) - dec_fp
        rows.append((name, nll, float(np.exp(nll)), nll - nll_fp, agree, dec_d))
        dec_s = f"  decode-dNLL {dec_d:+.4f}" if dec_d is not None else ""
        print(f"{name:32s} nll {nll:.4f}  ppl {np.exp(nll):7.3f}  dNLL {nll - nll_fp:+.4f}  "
              f"greedy-agree {agree * 100:5.1f}%{dec_s}", flush=True)
    return rows


def table_lines(rows, base: str = "fp32"):
    """The JAX tool's markdown table of ``rows``; ``base`` names the float
    row the deltas are taken against."""
    lines = [
        f"| config | NLL | ppl | dNLL vs {base} | greedy agreement | decode dNLL (KV) |",
        "|---|---|---|---|---|---|",
    ]
    for name, nll, ppl, d, agree, dec_d in rows:
        dc = f"{dec_d:+.4f}" if dec_d is not None else "—"
        lines.append(f"| {name} | {nll:.4f} | {ppl:.3f} | {d:+.4f} | {agree * 100:.1f}% | {dc} |")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="/tmp/ftcf_proxy.npz")
    ap.add_argument("--out", default="")
    ap.add_argument("--max-heldout", type=int, default=16384)
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=48)
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "fp32"))
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if args.dtype == "fp32":
            raise SystemExit(FP32_ON_CARD)
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    cfg = config_of_ckpt(args.ckpt)
    params = load_params(args.ckpt, device=dev)
    held = np.load(args.ckpt + ".heldout.npy")[: args.max_heldout]
    print(f"held-out: {len(held)} bytes")
    t0 = time.time()
    rows = quality_rows(cfg, params, held, args.dtype, prompts=args.prompts,
                        gen_len=args.gen_len)
    print(f"{len(rows)} rows in {time.time() - t0:.1f} s")
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(table_lines(rows, args.dtype)) + "\n")
        print(f"appended table to {args.out}")


if __name__ == "__main__":
    main()
